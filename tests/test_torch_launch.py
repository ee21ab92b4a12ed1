"""The port's entry points on the CPU: ``repro_torch.launch.quickstart``
against ``examples/quickstart.py``, and ``repro_torch.launch.train_lm`` for
smollm and xLSTM.

The quickstart prints the same lines as the JAX package's: every line,
since none carries a wall-clock value (the engine's default virtual clock
makes every time it prints a simulated one, and both runs repeat to the
character).
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import quickstart, train_lm
from repro_torch.runtime import checkpoint as ckpt

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def printed(fn) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


def test_quickstart_prints_the_reference_lines():
    spec = importlib.util.spec_from_file_location("jax_quickstart", EXAMPLES / "quickstart.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    want = printed(reference.main)
    got = printed(quickstart.main)
    assert len(got) == len(want) == 10
    assert got == want
    assert got == printed(quickstart.main)  # and again, to the character


@pytest.mark.parametrize("arch", ["smollm_360m", "xlstm_350m"])
def test_train_lm_runs_and_resumes_on_cpu(tmp_path, arch):
    argv = ["--device", "cpu", "--arch", arch, "--steps", "4", "--batch", "2", "--seq", "16",
            "--layers", "1", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    lines = printed(lambda: train_lm.main(argv))
    out = train_lm.main(argv[:5] + ["2"] + argv[6:])  # resumes from step 3's checkpoint
    assert lines[0].startswith(f"arch={arch.replace('_', '-')} layers=")
    assert "resumed" not in " ".join(lines)
    _, opt = out["final_state"]
    assert int(opt["count"]) == 4 + 2
    assert [i for i, _ in out["losses"]] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in out["losses"])
    assert ckpt.latest_step(out["checkpoint"]) == 1
    assert out["fault_stats"]["task_attempts"] > 0
