"""The port's entry points on the CPU: ``repro_torch.launch.quickstart``
against ``examples/quickstart.py``, ``repro_torch.launch.train_lm`` for
smollm and xLSTM, and ``repro_torch.launch.serve_lm`` (reduced mixtral-8x7b,
jamba-1.5-large and whisper-large-v3) against ``examples/serve_lm.py`` and
a greedy loop over the JAX package's ``decode_step`` (whisper's with its
cross cache filled by hand: the reference's decode never fills it).

The quickstart prints the same lines as the JAX package's: every line,
since none carries a wall-clock value (the engine's default virtual clock
makes every time it prints a simulated one, and both runs repeat to the
character).
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import FaultConfig
from repro_torch.launch import quickstart, serve, serve_lm, train_lm
from repro_torch.models import model as M
from repro_torch.runtime import checkpoint as ckpt

from _jax_whisper import jax_cache_filled_by_hand
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def printed(fn) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


def example(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_prints_the_reference_lines():
    reference = example("quickstart")
    want = printed(reference.main)
    got = printed(quickstart.main)
    assert len(got) == len(want) == 10
    assert got == want
    assert got == printed(quickstart.main)  # and again, to the character


@pytest.mark.parametrize("arch", ["smollm_360m", "xlstm_350m", "whisper_large_v3"])
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


SERVED = re.compile(r"served in \d+\.\ds  mean decode throughput \d+\.\d tok/s  "
                    r"p99 latency \d+\.\d\ds")


@pytest.mark.parametrize("flags,name", [
    pytest.param([], "mixtral-8x7b", id="default"),
    # reduced jamba: mamba, one attention layer per eight, MoE on alternate layers
    pytest.param(["--arch", "jamba_1_5_large_398b"], "jamba-1.5-large-398b", id="jamba"),
    # reduced whisper: the encoder, cross-attention over the request's frames
    pytest.param(["--arch", "whisper_large_v3"], "whisper-large-v3", id="whisper"),
])
def test_serve_lm_prints_the_example_lines(monkeypatch, flags, name):
    """The example's lines for the same flags. The example itself prints its
    first two and then raises ``KeyError``: it reads ``request-0`` from the
    job's results, which hold only the job's root (the summary); the port
    takes request 0's tokens from the summary."""
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(KeyError, match="request-0"):
        example("serve_lm").main()
    want = out.getvalue().splitlines()
    got = printed(lambda: serve_lm.main([*flags, "--device", "cpu"]))
    assert len(want) == 2 and len(got) == 3
    assert got[0] == want[0] == f"arch={name} requests=4 batch=2 gen=16"
    assert SERVED.fullmatch(got[1]) and SERVED.fullmatch(want[1]), (got[1], want[1])
    head, tokens = got[2].split(": ")
    assert head == "sample continuation (req 0, seq 0)"
    assert len([int(t) for t in tokens.strip("[]").split(", ")]) == 12


def test_serve_lm_repeats_its_tokens_when_tasks_fail():
    """Two runs under the example's fault injection give the same tokens, and
    so does a run whose request tasks fail and are retried: a retried
    request sees the same prompt."""
    cfg = reduced(get_config("mixtral_8x7b"))
    params = M.init_model(cfg, seed=0, device="cpu")
    kw = dict(requests=4, batch=2, prompt_len=5, gen_len=6, seed=0, device="cpu")
    runs = [serve_lm.run(cfg, params, **kw)[0] for _ in range(2)]
    assert all(r.fault_stats["task_attempts"] >= 5 for r in runs)
    faulty = serve.serve(cfg, params, **kw, faults=FaultConfig(task_failure_prob=0.3,
                                                                max_retries=6, seed=1))
    assert faulty.fault_stats["injected_failures"] > 0, faulty.fault_stats
    for rep in (runs[1], faulty):
        for got, want in zip(rep.results["summary"]["tokens"],
                             runs[0].results["summary"]["tokens"], strict=True):
            np.testing.assert_array_equal(got, want)


def test_serve_lm_greedy_tokens_match_jax_decode_loop():
    """At the example's shape, on params made by the JAX package: each
    request's greedy tokens equal a greedy loop over JAX's ``decode_step``
    on the same prompt (``launch.serve.request_prompts``)."""
    jcfg, tcfg = jax_reduced(jax_get_config("mixtral_8x7b")), reduced(get_config("mixtral_8x7b"))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    requests, batch, prompt_len, gen_len, seed = 4, 2, 16, 16, 5
    rep, _ = serve_lm.run(tcfg, tparams, requests=requests, batch=batch,
                          prompt_len=prompt_len, gen_len=gen_len, seed=seed, device="cpu")
    step = jax.jit(JM.decode_step, static_argnums=1)
    for rid in range(requests):
        prompt = serve.request_prompts(seed, rid, batch, prompt_len, jcfg.vocab)
        cache = JM.init_cache(jcfg, batch, prompt_len + gen_len)
        tok, generated = jnp.asarray(prompt[:, 0]), []
        for pos in range(prompt_len + gen_len - 1):
            logits, cache = step(jparams, jcfg, cache, tok, jnp.int32(pos))
            if pos + 1 < prompt_len:
                tok = jnp.asarray(prompt[:, pos + 1])
            else:
                tok = jnp.argmax(logits, axis=-1)
                generated.append(np.asarray(tok))
        np.testing.assert_array_equal(rep.results["summary"]["tokens"][rid],
                                      np.stack(generated, axis=1))


def test_serve_lm_whisper_repeats_its_tokens_when_tasks_fail():
    """Reduced whisper under the example's fault injection and under heavier
    failures: a retried request sees the same prompt and the same frames."""
    cfg = reduced(get_config("whisper_large_v3"))
    params = M.init_model(cfg, seed=0, device="cpu")
    kw = dict(requests=4, batch=2, prompt_len=5, gen_len=6, seed=0, device="cpu")
    runs = [serve_lm.run(cfg, params, **kw)[0] for _ in range(2)]
    faulty = serve.serve(cfg, params, **kw, faults=FaultConfig(task_failure_prob=0.3,
                                                                max_retries=6, seed=1))
    assert faulty.fault_stats["injected_failures"] > 0, faulty.fault_stats
    assert runs[0].results["summary"]["mean_prefill_s"] > 0.0
    for rep in (runs[1], faulty):
        for got, want in zip(rep.results["summary"]["tokens"],
                             runs[0].results["summary"]["tokens"], strict=True):
            np.testing.assert_array_equal(got, want)


def test_serve_lm_whisper_greedy_tokens_match_jax_decode_loop():
    """At the example's shape, on params made by the JAX package: each
    request's greedy tokens equal a greedy loop over JAX's ``decode_step``
    on the same prompt, with JAX's cross cache filled by hand from its
    ``encode`` of the same frames (``launch.serve.request_frames``)."""
    arch = "whisper_large_v3"
    jcfg, tcfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    requests, batch, prompt_len, gen_len, seed = 4, 2, 16, 16, 5
    rep, _ = serve_lm.run(tcfg, tparams, requests=requests, batch=batch,
                          prompt_len=prompt_len, gen_len=gen_len, seed=seed, device="cpu")
    step = jax.jit(JM.decode_step, static_argnums=1)
    for rid in range(requests):
        prompt = serve.request_prompts(seed, rid, batch, prompt_len, jcfg.vocab)
        frames = serve.request_frames(seed, rid, batch, jcfg.enc_frames, jcfg.d_model)
        cache = jax_cache_filled_by_hand(jcfg, jparams, frames, batch, prompt_len + gen_len)
        tok, generated = jnp.asarray(prompt[:, 0]), []
        for pos in range(prompt_len + gen_len - 1):
            logits, cache = step(jparams, jcfg, cache, tok, jnp.int32(pos))
            if pos + 1 < prompt_len:
                tok = jnp.asarray(prompt[:, pos + 1])
            else:
                tok = jnp.argmax(logits, axis=-1)
                generated.append(np.asarray(tok))
        np.testing.assert_array_equal(rep.results["summary"]["tokens"][rid],
                                      np.stack(generated, axis=1))
