"""The plain reference the MLA tests hold the port to.

It is the benchmark's own file, ``portbench/reference/mla_moe.py``, loaded
from the repository's root, so that the CPU tests and the card's comparison
that decides a run's ``correct`` hold the port to one reference:
``tests/test_torch_mla.py`` checks that ``reference`` is that file.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import mla_moe as reference  # noqa: E402
from portbench.reference.lm import Precision  # noqa: E402

BENCHMARK_FILE = ROOT / "portbench" / "reference" / "mla_moe.py"

__all__ = ["reference", "Precision", "BENCHMARK_FILE"]
