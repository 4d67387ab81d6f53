"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``; see
``portbench/README.md``.  The last line of standard output is the
result's JSON object; the compared numbers and their limits are the last
lines of standard error.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's kernel caches at fixed places inside the checkout, so that
# only a checkout's first run builds or compiles
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(ROOT / "build" / "portbench"
                                               / "autotune.json")
# the harness is a package of the checkout's root, the program lives under
# src/; the script's own folder must not shadow standard modules
sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
