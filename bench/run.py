"""One run of one benchmark cell, from the root of a checkout:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cells are those of ``BENCHMARK.json``; the program is the package in
``src/``. The result is the last line of standard output.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], ROOT, T0))
