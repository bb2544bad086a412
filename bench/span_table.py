"""Where a step's card time goes by the port's own spans, from one traced
run of a training cell on the card (not run by the benchmark's runs):

    python3 bench/span_table.py --workload <name> --seed <n> --seconds <s>

Prints one JSON line: ``spans``, per port span name a step's card ms of
what its spans launched (``products`` by ``gemm_ms.train``'s patterns,
and the ``rest``), the same for what it launched as the innermost port
span (``self_products``, ``self_rest``) and the idle ms put down to it
(``harness.program_spans.table``), or null where the spans could not be
placed on the trace; ``line``, the run's result line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import torch  # noqa: E402

from harness import cells, cli, program_spans  # noqa: E402
from harness.record import Run  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="bench/span_table.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cli.set_cache_dirs(ROOT)
    cell = cells.load(ROOT, args.workload)
    program_spans.install()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, args.seed, args.seconds, True, "cuda")
    cli.drive(run, T0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    print(json.dumps({"spans": program_spans.table(run),
                      "line": cli.result_line(run, device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
