"""Readings that the limits of a cell's output check are set from, on the
card at the cell's own size (not run by the benchmark's runs):

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault NAME --fault-seeds 1,2,3] \\
        [--out FILE]

For each seed, the program's numbers (sound runs: the lower readings);
for each control seed, the numbers of the reference in TF32 put in the
program's place (the control); for each fault seed, the program's
numbers with the fault planted (``harness.faults``). A training cell
needs no window: set-up's steps are what is compared. One JSON line a
reading, on standard output and in ``--out``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]

import torch  # noqa: E402

from harness import cells, cli, faults, train  # noqa: E402
from harness.record import Run  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _free():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def train_readings(cell, seed, control, fault):
    out = []
    run = Run(cell, seed, 0.0, False, "cuda")
    B, S = int(cell.traffic["batch"]), int(cell.traffic["seq_len"])
    t = time.perf_counter()
    prog = train.Program(run, B * S)
    got = prog.first_steps(run, int(cell.traffic["check_steps"]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    del prog
    _free()
    t = time.perf_counter()
    ref = train.reference(run)
    ref_s = time.perf_counter() - t
    g_med = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
    out.append({"kind": "program", "numbers": train.compare(got, ref),
                "leaves_left_out": sum(r < 1e-3 * g_med
                                       for r in ref["grads"].values()),
                "losses": got["losses"], "ref_losses": ref["losses"],
                "setup_steps_s": first_s, "reference_s": ref_s,
                "memory_peak_bytes": peak})
    _free()
    if control:
        ctl = train.reference(run, tf32=True)
        out.append({"kind": "control", "numbers": train.compare(ctl, ref),
                    "losses": ctl["losses"]})
        _free()
    if fault:
        prog = train.Program(run, B * S)
        faults.FAULTS[fault](prog)
        got = prog.first_steps(run, int(cell.traffic["check_steps"]))
        del prog
        _free()
        out.append({"kind": "fault:" + fault,
                    "numbers": train.compare(got, ref),
                    "losses": got["losses"]})
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cli.set_cache_dirs(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.load(ROOT, args.workload)
    seeds, ctl = _seeds(args.seeds), set(_seeds(args.control_seeds))
    flt = set(_seeds(args.fault_seeds))
    sink = open(args.out, "a") if args.out else None
    for seed in dict.fromkeys(seeds + sorted(ctl) + sorted(flt)):
        t = time.perf_counter()
        rows = train_readings(cell, seed, seed in ctl,
                              args.fault if seed in flt else "")
        for row in rows:
            row.update(workload=args.workload, seed=seed,
                       card=torch.cuda.get_device_name(0),
                       seconds=time.perf_counter() - t)
            text = json.dumps(row)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
