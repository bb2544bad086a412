"""Card time a step of the matrix-product kernels (cuBLAS's and
CUTLASS's, by name) in the traced sub-window."""
import re

PATTERNS = re.compile(r"gemm|gemv|xmma|cutlass|sgemm|Kernel2", re.I)


def read(run):
    p = run.profile
    if p is None or not p.has_device:
        return None
    ops = [op for op in p.ops if PATTERNS.search(op[2])
           and p.window[0] <= op[0] < p.window[1]]
    if not ops:
        return None
    return 1e3 * p.device_s(ops) / run.counters["profile_steps"]
