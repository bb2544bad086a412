"""The paper's own machine configuration (for core/ benchmarks)."""
from ..core.machine import SMConfig

CONFIG = SMConfig()          # 512 threads, 16 SPs, 3K-word shared memory
QUAD = dict(n_instances=4)   # the quad-packed sector of paper SIII.E
