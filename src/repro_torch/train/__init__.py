"""Training substrate: step and loop, the steps on a mesh and the
pipeline-parallel stages (``train.pipeline``)."""
from .loop import LoopResult, Watchdog, train_loop
from .step import (
    TrainState,
    init_state,
    make_compressed_dp_step,
    make_sharded_train_step,
    make_train_step,
)

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_sharded_train_step", "make_compressed_dp_step",
           "LoopResult", "Watchdog", "train_loop"]
