"""Training substrate: step and loop. The pipeline-parallel stages and the
compressed data-parallel step wait for the port's mesh layer."""
from .loop import LoopResult, Watchdog, train_loop
from .step import TrainState, init_state, make_train_step

__all__ = ["TrainState", "init_state", "make_train_step", "LoopResult",
           "Watchdog", "train_loop"]
