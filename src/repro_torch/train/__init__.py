"""The train step and loop (the port's copy of `repro.train`)."""
from .step import TrainState, make_train_step
from .loop import TrainLoopConfig, train_loop

__all__ = ["TrainState", "TrainLoopConfig", "make_train_step", "train_loop"]
