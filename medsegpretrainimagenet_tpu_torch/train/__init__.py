"""Training-side modules of the port: the train state, the train and eval
steps, checkpoint files and writers, and the epoch loop."""
from . import checkpoint  # noqa: F401
from .loop import run_epoch, train_model  # noqa: F401
from .state import TrainState  # noqa: F401
from .step import global_norm, make_eval_step, make_train_step  # noqa: F401

__all__ = ["TrainState", "make_train_step", "make_eval_step", "global_norm",
           "run_epoch", "train_model", "checkpoint"]
