"""Training-side modules of the port: the train state, the train and eval
steps, and checkpoint files.  The epoch loop and the checkpoint writers
come with ROADMAP queue M6's rest."""
from .state import TrainState  # noqa: F401
from .step import global_norm, make_eval_step, make_train_step  # noqa: F401

__all__ = ["TrainState", "make_train_step", "make_eval_step", "global_norm"]
