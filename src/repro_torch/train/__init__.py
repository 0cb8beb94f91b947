"""Training on one device (port of ``repro.train``): the train step and
the trainer loop."""
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step, train_state_specs)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "train_state_specs", "Trainer", "TrainerConfig"]
