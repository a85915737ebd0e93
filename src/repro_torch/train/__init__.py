"""Train state, init and step functions (ports :mod:`repro.train`)."""
from .steps import TrainState, build_init_fn, build_train_step, loss_and_grads

__all__ = ["TrainState", "build_init_fn", "build_train_step", "loss_and_grads"]
