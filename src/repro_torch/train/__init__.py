"""Train state, init and step functions (ports :mod:`repro.train`)."""
from .steps import (ParamLayout, TrainState, batch_shardings, build_init_fn, build_train_step,
                    gather_params, loss_and_grads, param_layout, train_state_shardings)

__all__ = ["ParamLayout", "TrainState", "batch_shardings", "build_init_fn", "build_train_step",
           "gather_params", "loss_and_grads", "param_layout", "train_state_shardings"]
