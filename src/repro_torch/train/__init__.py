"""Train state, init and step functions, and the serving steps (ports
:mod:`repro.train`)."""
from .steps import (ParamLayout, TrainState, abstract_cache, batch_shardings, build_init_fn,
                    build_prefill_step, build_serve_step, build_train_step, cache_layouts,
                    gather_params, loss_and_grads, param_layout, place_batch,
                    serving_param_shapes, shard_params, train_state_shardings)

__all__ = ["ParamLayout", "TrainState", "abstract_cache", "batch_shardings", "build_init_fn",
           "build_prefill_step", "build_serve_step", "build_train_step", "cache_layouts",
           "gather_params", "loss_and_grads", "param_layout", "place_batch",
           "serving_param_shapes", "shard_params", "train_state_shardings"]
