"""PyTorch model zoo: the dense transformer of :mod:`repro.models`."""
from .common import ModelConfig, ParamBuilder, stack_params
from .model import Model

__all__ = ["Model", "ModelConfig", "ParamBuilder", "stack_params"]
