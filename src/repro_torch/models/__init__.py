"""PyTorch model zoo: the dense transformer, the hybrid Mamba2 family
(zamba2) and the xLSTM family of :mod:`repro.models`."""
from .common import ModelConfig, ParamBuilder, stack_params
from .model import Model

__all__ = ["Model", "ModelConfig", "ParamBuilder", "stack_params"]
