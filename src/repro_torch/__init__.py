"""PyTorch/CUDA port of the model substrate of :mod:`repro`.

The JAX package ``repro`` stays the reference; this package computes the
same functions with PyTorch tensors; its attention (forward and
backward), its Mamba2 SSD scan and its mLSTM scan run in CUDA C++
kernels written for Hopper (``kernels/csrc/flash_attention.cu``,
``flash_attention_bwd.cu``, ``ssd.cu``, ``mlstm.cu``).  It serves the
dense, hybrid and xLSTM families (``launch/serve.py``) and trains the
dense family (``launch/train.py``).
It imports neither ``jax`` nor anything of ``repro``: where it needs
code from there (configs, ``ModelConfig``), it keeps its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`resolve_device`); on CPU tensors every kernel wrapper takes
its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
