"""PyTorch/CUDA port of :mod:`repro`.

The JAX package ``repro`` stays the reference; this package computes the
same functions with PyTorch tensors.  Its attention, Mamba2 SSD scan and
mLSTM scan run forward and backward in CUDA C++ kernels written for
Hopper (``kernels/csrc/flash_attention.cu``, ``flash_attention_bwd.cu``,
``ssd.cu``, ``ssd_bwd.cu``, ``mlstm.cu``, ``mlstm_bwd.cu``).  Every
family (dense, gemma2's alternating windows, MoE, the hybrid Mamba2 and
xLSTM) serves (``launch/serve.py``) and trains (``launch/train.py``):
plainly, elastically (``elastic/`` drives the train state through the
reconfigurations that its copies of the control plane, ``core/`` and
``malleability/``, plan and price) and across ranks (``launch/mesh.py``,
``parallel/``: data, tensor/sequence and expert parallel over
``torch.distributed``, each block's weights gathered in the layer
loop).  The elastic serving plane (``serving/``) is ported too.
:mod:`repro_torch.api` is the surface to program against: the names of
:mod:`repro.api`, each resolving to its counterpart here.
It imports neither ``jax`` nor anything of ``repro``: where it needs
code from there (configs, ``ModelConfig``), it keeps its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`resolve_device`); on CPU tensors every kernel wrapper takes
its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
