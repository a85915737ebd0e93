"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``csrc/*.cu`` — the kernels, built by :mod:`._build` with ``nvcc`` for
  ``sm_90a`` at first use and loaded with ``ctypes``;
* ``<name>.py`` — each kernel's wrapper: checks, launch, launch count;
* ``ops.py`` — the public functions: CPU tensors take the plain version
  in ``ref.py``, CUDA tensors take the kernel or raise; a call that needs
  a gradient runs the forward and backward kernels through the kernel's
  autograd Function.

Every TPU kernel of the JAX package has its counterpart here: flash
attention (``repro/kernels/flash_attention.py``), the Mamba2 SSD chunked
scan (``repro/kernels/ssd.py``) and the chunked mLSTM scan
(``repro/kernels/mlstm.py``).  The three backwards
(``csrc/flash_attention_bwd.cu``, ``csrc/ssd_bwd.cu``,
``csrc/mlstm_bwd.cu``) have no Pallas counterpart: the JAX package
differentiates its jnp attention and oracles.
"""
