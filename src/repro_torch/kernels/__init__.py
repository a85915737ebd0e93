"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``csrc/*.cu`` — the kernels, built by :mod:`._build` with ``nvcc`` for
  ``sm_90a`` at first use and loaded with ``ctypes``;
* ``<name>.py`` — each kernel's wrapper: checks, launch, launch count;
* ``ops.py`` — the public functions: CPU tensors take the plain version
  in ``ref.py``, CUDA tensors take the kernel or raise.

Ported so far: flash attention (``repro/kernels/flash_attention.py``)
and the Mamba2 SSD chunked scan (``repro/kernels/ssd.py``).  The mLSTM
scan is still to be ported (ROADMAP.md, section B).
"""
