"""Synthetic token / embedding stream (ports :mod:`repro.data`)."""
from .pipeline import SyntheticTokens, batch_spec, make_batch_on_mesh, to_device

__all__ = ["SyntheticTokens", "batch_spec", "make_batch_on_mesh", "to_device"]
