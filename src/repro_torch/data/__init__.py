"""Synthetic token / embedding stream (ports :mod:`repro.data`)."""
from .pipeline import SyntheticTokens, to_device

__all__ = ["SyntheticTokens", "to_device"]
