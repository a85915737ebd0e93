"""Flat-file checkpoints (ports :mod:`repro.checkpoint`): the JAX package's
layout, so either package restores the other's snapshots."""
from .store import CheckpointManager, latest_step, restore_tree, save_tree

__all__ = ["CheckpointManager", "latest_step", "restore_tree", "save_tree"]
