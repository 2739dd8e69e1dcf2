"""Checkpointing built on the parallel-IO component (``repro_torch.core.io``):
async save, atomic step manifests in the reference's format, restore."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
