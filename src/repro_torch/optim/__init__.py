"""Optimizer substrate: AdamW with fp32, bf16 or int8 moments, LR
schedules, global-norm clipping, and gradient synchronisation over the
``repro_torch.core`` interface (hierarchical, int8-compressed cross-pod
reduction with error feedback) — :mod:`repro.optim` in PyTorch."""

from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.grad_sync import (  # noqa: F401
    ErrorFeedbackState,
    PartitionedGradSync,
    sync_gradients,
)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup  # noqa: F401
