"""Optimizer substrate: AdamW with fp32 or bf16 moments, LR schedules and
global-norm clipping — :mod:`repro.optim` in PyTorch.  The int8 moments and
the gradient synchronisation (``grad_sync``) wait for ROADMAP A13."""

from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup  # noqa: F401
