"""Weights and optimizer state from the reference into the port.

:func:`params_from_jax` maps the reference's parameter tree, given as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), 1:1 onto the port's
tree: the same nesting, names, shapes and dtypes, so both packages compute
the same function.  bf16 arrays (``ml_dtypes.bfloat16``) are carried over
bit for bit.  :func:`opt_state_from_jax` does the same for the AdamW state
(``step``, ``mu``, ``nu``), so the trainer's whole state carries across.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(arr: Any, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: Any, device: str | torch.device = "cuda") -> Any:
    """Nested dicts/lists/tuples of numpy arrays → the same nest of tensors
    on ``device``."""

    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return _tensor(tree, device)


def _moments(tree: Any, device):
    """A moment tree: fp32 or bf16 leaves, or the reference's int8 ``_Q8``
    (numpy ``q`` and ``scale``; its static ``meta`` is implied by ``q``)
    as the port's."""

    from repro_torch.optim.adamw import _Q8

    if isinstance(tree, dict):
        return {k: _moments(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moments(v, device) for v in tree)
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return _Q8(q=_tensor(tree.q, device), scale=_tensor(tree.scale, device))
    return _tensor(tree, device)


def opt_state_from_jax(state: Any, device: str | torch.device = "cuda"):
    """The reference's ``AdamWState`` with numpy leaves → the port's
    :class:`~repro_torch.optim.AdamWState` on ``device`` (fp32, bf16 or
    int8 moments)."""

    from repro_torch.optim import AdamWState

    return AdamWState(step=_tensor(state.step, device), mu=_moments(state.mu, device),
                      nu=_moments(state.nu, device))
