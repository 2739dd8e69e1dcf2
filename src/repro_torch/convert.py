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


def opt_state_from_jax(state: Any, device: str | torch.device = "cuda"):
    """The reference's ``AdamWState`` with numpy leaves → the port's
    :class:`~repro_torch.optim.AdamWState` on ``device`` (fp32 or bf16
    moments; the int8 ``_Q8`` moments wait for ROADMAP A13)."""

    from repro_torch.optim import AdamWState

    return AdamWState(step=_tensor(state.step, device),
                      mu=params_from_jax(state.mu, device),
                      nu=params_from_jax(state.nu, device))
