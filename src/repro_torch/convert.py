"""Weights from the reference into the port.

:func:`params_from_jax` maps the reference's parameter tree, given as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), 1:1 onto the port's
tree: the same nesting, names, shapes and dtypes, so both packages compute
the same function.  bf16 arrays (``ml_dtypes.bfloat16``) are carried over
bit for bit.
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
