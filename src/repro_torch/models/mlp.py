"""Dense gated MLP (SwiGLU/GeGLU).  The mixture-of-experts blocks of
:mod:`repro.models.mlp` are not ported yet."""

from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.common import dense_init


def init_mlp(gen: torch.Generator, d: int, f: int, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    """``stack`` prepends leading dims (the scanned unit stack)."""

    return {
        "w_gate": dense_init(gen, d, stack + (d, f), dtype, stacked=bool(stack)),
        "w_up": dense_init(gen, d, stack + (d, f), dtype, stacked=bool(stack)),
        "w_down": dense_init(gen, f, stack + (f, d), dtype, stacked=bool(stack)),
    }


def mlp(p: common.Params, x: torch.Tensor, act: str) -> torch.Tensor:
    a = common.activation(act)
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(a(g) * u, p["w_down"])
