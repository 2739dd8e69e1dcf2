"""AdamW with fp32 or bf16 moment storage — :mod:`repro.optim.adamw` in
PyTorch.

The update follows the reference's order of operations in fp32 and casts
each result once.  It runs **in place**: the moments and the parameters are
overwritten leaf by leaf — each leaf in pieces of at most
:data:`~repro_torch.optim.clip.PIECE` elements, which changes nothing in an
elementwise update but bounds its fp32 temporaries — and ``update``
returns the same trees.  The
reference's persistent step donates its parameters and optimizer state for
the same reason — a second copy of the moments (twice the parameters in
fp32) does not fit beside the first on one card.  ``moment_dtype="int8"``
(the reference's block-quantized ``_Q8`` moments) waits for ROADMAP A13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import errors
from repro_torch.core.futures import flatten, unflatten
from repro_torch.optim.clip import pieces

Params = Any

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor     # 0-d int32
    mu: Params
    nu: Params


def _check_moment_dtype(dtype: str) -> torch.dtype:
    errors.check(
        dtype != "int8",
        errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
        "AdamW moment_dtype='int8' (block-quantized moments) is not ported yet: "
        "it waits for ROADMAP A13",
    )
    errors.check(
        dtype in _MOMENT_DTYPES,
        errors.ErrorClass.ERR_TYPE,
        f"AdamW moment_dtype must be one of {sorted(_MOMENT_DTYPES)}, got {dtype!r}",
    )
    return _MOMENT_DTYPES[dtype]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Functional AdamW: ``init(params) -> state``; ``update`` returns new
    (params, state), written in place.  ``lr`` may be a float or a
    ``step -> lr`` schedule."""

    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"   # float32 | bfloat16 (int8: ROADMAP A13)

    def __post_init__(self):
        _check_moment_dtype(self.moment_dtype)

    def init(self, params: Params) -> AdamWState:
        dtype = _MOMENT_DTYPES[self.moment_dtype]
        leaves, treedef = flatten(params)

        def zeros():
            return unflatten(treedef, [torch.zeros(p.shape, dtype=dtype, device=p.device)
                                       for p in leaves])

        device = leaves[0].device if leaves else None
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=zeros(), nu=zeros())

    def _update_piece(self, p, g, mu_z, nu_z, lr, bc1, bc2, decay: bool) -> None:
        g = g.float()
        mu = self.b1 * mu_z.float() + (1 - self.b1) * g
        nu = self.b2 * nu_z.float() + (1 - self.b2) * g * g
        del g
        mu_z.copy_(mu)
        nu_z.copy_(nu)
        step_dir = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        del mu, nu
        pf = p.float()
        if decay:
            step_dir = step_dir + self.weight_decay * pf
        p.copy_((pf - lr * step_dir).to(p.dtype))

    def _lr_at(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> tuple[Params, AdamWState]:
        step = state.step + 1
        lr = self._lr_at(step)
        stepf = step.float()
        # fills, not host-to-device copies: the step is captured as a CUDA graph
        b1 = torch.full((), self.b1, dtype=torch.float32, device=step.device)
        b2 = torch.full((), self.b2, dtype=torch.float32, device=step.device)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        flat_p, treedef = flatten(params)
        flat_g = flatten(grads)[0]
        flat_mu, mu_def = flatten(state.mu)
        flat_nu, nu_def = flatten(state.nu)
        errors.check(
            mu_def == treedef and nu_def == treedef and len(flat_g) == len(flat_p),
            errors.ErrorClass.ERR_ARG,
            "AdamW.update: grads, moments and params must share one tree structure",
        )
        for p, g, mu_z, nu_z in zip(flat_p, flat_g, flat_mu, flat_nu):
            decay = p.ndim >= 1  # decoupled decay on matrices/vectors, not scalars
            for pp, gp, mp, np_ in zip(pieces(p), pieces(g.contiguous()), pieces(mu_z),
                                       pieces(nu_z)):
                self._update_piece(pp, gp, mp, np_, lr, bc1, bc2, decay)
        state.step = step.to(torch.int32)
        return params, state
