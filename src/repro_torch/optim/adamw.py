"""AdamW with fp32, bf16 or int8 moment storage — :mod:`repro.optim.adamw`
in PyTorch.

The update follows the reference's order of operations in fp32 and casts
each result once.  It runs **in place**: the moments and the parameters are
overwritten leaf by leaf — each leaf in pieces of at most
:data:`~repro_torch.optim.clip.PIECE` elements, which changes nothing in an
elementwise update but bounds its fp32 temporaries — and ``update``
returns the same trees.  The reference's persistent step donates its
parameters and optimizer state for the same reason — a second copy of the
moments (twice the parameters in fp32) does not fit beside the first on
one card.

``moment_dtype="int8"`` stores each moment as the reference's ``_Q8``: an
int8 payload of the parameter's shape and one fp32 scale per row of its
last axis (``absmax / 127``, or 1 for a row of zeros), a quarter of fp32's
bytes.  The int8 pieces hold whole rows (a row's scale needs the whole
row), at most ``PIECE`` elements a piece where the rows allow; on the card
each piece's payloads are read and written by the int8 row kernels
(:mod:`repro_torch.kernels.quant`: one dequantize and one quantize a moment
and piece).  The step direction uses the fp32 moments before they are
stored quantized, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import errors
from repro_torch.core.futures import flatten, unflatten
from repro_torch.kernels.quant import ops as quant
from repro_torch.optim.clip import PIECE, pieces

Params = Any

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass
class _Q8:
    """An int8 moment: the payload (the parameter's shape) and fp32 scales
    (``shape[:-1] + (1,)``, one per row of the last axis).  The reference's
    static ``meta`` (pad 0, the shape) is not kept: the pad is always 0 and
    the shape is ``q.shape``, and a field here would be a leaf of every
    request signature and a record of every checkpoint."""

    q: torch.Tensor
    scale: torch.Tensor


def _q8_of(x: torch.Tensor) -> _Q8:
    """Quantize ``x`` along its last axis, keeping its shape; a 0-d ``x`` is
    stored as ``x.to(int8)``, truncated toward zero, as the reference
    stores it (ROADMAP C9)."""

    if x.ndim == 0:
        return _Q8(q=x.to(torch.int8), scale=torch.ones((), dtype=torch.float32,
                                                        device=x.device))
    q, scale = quant.quantize_int8_rows(x.reshape(-1, x.shape[-1]))
    return _Q8(q=q.view(x.shape), scale=scale.view(*x.shape[:-1], 1))


def _q8_read(z: _Q8) -> torch.Tensor:
    """The fp32 moment ``q · scale`` (a 0-d one: ``q`` alone)."""

    if z.q.ndim == 0:
        return z.q.float()
    width = z.q.shape[-1]
    return quant.dequantize_int8_rows(z.q.reshape(-1, width), z.scale.reshape(-1, 1),
                                      torch.float32).view(z.q.shape)


def _q8_zeros(p: torch.Tensor) -> _Q8:
    """The int8 store of a zero moment of ``p``'s shape: zero payloads and
    unit scales, allocated as they are (quantizing fp32 zeros would take a
    temporary four times the payload)."""

    shape = tuple(p.shape)
    return _Q8(q=torch.zeros(shape, dtype=torch.int8, device=p.device),
               scale=torch.ones(shape[:-1] + (1,) if shape else (), dtype=torch.float32,
                                device=p.device))


def _read(z) -> torch.Tensor:
    return _q8_read(z) if isinstance(z, _Q8) else z.float()


def _store(z, x: torch.Tensor) -> None:
    """Write the fp32 moment ``x`` into the store ``z`` in place."""

    if isinstance(z, _Q8):
        new = _q8_of(x)
        z.q.copy_(new.q)
        z.scale.copy_(new.scale)
    else:
        z.copy_(x)


def _row_pieces(t: torch.Tensor, rows: int) -> list[torch.Tensor]:
    """Row views of ``t`` (contiguous, as (rows of its last axis, width)) of
    at most ``rows`` rows each; a 0-d ``t`` is one piece."""

    if t.ndim == 0:
        return [t]
    flat = t.view(-1, t.shape[-1])
    return [flat[i:i + rows] for i in range(0, flat.shape[0], rows)]


def _q8_pieces(z: _Q8, rows: int) -> list[_Q8]:
    return [_Q8(q, s) for q, s in zip(_row_pieces(z.q, rows), _row_pieces(z.scale, rows))]


def _check_moment_dtype(dtype: str) -> torch.dtype:
    errors.check(
        dtype in _MOMENT_DTYPES,
        errors.ErrorClass.ERR_TYPE,
        f"AdamW moment_dtype must be one of {sorted(_MOMENT_DTYPES)}, got {dtype!r}",
    )
    return _MOMENT_DTYPES[dtype]


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor     # 0-d int32
    mu: Params
    nu: Params


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
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8

    def __post_init__(self):
        _check_moment_dtype(self.moment_dtype)

    def init(self, params: Params) -> AdamWState:
        dtype = _MOMENT_DTYPES[self.moment_dtype]
        leaves, treedef = flatten(params)

        def zeros():
            if dtype == torch.int8:
                return unflatten(treedef, [_q8_zeros(p) for p in leaves])
            return unflatten(treedef, [torch.zeros(p.shape, dtype=dtype, device=p.device)
                                       for p in leaves])

        device = leaves[0].device if leaves else None
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          mu=zeros(), nu=zeros())

    def _update_piece(self, p, g, mu_z, nu_z, lr, bc1, bc2, decay: bool) -> None:
        g = g.float()
        mu = self.b1 * _read(mu_z) + (1 - self.b1) * g
        nu = self.b2 * _read(nu_z) + (1 - self.b2) * g * g
        del g
        _store(mu_z, mu)
        _store(nu_z, nu)
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
        is_q8 = self.moment_dtype == "int8"
        flat_mu, mu_def = flatten(_stores(state.mu, is_q8))
        flat_nu, nu_def = flatten(_stores(state.nu, is_q8))
        errors.check(
            mu_def == treedef and nu_def == treedef and len(flat_g) == len(flat_p),
            errors.ErrorClass.ERR_ARG,
            "AdamW.update: grads, moments and params must share one tree structure",
        )
        for p, g, mu_z, nu_z in zip(flat_p, flat_g, flat_mu, flat_nu):
            decay = p.ndim >= 1  # decoupled decay on matrices/vectors, not scalars
            g = g.contiguous()
            if is_q8:
                # whole rows a piece: a row's scale needs the whole row
                rows = max(1, PIECE // p.shape[-1]) if p.ndim else 1
                parts = zip(_row_pieces(p, rows), _row_pieces(g, rows),
                            _q8_pieces(mu_z.value, rows), _q8_pieces(nu_z.value, rows))
            else:
                parts = zip(pieces(p), pieces(g), pieces(mu_z), pieces(nu_z))
            for pp, gp, mp, np_ in parts:
                self._update_piece(pp, gp, mp, np_, lr, bc1, bc2, decay)
        state.step = step.to(torch.int32)
        return params, state


class _Leaf:
    """A ``_Q8`` held as one leaf (not a dataclass, so :func:`flatten` does
    not open it) while the moment tree is flattened beside the
    parameters'."""

    __slots__ = ("value",)

    def __init__(self, value: _Q8):
        self.value = value


def _stores(tree, is_q8: bool):
    """The moment tree with each ``_Q8`` as one opaque leaf."""

    if not is_q8:
        return tree
    if isinstance(tree, _Q8):
        return _Leaf(tree)
    if isinstance(tree, dict):
        return {k: _stores(v, True) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stores(v, True) for v in tree)
    return tree
