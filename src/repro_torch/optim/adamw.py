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

On DTensor parameters (placed state, :mod:`repro_torch.sharding`) the
moments are DTensors in their parameter's placement (an int8 moment's
scales placed as its rows: split like the payload's leading dims, whole
along the last), and the update runs on each rank's local shards in place:
elementwise, it gives every element the bits the whole update gives it.
An int8 moment whose last axis is split takes each row's absmax over the
whole row: each piece of the fp32 moment (whole rows, at most ``PIECE``
elements of them) is gathered along the last axis around its quantize,
and each rank keeps its slice of the payload.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import errors
from repro_torch.core.futures import flatten, unflatten
from repro_torch.kernels.quant import ops as quant
from repro_torch.optim.clip import PIECE, pieces
from repro_torch.sharding.local import is_dtensor, shard_range

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


def _row_placements(p) -> list:
    """A DTensor's placements with its last dim made whole."""

    from torch.distributed.tensor import Replicate

    return [Replicate() if pl.is_shard(p.ndim - 1) else pl for pl in p.placements]


def _q8_zeros(p: torch.Tensor) -> _Q8:
    """The int8 store of a zero moment of ``p``'s shape: zero payloads and
    unit scales, allocated as they are (quantizing fp32 zeros would take a
    temporary four times the payload)."""

    shape = tuple(p.shape)
    if is_dtensor(p):
        from torch.distributed.tensor import ones

        scale = ones(shape[:-1] + (1,) if shape else (), dtype=torch.float32,
                     device_mesh=p.device_mesh, placements=_row_placements(p))
        return _Q8(q=torch.zeros_like(p, dtype=torch.int8), scale=scale)
    return _Q8(q=torch.zeros(shape, dtype=torch.int8, device=p.device),
               scale=torch.ones(shape[:-1] + (1,) if shape else (), dtype=torch.float32,
                                device=p.device))


def _read(z) -> torch.Tensor:
    return _q8_read(z) if isinstance(z, _Q8) else z.float()


def _store(z, x: torch.Tensor, whole=None) -> None:
    """Write the fp32 moment ``x`` into the store ``z`` in place.  An int8
    store whose rows other ranks hold part of quantizes the whole rows,
    ``whole(x)`` (the rows gathered, and the slice of this rank's
    columns)."""

    if isinstance(z, _Q8):
        if whole is None:
            new = _q8_of(x)
            z.q.copy_(new.q)
        else:
            rows, cols = whole(x)
            new = _q8_of(rows)
            z.q.copy_(new.q[..., cols])
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
            return unflatten(treedef, [torch.zeros_like(p, dtype=dtype) if is_dtensor(p)
                                       else torch.zeros(p.shape, dtype=dtype, device=p.device)
                                       for p in leaves])

        device = leaves[0].device if leaves else None
        step = torch.zeros((), dtype=torch.int32, device=device)
        if leaves and is_dtensor(leaves[0]):
            from torch.distributed.tensor import Replicate
            from torch.distributed.tensor import zeros as dzeros

            mesh = leaves[0].device_mesh
            step = dzeros((), dtype=torch.int32, device_mesh=mesh,
                          placements=[Replicate()] * mesh.ndim)
        return AdamWState(step=step, mu=zeros(), nu=zeros())

    def _update_piece(self, p, g, mu_z, nu_z, lr, bc1, bc2, decay: bool, whole=None) -> None:
        g = g.float()
        mu = self.b1 * _read(mu_z) + (1 - self.b1) * g
        nu = self.b2 * _read(nu_z) + (1 - self.b2) * g * g
        del g
        _store(mu_z, mu, whole)
        _store(nu_z, nu, whole)
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
        # a placed (replicated DTensor) counter steps on its local value
        placed = is_dtensor(state.step)
        step = (state.step.to_local() if placed else state.step) + 1
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
            width = p.shape[-1] if p.ndim else 1   # a whole row's, where p is split
            whole = None
            if is_dtensor(p):
                p, g, mu_z, nu_z, whole = _local_leaves(p, g, mu_z, nu_z, is_q8)
            g = g.contiguous()
            if is_q8:
                # whole rows a piece: a row's scale needs the whole row; a
                # row split over ranks is gathered a piece at a time
                rows = max(1, PIECE // width)
                parts = zip(_row_pieces(p, rows), _row_pieces(g, rows),
                            _q8_pieces(mu_z.value, rows), _q8_pieces(nu_z.value, rows))
            else:
                parts = zip(pieces(p), pieces(g), pieces(mu_z), pieces(nu_z))
            for pp, gp, mp, np_ in parts:
                self._update_piece(pp, gp, mp, np_, lr, bc1, bc2, decay, whole)
        step = step.to(torch.int32)
        if placed:
            from torch.distributed.tensor import DTensor

            step = DTensor.from_local(step, state.step.device_mesh, state.step.placements,
                                      run_check=False)
        state.step = step
        return params, state


def _local_leaves(p, g, mu_z, nu_z, is_q8: bool):
    """The local shards of one DTensor leaf's parameter, gradient (placed
    as the parameter) and moments, and for an int8 leaf whose last axis is
    split, the whole-row gather of a piece of local rows that
    :func:`_store` takes (else ``None``).  A moment placed other than its
    parameter is refused."""

    mesh, place = p.device_mesh, tuple(p.placements)
    if tuple(g.placements) != place:
        g = g.redistribute(mesh, place)
    stores = [z.value.q if is_q8 else z for z in (mu_z, nu_z)]
    errors.check(
        all(tuple(z.placements) == place for z in stores),
        errors.ErrorClass.ERR_DIMS,
        f"AdamW: a moment placed {[tuple(z.placements) for z in stores]} under a "
        f"parameter placed {place}: the update runs on matching shards",
    )

    def local(z):
        if is_q8:
            return _Leaf(_Q8(z.value.q.to_local(), z.value.scale.to_local()))
        return z.to_local()

    last = p.ndim - 1
    split = is_q8 and any(pl.is_shard(last) and mesh.size(i) > 1 for i, pl in enumerate(place))
    whole = None
    if split:
        from torch.distributed.tensor import DTensor, Replicate, Shard

        off, n = shard_range(place, mesh, last, p.shape[-1])
        # a piece (rows, local columns): the mesh dims that split the last
        # axis split its columns; the others hold other rows (or the same)
        piece_pl = [Shard(1) if pl.is_shard(last) else Shard(0) if pl.is_shard() else pl
                    for pl in place]
        rows_pl = [Replicate() if pl.is_shard(1) else pl for pl in piece_pl]

        def whole(x):
            dx = DTensor.from_local(x, mesh, piece_pl, run_check=False)
            return dx.redistribute(mesh, rows_pl).to_local(), slice(off, off + n)

    return p.to_local(), g.to_local(), local(mu_z), local(nu_z), whole


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
