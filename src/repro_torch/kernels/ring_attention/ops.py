"""Ring attention over a 1-D periodic
:class:`~repro_torch.core.topology.CartComm`: the eager counterpart of
:mod:`repro.kernels.ring_attention.ops`.

Every rank holds its Q shard for the whole schedule while the stacked KV
buffer rotates around the ring: ``n`` steps, ``n - 1`` exchanges, each
issued with ``cart.shift_exchange`` *before* the step it overlaps with and
joined via ``when_all`` (:func:`repro_torch.core.overlap.
ring_rotate_compute`).  Each step is one call of the ring-step kernel
(:mod:`.kernel`: the CUDA kernel on the card, the plain twin on the CPU).
A ring of one issues no exchange.

Uneven global lengths: the caller pads the global sequence to ``n × shard``
(padding at the tail, so shard ``r`` owns global rows ``[r·shard,
(r+1)·shard)`` and only trailing shards hold padding); ``global_len`` sizes
the per-source valid-row table that masks padded columns out of the online
softmax inside the kernel.  On the card the schedule's scalars
``(q_offset, k_offset, kv_len)`` of every step are one int32 table copied to
the device once per ``(spec, rank, device)`` and kept, so no step copies a
host scalar and a captured step (a CUDA graph) copies none either.

Gradients: a ``torch.autograd.Function`` with the reference's
``custom_vjp`` convention.  The forward runs the kernel and keeps ``q, k,
v``; the backward recomputes the whole ring through the plain step
(``ref.ring_step_ref``, never the kernel's wrapper) with each rotation a
differentiable shift (:func:`repro_torch.core.topology.
shift_differentiable`, whose backward sends the cotangent one rank back),
and returns the recompute's gradient.  No per-step scores outlive the
forward.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import errors, overlap, topology
from repro_torch.core.futures import Future
from repro_torch.kernels.ring_attention import kernel as _kernel
from repro_torch.kernels.ring_attention import ref as _ref

NEG_INF = _kernel.NEG_INF


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Static description of one ring-attention schedule.  ``axis_name``
    and ``axis_perm`` come from ``cart.cart_shift(dim, +1)``; ``shard`` is
    the per-rank sequence length *before* block padding; ``global_len`` the
    unpadded global sequence length.  ``impl`` is kept for the reference's
    signature: the tensors' device picks the kernel or its plain twin."""

    axis_name: str
    axis_perm: tuple[tuple[int, int], ...]
    n: int
    shard: int
    global_len: int
    causal: bool
    scale: float
    impl: str
    block_q: int
    block_k: int

    def kv_lens(self) -> tuple[int, ...]:
        """Valid KV rows per source shard (the ragged tail lives on the
        trailing shards)."""

        return tuple(
            max(0, min(self.shard, self.global_len - r * self.shard))
            for r in range(self.n)
        )


def _pad_seq(x: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % block
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def _schedule(spec: RingSpec, idx: int) -> list[tuple[int, int, int]]:
    """(q_offset, k_offset, kv_len) of each step on ring position ``idx``:
    step ``s`` folds the shard of source ``(idx - s) mod n``."""

    lens = spec.kv_lens()
    rows = []
    for step in range(spec.n):
        src = (idx - step) % spec.n
        rows.append((idx * spec.shard, src * spec.shard, lens[src]))
    return rows


#: each ring position's schedule on the device, built once outside any
#: capture: (spec, position, device) -> int32 (n, 3)
_TABLES: dict = {}


def _table(spec: RingSpec, idx: int, device) -> torch.Tensor:
    key = (spec, idx, str(device))
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.tensor(_schedule(spec, idx), dtype=torch.int32,
                                            device=device)
    return table


def _forward(q, k, v, spec: RingSpec, cart, dim: int, *, plain: bool = False):
    """The fused ring loop on this rank.

    q: (b, sq, h, d); k/v: (b, sk, hk, d) — the local shards.  Returns the
    local output shard (b, sq, h, d) in q's dtype.  ``plain`` runs each
    step through ``ref.ring_step_ref`` and each rotation through the
    differentiable shift: the backward's recompute.
    """

    b, sq, h, d = q.shape
    sk = k.shape[1]
    idx = cart.cart_coords(cart.rank())[dim]

    # head-major layout once, outside the loop; block padding once (the
    # kv_len table masks padded K columns, padded Q rows are sliced off)
    block_q = min(spec.block_q, sq)
    block_k = min(spec.block_k, sk)
    qt = _pad_seq(q.transpose(1, 2), block_q, 2)                   # (b, h, sqp, d)
    kv = _pad_seq(torch.stack([k, v]).transpose(2, 3), block_k, 3)  # (2, b, hk, skp, d)
    kv = kv.contiguous()
    sqp = qt.shape[2]

    dev = q.device
    m = torch.full((b, h, sqp, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sqp, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sqp, d), dtype=torch.float32, device=dev)

    if plain:
        rows = _schedule(spec, idx)

        def rotate(buf):
            return Future(topology.shift_differentiable(cart, buf, dim, 1), works=())

        def step_fn(carry, buf, step):
            q_off, k_off, kv_len = rows[step]
            return _ref.ring_step_ref(qt, buf[0], buf[1], *carry, q_offset=q_off,
                                      k_offset=k_off, kv_len=kv_len, scale=spec.scale,
                                      causal=spec.causal)
    else:
        table = _table(spec, idx, dev)

        def rotate(buf):
            # the cart_shift(+1) exchange of the *stacked* KV buffer: one
            # per ring step, issued before the step's compute
            return cart.shift_exchange(buf, dim, 1)

        def step_fn(carry, buf, step):
            return _kernel.ring_step_fwd(qt, buf[0], buf[1], *carry, info=table[step],
                                         scale=spec.scale, causal=spec.causal)

    m, l, acc = overlap.ring_rotate_compute(rotate, kv, spec.n, step_fn, (m, l, acc))
    out = acc / l.clamp_min(1e-30)                                  # (b, h, sqp, d)
    out = out.transpose(1, 2).to(q.dtype)
    return out[:, :sq] if sqp != sq else out


class _Ring(torch.autograd.Function):
    """The reference's ``_ring`` / ``_fwd`` / ``_bwd``: the kernel forward,
    and a backward that recomputes the ring through the plain step under
    autograd and returns the recompute's vector-Jacobian product."""

    @staticmethod
    def forward(ctx, q, k, v, spec, cart, dim):
        ctx.save_for_backward(q, k, v)
        ctx.spec, ctx.cart, ctx.dim = spec, cart, dim
        return _forward(q, k, v, spec, cart, dim)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True) for t in saved)
            out = _forward(q, k, v, ctx.spec, ctx.cart, ctx.dim, plain=True)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def ring_attention(
    cart,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dim: int = 0,
    causal: bool = True,
    scale: float | None = None,
    global_len: int | None = None,
    impl: str = "pallas",
    block_q: int = _kernel.DEFAULT_BLOCK_Q,
    block_k: int = _kernel.DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Blockwise ring attention over cart dimension ``dim`` (periodic).

    Per-rank entry point: ``q`` (b, sq, h, d), ``k``/``v`` (b, sk, hk, d)
    are this rank's shards of a sequence padded to ``n × shard``;
    ``global_len`` (default ``n × sq``) is the unpadded length.  Exact (fp32
    state) against the dense flash reference; differentiable, with the
    backward recomputed through the plain ring.
    """

    errors.check(
        0 <= dim < len(cart.dims),
        errors.ErrorClass.ERR_DIMS,
        f"ring dim {dim} out of range for cart dims {cart.dims}",
    )
    errors.check(
        cart.periods[dim],
        errors.ErrorClass.ERR_TOPOLOGY,
        "ring attention needs a periodic ring dimension (the KV rotation "
        "must wrap; create the cart with periods=True on the ring dim)",
    )
    errors.check(
        q.shape[1] == k.shape[1],
        errors.ErrorClass.ERR_COUNT,
        f"ring attention shards Q and KV identically, got q seq {q.shape[1]} "
        f"vs kv seq {k.shape[1]}",
    )
    n = cart.dims[dim]
    shard = q.shape[1]
    if global_len is None:
        global_len = n * shard
    errors.check(
        0 < global_len <= n * shard,
        errors.ErrorClass.ERR_COUNT,
        f"global_len {global_len} inconsistent with {n} shards of {shard}",
    )
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    shift = cart.cart_shift(dim, 1)
    spec = RingSpec(
        axis_name=shift.axis_name,
        axis_perm=tuple(shift.axis_perm),
        n=n,
        shard=shard,
        global_len=int(global_len),
        causal=bool(causal),
        scale=float(scale),
        impl=impl,
        block_q=int(block_q),
        block_k=int(block_k),
    )
    return _Ring.apply(q, k, v, spec, cart, dim)
