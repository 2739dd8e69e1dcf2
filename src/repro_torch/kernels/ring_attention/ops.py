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
the device once per call, so no step copies a host scalar.

The gradient is not ported: the reference's ``custom_vjp`` recomputes
through the plain ring, and the torch equivalent needs a differentiable
rotation; both wait for ROADMAP A14 item 5.  Until then a call whose
inputs require grad raises ``ERR_UNSUPPORTED_OPERATION``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import errors, overlap
from repro_torch.kernels.ring_attention import kernel as _kernel

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


def _forward(q, k, v, spec: RingSpec, cart, dim: int):
    """The fused ring loop on this rank.

    q: (b, sq, h, d); k/v: (b, sk, hk, d) — the local shards.  Returns the
    local output shard (b, sq, h, d) in q's dtype.
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
    table = torch.tensor(_schedule(spec, idx), dtype=torch.int32, device=dev)

    def rotate(buf):
        # the cart_shift(+1) exchange of the *stacked* KV buffer: one per
        # ring step, issued before the step's compute
        return cart.shift_exchange(buf, dim, 1)

    def step_fn(carry, buf, step):
        m, l, acc = carry
        return _kernel.ring_step_fwd(
            qt, buf[0], buf[1], m, l, acc, info=table[step],
            scale=spec.scale, causal=spec.causal,
        )

    m, l, acc = overlap.ring_rotate_compute(rotate, kv, spec.n, step_fn, (m, l, acc))
    out = acc / l.clamp_min(1e-30)                                  # (b, h, sqp, d)
    out = out.transpose(1, 2).to(q.dtype)
    return out[:, :sq] if sqp != sq else out


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
    state) against the dense flash reference.
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
    errors.check(
        not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))),
        errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
        "ring attention's gradient is not ported yet: it waits for ROADMAP A14 item 5 "
        "(a differentiable rotation and a recompute backward through the plain ring)",
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
    return _forward(q, k, v, spec, cart, dim)
