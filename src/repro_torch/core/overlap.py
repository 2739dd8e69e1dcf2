"""Overlappable collective schedules (paper C3, performance side): the ring
part of :mod:`repro.core.overlap`.

MPI programs overlap communication and computation by issuing ``MPI_I*``
operations and computing until ``MPI_Wait``.  In eager PyTorch the
point-to-point exchange is issued (``dist.batch_isend_irecv``) before the
step's compute is queued, and the two are joined with
:func:`~repro_torch.core.futures.when_all`.

Contents:

* :func:`ring_all_gather` / :func:`ring_all_gather_bidirectional` /
  :func:`ring_reduce_scatter` — the explicit ring algorithms, drop-in for
  the collectives: each ring step one matched exchange
  (:func:`~repro_torch.core.collectives.send_recv`, a
  ``dist.batch_isend_irecv``); on one rank the input comes back as it is.
* :class:`RingAllGatherFuture` and the ``immediate_*`` helpers — the
  future-returning forms (``comm.immediate_ring_allgather``): ``get()``
  runs the ring gather, ``then_matmul`` never gathers and runs
  :func:`all_gather_matmul` instead.
* :func:`partitioned_ring_reduce_scatter` /
  :func:`partitioned_ring_all_gather` — the rings, one a partition of a
  :class:`~repro_torch.core.futures.PartitionedRequest`.
* :func:`ring_rotate_compute` — the double-buffered rotate-while-compute
  schedule, the engine under ring attention
  (:mod:`repro_torch.kernels.ring_attention`).
* :func:`ring_attention` — the plain eager ring: KV blocks circulate while
  each rank holds its Q shard; the oracle of the fused ring.
* :func:`hierarchical_allreduce` — reduce-scatter inside the fast
  communicator, (optionally int8-compressed) reduction across the slow
  one, all-gather back: the cross-pod gradient reduction.
* :func:`partitioned_allreduce` — partitioned communication
  (``MPI_Psend_init``/``MPI_Pready``): one all-reduce a partition, issued
  in index order as the partitions become ready, with an optional
  chunk-wise continuation (the schedule under
  :class:`repro_torch.optim.grad_sync.PartitionedGradSync`).

* :func:`all_gather_matmul` / :func:`matmul_reduce_scatter` — the FSDP
  weight gather and the tensor-parallel output scatter fused into a ring of
  matmuls.  As in the reference, no model calls them: ``overlap_fsdp``
  only names them, and stays a no-op.
* :func:`merge_partial_attention` — the exact softmax merge of attention
  over a sequence-sharded KV cache (the sharded decode of
  :mod:`repro_torch.models.attention`).
* :func:`halo_exchange` — the cart stencil's boundary exchange.
* :func:`pipeline_spmd` — the microbatch schedule over a cart ``stage``
  dim, under the trainer's pipeline plan; differentiable.

The ring schedules, their futures and their partitioned forms run eagerly
or inside a captured CUDA graph: their point-to-point exchanges replay bit
for bit as the eager ones on four H100s with NCCL's registration of
captured buffers off, as a cuda session sets it
(``tools/shard_ranks.py --capture``'s ``capture_ring_schedules``; ROADMAP
A item 2).  Every rank of the communicator makes the same calls in the same
order; a deferred future (the gather's, the reduce-scatter's, a fused
continuation's) exchanges when it is waited, so every rank waits them in
the same order.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import collectives, errors, topology
from repro_torch.core.communicator import Communicator
from repro_torch.core.compress import BLOCK
from repro_torch.core.descriptors import CollectiveSpec, Compression, ReduceOp
from repro_torch.core.futures import DeferredFuture, Future, PartitionedRequest, when_all
from repro_torch.kernels.quant import ops as quant


def _ring_perm(n: int, offset: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + offset) % n) for i in range(n)]


def _axis(comm: Communicator) -> tuple[str, int]:
    errors.check(
        len(comm.axis_names) == 1,
        errors.ErrorClass.ERR_TOPOLOGY,
        "ring schedules need a single-axis communicator (comm.split(axis))",
    )
    name = comm.axis_names[0]
    return name, comm.axis_size(name)


# ---------------------------------------------------------------------------
# ring all-gather / reduce-scatter
# ---------------------------------------------------------------------------


def ring_all_gather(comm: Communicator, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
    """All-gather decomposed into ``n-1`` ring steps (tiled concat along
    ``axis``): at each step every rank passes the block it last received to
    the next rank and files the one it gets under its source."""

    _, n = _axis(comm)
    if n == 1:
        return x
    idx = comm.rank()
    blocks = [None] * n
    blocks[idx] = chunk = x
    for step in range(1, n):
        chunk = collectives.send_recv(comm, chunk, _ring_perm(n))
        blocks[(idx - step) % n] = chunk
    return torch.cat(blocks, dim=axis)


def ring_all_gather_bidirectional(comm: Communicator, x: torch.Tensor, *,
                                  axis: int = 0) -> torch.Tensor:
    """Bidirectional ring: halves the steps by sending both ways (each
    step's two exchanges are issued together, so both directions of every
    link carry a block at once)."""

    _, n = _axis(comm)
    if n == 1:
        return x
    idx = comm.rank()
    blocks = [None] * n
    blocks[idx] = fwd = bwd = x
    steps_fwd, steps_bwd = n // 2, (n - 1) // 2
    for step in range(1, steps_fwd + 1):
        f = collectives.send_recv_start(comm, fwd, _ring_perm(n, +1))
        b = collectives.send_recv_start(comm, bwd, _ring_perm(n, -1)) if step <= steps_bwd \
            else None
        blocks[(idx - step) % n] = fwd = f.get()
        if b is not None:
            blocks[(idx + step) % n] = bwd = b.get()
    return torch.cat(blocks, dim=axis)


def ring_reduce_scatter(comm: Communicator, x: torch.Tensor, *, axis: int = 0) -> torch.Tensor:
    """Reduce-scatter decomposed into a ring of exchange + add steps: the
    sum of block ``b`` starts at rank ``b+1`` and gathers one rank's block
    a step, in the reference's order."""

    _, n = _axis(comm)
    if n == 1:
        return x
    idx = comm.rank()
    errors.check(
        x.shape[axis] % n == 0,
        errors.ErrorClass.ERR_COUNT,
        f"ring_reduce_scatter axis {axis} of {tuple(x.shape)} not divisible by {n}",
    )
    block = x.shape[axis] // n

    def take(b):
        return x.narrow(axis, b * block, block)

    acc = take((idx - 1) % n)
    for step in range(n - 1):
        acc = collectives.send_recv(comm, acc, _ring_perm(n))
        acc = acc + take((idx - 2 - step) % n)
    return acc


def ring_rotate_compute(rotate, buf, steps: int, step_fn, carry):
    """Double-buffered rotate-while-compute: ``rotate(buf)`` issues the
    exchange that brings the next buffer and returns a
    :class:`~repro_torch.core.futures.Future` over it (e.g.
    ``cart.shift_exchange(buf, dim, 1)``); ``step_fn(carry, buf, step)``
    folds the current buffer into the carry.  Each round issues the
    rotation of step ``i+1`` *before* step ``i``'s compute, into a second
    buffer, and joins the two with :func:`when_all` — the ``MPI_Isend`` /
    compute / ``MPI_Waitall`` triangle.  The last step rotates nothing:
    ``steps`` buffers cost ``steps - 1`` exchanges.
    """

    errors.check(
        steps >= 1,
        errors.ErrorClass.ERR_COUNT,
        f"ring schedule needs >= 1 step, got {steps}",
    )
    for step in range(steps):
        if step < steps - 1:
            in_flight = rotate(buf)
            compute = Future(step_fn(carry, buf, step), works=())
            carry, buf = when_all([compute, in_flight]).get()
        else:
            carry = step_fn(carry, buf, step)
    return carry


def _online_block(q, k, v, m, l, acc, *, bias=None, scale):
    """One online-softmax accumulation step (fp32 state)."""

    s = torch.einsum("...qhd,...khd->...hqk", q, k).float() * scale
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("...hqk,...khd->...qhd", p.to(v.dtype), v).float()
    acc_new = acc * corr.transpose(-1, -2)[..., None] + pv
    return m_new, l_new, acc_new


def ring_attention(
    comm: Communicator,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Sequence-parallel attention: KV blocks circulate a ring while each
    rank holds its Q shard; online softmax keeps state O(local).

    Shapes: ``q``(b, sq, h, d), ``k``/``v``(b, sk, hk, d) — this rank's
    shards of a sequence of ``n × s``.  GQA is handled by repeating KV
    heads.  Returns the local output shard (b, sq, h, d).
    """

    _, n = _axis(comm)
    idx = comm.rank()
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=2)
        v = v.repeat_interleave(h // hk, dim=2)

    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    q_pos = idx * sq + torch.arange(sq, device=q.device)

    def rotate(kv):
        # one exchange per step: K and V travel as a single stacked buffer
        return collectives.send_recv_start(comm, kv, _ring_perm(n))

    def step_fn(carry, kv, step):
        m, l, acc = carry
        src = (idx - step) % n
        k_pos = src * sk + torch.arange(sk, device=q.device)
        bias = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            bias = torch.where(mask, 0.0, -math.inf)[None, None]  # (1,1,sq,sk)
        return _online_block(q, kv[0], kv[1], m, l, acc, bias=bias, scale=scale)

    m, l, acc = ring_rotate_compute(rotate, torch.stack([k, v]), n, step_fn, (m, l, acc))
    norm = l.clamp_min(1e-30).transpose(1, 2)[..., None]  # (b,sq,h,1)
    return (acc / norm).to(q.dtype)


def hierarchical_allreduce(
    x: torch.Tensor,
    inner: Communicator,
    outer: Communicator,
    *,
    compression: Compression = Compression.NONE,
) -> torch.Tensor:
    """All-reduce factored as RS(inner) → AR(outer) → AG(inner).

    ``inner`` is the fast fabric, ``outer`` the slow one.  The outer stage
    moves ``1/inner_size`` of the payload (padded with zeros to
    ``inner_size`` blocks of :data:`~repro_torch.core.compress.BLOCK`);
    with :data:`Compression.INT8` (and more than one outer rank) it moves
    ~1/4 of *that*: each rank's share is quantized in blocks (on the card
    by the int8 row kernel), the payloads and scales are all-gathered over
    ``outer``, and the dequantized shares are summed in fp32 in rank order
    0..n-1, as the reference sums them.  Callers keep the error feedback
    (:mod:`repro_torch.optim.grad_sync`).
    """

    ni = inner.size()
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1)
    pad = (-flat.numel()) % (ni * BLOCK)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    rs = collectives.reduce_scatter(inner, flat)
    if compression is Compression.INT8 and outer.size() > 1:
        q, scale, qpad = quant.quantize_int8(rs)
        stacked = CollectiveSpec(tiled=False)
        qg = collectives.allgather(outer, q, spec=stacked)
        sg = collectives.allgather(outer, scale, spec=stacked)
        acc = torch.zeros(rs.shape, dtype=torch.float32, device=rs.device)
        for r in range(qg.shape[0]):
            acc = acc + quant.dequantize_int8(qg[r], sg[r], qpad, rs.shape, torch.float32)
        red = acc.to(dtype)
    else:
        red = collectives.allreduce(outer, rs)
    full = collectives.allgather(inner, red)
    if pad:
        full = full[:-pad]
    return full.reshape(shape)


def _partitioned(num_partitions: int, reduce_one, continuation) -> PartitionedRequest:
    """A started :class:`PartitionedRequest` whose partition ``i``, once
    issued, reduces its payload with ``reduce_one`` and applies the
    optional chunk-wise ``continuation(i, reduced)``."""

    def fn(i, x):
        y = reduce_one(x)
        return continuation(i, y) if continuation is not None else y

    return PartitionedRequest(fn, num_partitions).start()


def partitioned_allreduce(comm: Communicator, num_partitions: int, *,
                          continuation=None) -> PartitionedRequest:
    """All-reduce split into independently ready partitions.

    Each partition is a full all-reduce over its own payload (the same as
    reducing the concatenation), issued in index order once it and every
    partition before it are ready, so the partitions can be marked ready as
    their producers finish: per-bucket gradient reduction beside a
    still-running backward pass is this schedule."""

    return _partitioned(num_partitions, lambda x: collectives.allreduce(comm, x), continuation)


def partitioned_ring_reduce_scatter(comm: Communicator, num_partitions: int, *, axis: int = 0,
                                    continuation=None) -> PartitionedRequest:
    """Reduce-scatter rings, one a partition, issued in index order."""

    return _partitioned(num_partitions, lambda x: ring_reduce_scatter(comm, x, axis=axis),
                        continuation)


def partitioned_ring_all_gather(comm: Communicator, num_partitions: int, *, axis: int = 0,
                                continuation=None) -> PartitionedRequest:
    """All-gather rings, one a partition, issued in index order."""

    return _partitioned(num_partitions, lambda x: ring_all_gather(comm, x, axis=axis),
                        continuation)


# ---------------------------------------------------------------------------
# fused compute/communication schedules
# ---------------------------------------------------------------------------


def all_gather_matmul(comm: Communicator, x: torch.Tensor, w_shard: torch.Tensor, *,
                      accumulate_dtype=torch.float32) -> torch.Tensor:
    """``x @ all_gather(w_shard)`` without materialising the gather.

    ``w_shard``: this rank's ``(k/n, f)`` block of a ``(k, f)`` weight whose
    contraction dim is sharded over the communicator.  Each ring step
    matmuls the matching ``k``-slice of ``x`` against the block in flight
    (the next block's exchange is issued before the product is queued);
    the products are summed in ``accumulate_dtype`` in ring order."""

    _, n = _axis(comm)
    idx = comm.rank()
    kb = w_shard.shape[0]
    errors.check(
        x.shape[-1] == kb * n,
        errors.ErrorClass.ERR_COUNT,
        f"contraction mismatch: x has k={x.shape[-1]}, shards give {kb * n}",
    )

    def mm(b, wb):
        return torch.matmul(x.narrow(-1, b * kb, kb), wb).to(accumulate_dtype)

    w_cur = w_shard
    nxt = collectives.shift_start(comm, w_cur) if n > 1 else None
    acc = mm(idx, w_cur)
    for step in range(1, n):
        w_cur = nxt.get()
        if step + 1 < n:
            nxt = collectives.shift_start(comm, w_cur)
        acc = acc + mm((idx - step) % n, w_cur)
    return acc


def matmul_reduce_scatter(comm: Communicator, x: torch.Tensor, w: torch.Tensor, *,
                          accumulate_dtype=torch.float32) -> torch.Tensor:
    """``reduce_scatter(x @ w, axis=-1)`` with the matmul chunked into the
    ring, so each partial block is computed just in time for its hop.

    ``x``: ``(..., k_local)`` (each rank holds a partial sum), ``w``:
    ``(k_local, f)``.  Returns this rank's ``(..., f/n)`` block of the
    fully reduced product."""

    _, n = _axis(comm)
    idx = comm.rank()
    f = w.shape[-1]
    errors.check(
        f % n == 0,
        errors.ErrorClass.ERR_COUNT,
        f"output dim {f} not divisible by communicator size {n}",
    )
    fb = f // n

    def partial_block(b):
        return torch.matmul(x, w.narrow(1, b * fb, fb)).to(accumulate_dtype)

    acc = partial_block((idx - 1) % n)
    for step in range(n - 1):
        acc = collectives.shift(comm, acc)
        acc = acc + partial_block((idx - 2 - step) % n)
    return acc


# ---------------------------------------------------------------------------
# immediate (future-returning) forms
# ---------------------------------------------------------------------------


class RingAllGatherFuture(DeferredFuture):
    """Future over a decomposed all-gather whose continuation may fuse.

    ``get()`` runs the plain ring gather (:func:`ring_all_gather`);
    ``then_matmul(x_full)`` — the continuation the paper chains with
    ``.then`` — *never* gathers and runs :func:`all_gather_matmul` instead.
    Both are deferred: they exchange when waited."""

    def __init__(self, comm: Communicator, x: torch.Tensor, axis: int = 0):
        super().__init__(lambda: ring_all_gather(comm, x, axis=axis))
        self._comm = comm
        self._x = x

    def then_matmul(self, x_full: torch.Tensor, **kw) -> DeferredFuture:
        """Fused continuation: ``x_full @ gathered`` (this future's payload
        is the contraction-sharded weight)."""

        return DeferredFuture(lambda: all_gather_matmul(self._comm, x_full, self._x, **kw))


def immediate_all_gather(comm: Communicator, x: torch.Tensor, *,
                         axis: int = 0) -> RingAllGatherFuture:
    return RingAllGatherFuture(comm, x, axis=axis)


def immediate_all_reduce(comm: Communicator, x: torch.Tensor) -> Future:
    return Future(collectives.allreduce(comm, x))


def immediate_reduce_scatter(comm: Communicator, x: torch.Tensor, *,
                             axis: int = 0) -> DeferredFuture:
    return DeferredFuture(lambda: ring_reduce_scatter(comm, x, axis=axis))


def immediate_send_recv(comm: Communicator, x, perm) -> Future:
    return collectives.send_recv_start(comm, x, perm)


# ---------------------------------------------------------------------------
# attention combiners (sequence-sharded KV)
# ---------------------------------------------------------------------------


def merge_partial_attention(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                            comm: Communicator) -> torch.Tensor:
    """Flash-decoding combine across a sequence-sharded KV cache.

    Each rank attended over its KV shard, giving the normalised output
    ``o`` (..., q, h, d), running max ``m`` (..., h, q) and normaliser
    ``l`` (..., h, q).  The exact global softmax comes back with one max
    and two sum all-reduces of O(batch·heads) payload."""

    gm = collectives.allreduce(comm, m, op=ReduceOp.MAX)
    l_corr = l * torch.exp(m - gm)                        # (..., h, q)
    w = l_corr.transpose(-1, -2)[..., None]               # (..., q, h, 1)
    num = collectives.allreduce(comm, o * w)
    den = collectives.allreduce(comm, w)
    return num / torch.clamp(den, min=1e-30)


# ---------------------------------------------------------------------------
# cart schedules: the halo exchange and the pipeline
# ---------------------------------------------------------------------------


def halo_exchange(cart, x: torch.Tensor, *, dim: int = 0, axis: int = 0,
                  width: int = 1) -> Future:
    """Cartesian halo exchange (the ch. 8 stencil idiom): send the ``width``
    boundary slices of ``x`` (tensor dimension ``axis``) to the ∓ neighbors
    along cart dimension ``dim``; a :class:`Future` over ``(from_minus,
    from_plus)`` — the neighbor boundary slices this rank receives (zeros
    beyond a non-periodic edge, the :data:`~repro_torch.core.topology.
    PROC_NULL` convention).  Both exchanges are issued before it returns,
    so interior compute queued before ``get()`` overlaps them."""

    errors.check(
        0 < width <= x.shape[axis],
        errors.ErrorClass.ERR_COUNT,
        f"halo width {width} invalid for array dim of size {x.shape[axis]}",
    )
    hi = x.narrow(axis, x.shape[axis] - width, width)
    lo = x.narrow(axis, 0, width)
    # my high boundary travels +1 and becomes the + rank's from_minus
    from_minus = cart.shift_exchange(hi, dim, 1)
    from_plus = cart.shift_exchange(lo, dim, -1)
    return when_all([from_minus, from_plus])


class _Join(torch.autograd.Function):
    """``a`` itself, with ``b`` joined to its autograd graph: ``b`` gets a
    zero cotangent.  It keeps a rank's stage-boundary shifts on the graph
    its backward walks (see :func:`pipeline_spmd`)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.b_meta = (b.shape, b.dtype, b.device)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.b_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


def pipeline_spmd(cart, *, stage_dim: int, num_microbatches: int, inject, stage_fn,
                  extract) -> list:
    """Pipeline-parallel microbatch schedule over a cart ``stage`` dim.

    At tick ``t`` this stage applies its layers to the microbatch in flight
    (microbatch ``t - stage``, when there is one), then the activation
    moves one stage down through the ``cart_shift(+1)`` exchange (the
    first stage's source is :data:`~repro_torch.core.topology.PROC_NULL`).
    Microbatch ``m`` enters stage 0 at tick ``m`` and drains from stage
    ``S-1`` at tick ``m + S - 1``: ``M + S - 1`` ticks, the ``S-1``-tick
    bubble of a forward pipeline.  Every rank calls the shift at every
    tick, as the reference's loop does, so that no send waits for a
    receive never posted; a stage with no microbatch in flight skips its
    compute (the reference computes on values that never reach a result).

    * ``inject(m)`` → the stage-0 input for microbatch ``m`` (called on
      stage 0; the other stages call ``inject(0)`` once, for the
      activation's shape);
    * ``stage_fn(state, t)`` → this stage's layers on the activation;
    * ``extract(m, state, is_last)`` → called once per drained microbatch,
      on every rank, with ``is_last`` a host bool (this rank is the final
      stage); its results are returned in microbatch order.  Callers
      return a zero where ``is_last`` is false and sum over the stage axis.

    Differentiable (the shift is :func:`~repro_torch.core.topology.
    shift_differentiable`): the backward walks the ticks in reverse on
    every rank, each shift sending its cotangent one stage back.  For every
    rank to take each shift's backward, in the same order, the activation
    is one autograd chain through the ticks: a later stage's first state is
    a zero joined to ``inject(0)``, stage 0 joins each received (zero)
    state to the microbatch it injects, and the last state joins the last
    result.
    """

    dims = cart.dims
    errors.check(
        0 <= stage_dim < len(dims),
        errors.ErrorClass.ERR_DIMS,
        f"stage_dim {stage_dim} out of range for cart dims {dims}",
    )
    errors.check(
        num_microbatches >= 1,
        errors.ErrorClass.ERR_COUNT,
        f"pipeline needs >= 1 microbatch, got {num_microbatches}",
    )
    errors.check(
        not cart.periods[stage_dim],
        errors.ErrorClass.ERR_TOPOLOGY,
        "the pipeline stage dim must be non-periodic (activations drain at "
        "the last stage; a periodic shift would wrap them into stage 0)",
    )
    s = dims[stage_dim]
    stage = cart.cart_coords(cart.rank())[stage_dim]
    is_first, is_last = stage == 0, stage == s - 1
    m = num_microbatches
    grad = torch.is_grad_enabled()

    def join(a, b):
        return _Join.apply(a, b) if grad and b.requires_grad else a

    state = inject(0)
    if not is_first:
        state = join(torch.zeros_like(state), state)
    outs = []
    for t in range(m + s - 1):
        if is_first and 0 < t < m:
            state = join(inject(t), state)
        if 0 <= t - stage < m:
            state = stage_fn(state, t)
        out_t = t - (s - 1)
        if out_t >= 0:
            outs.append(extract(out_t, state, is_last))
        if t < m + s - 2:
            state = topology.shift_differentiable(cart, state, stage_dim, 1)
    outs[-1] = join(outs[-1], state) if isinstance(outs[-1], torch.Tensor) else outs[-1]
    return outs
