"""Overlappable collective schedules (paper C3, performance side): the ring
part of :mod:`repro.core.overlap`.

MPI programs overlap communication and computation by issuing ``MPI_I*``
operations and computing until ``MPI_Wait``.  In eager PyTorch the
point-to-point exchange is issued (``dist.batch_isend_irecv``) before the
step's compute is queued, and the two are joined with
:func:`~repro_torch.core.futures.when_all`.

Contents:

* :func:`ring_rotate_compute` — the double-buffered rotate-while-compute
  schedule, the engine under ring attention
  (:mod:`repro_torch.kernels.ring_attention`).
* :func:`ring_attention` — the plain eager ring: KV blocks circulate while
  each rank holds its Q shard; the oracle of the fused ring.

Not ported yet: ``ring_all_gather``, ``all_gather_matmul``,
``hierarchical_allreduce``, ``halo_exchange``, ``pipeline_spmd`` and the
partitioned forms (``ROADMAP.md``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import collectives, errors
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import Future, when_all


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
