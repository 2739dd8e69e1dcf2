"""Blocking collectives (paper §II, C1 — MPI 4.0 chapters 5–6) over
``torch.distributed``, the eager counterpart of :mod:`repro.core.
collectives`.

Every rank calls a collective with its own value: a tensor or a nest of
tensors (dicts, lists, tuples), handled leaf by leaf on the communicator's
process group.  The semantics are the reference's, including its
divergences from MPI: rooted collectives (``broadcast``, ``reduce``,
``gather``) leave the result on every rank; the vector variants take
per-rank static counts over padded buffers; ``send_recv`` takes a static
pairing and ranks that receive from no one get zeros.  The reductions use
the same :class:`~repro_torch.core.descriptors.ReduceOp` values: SUM, MAX
and MIN reduce on the wire, the logical ones through integer sums, maxima
and minima, and PROD and the bitwise family fold the gathered values with
:func:`combine`, as the reference's gather-based fallbacks do.  Errors
raise the same classes (``ERR_ROOT``, ``ERR_COUNT``, ``ERR_TRUNCATE``,
``ERR_OP``, ``ERR_RANK``).

A communicator whose members have no process group behind them (bare
devices of one process) has one rank, and every collective returns a copy
of its input.  The aggregate packing of the reference (one buffer per
dtype group) is not ported: an aggregate is moved leaf by leaf, so
``reduce_scatter`` of an aggregate returns the scattered leaves rather than
packed buffers.
"""

from __future__ import annotations

import functools
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import errors
from repro_torch.core.communicator import Communicator
from repro_torch.core.descriptors import CollectiveSpec, ReduceOp, resolve
from repro_torch.core.futures import Future, flatten, unflatten

_WIRE_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN}


def _check_root(comm: Communicator, root: int) -> None:
    errors.check(
        0 <= int(root) < comm.size(),
        errors.ErrorClass.ERR_ROOT,
        f"root {root} out of range for communicator of size {comm.size()}",
    )


def _single_axis(comm: Communicator) -> str:
    errors.check(
        len(comm.axis_names) == 1,
        errors.ErrorClass.ERR_TOPOLOGY,
        "this operation requires a single-axis communicator; use comm.split()",
    )
    return comm.axis_names[0]


def _leafwise(fn, value: Any) -> Any:
    leaves, treedef = flatten(value)
    return unflatten(treedef, [fn(torch.as_tensor(x)) for x in leaves])


def _local(comm: Communicator) -> bool:
    """No process group behind the members: one rank, no wire."""

    return comm.process_group() is None


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def _gather_list(comm: Communicator, x: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``x``, in communicator rank order."""

    if _local(comm):
        return [x.clone()]
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(comm.size())]
    dist.all_gather(parts, wire, group=comm.process_group())
    # a process group orders its ranks by global rank
    ranks = comm.global_ranks()
    by_rank = dict(zip(sorted(ranks), parts))
    parts = [by_rank[r] for r in ranks]
    return [p.to(torch.bool) for p in parts] if x.dtype == torch.bool else parts


def _all_reduce(comm: Communicator, x: torch.Tensor, op: dist.ReduceOp) -> torch.Tensor:
    out = x.clone().contiguous()
    if not _local(comm):
        dist.all_reduce(out, op=op, group=comm.process_group())
    return out


# ---------------------------------------------------------------------------
# reduction kernels
# ---------------------------------------------------------------------------


def combine(op: ReduceOp, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand combine for a :class:`ReduceOp` — the binary form the
    gather-based fallbacks fold with.  Logical ops return booleans; callers
    preserve buffer dtypes themselves."""

    if op is ReduceOp.SUM:
        return a + b
    if op is ReduceOp.PROD:
        return a * b
    if op is ReduceOp.MAX:
        return torch.maximum(a, b)
    if op is ReduceOp.MIN:
        return torch.minimum(a, b)
    if op is ReduceOp.LAND:
        return (a != 0) & (b != 0)
    if op is ReduceOp.LOR:
        return (a != 0) | (b != 0)
    if op is ReduceOp.LXOR:
        return (a != 0) ^ (b != 0)
    if op is ReduceOp.BAND:
        return torch.bitwise_and(a, b)
    if op is ReduceOp.BOR:
        return torch.bitwise_or(a, b)
    if op is ReduceOp.BXOR:
        return torch.bitwise_xor(a, b)
    errors.fail(errors.ErrorClass.ERR_OP, f"{op} has no two-operand combine")


def _reduce_array(comm: Communicator, x: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    if op is ReduceOp.SUM and x.dtype == torch.bool:
        return _all_reduce(comm, x.to(torch.int32), dist.ReduceOp.SUM) > 0
    if op in _WIRE_OPS:
        return _all_reduce(comm, x, _WIRE_OPS[op])
    if op is ReduceOp.LAND:
        return _all_reduce(comm, (x != 0).to(torch.int32), dist.ReduceOp.MIN) != 0
    if op is ReduceOp.LOR:
        return _all_reduce(comm, (x != 0).to(torch.int32), dist.ReduceOp.MAX) != 0
    if op is ReduceOp.LXOR:
        return (_all_reduce(comm, (x != 0).to(torch.int32), dist.ReduceOp.SUM) % 2) != 0
    # gather-based fallbacks (PROD and the bitwise family)
    if op in (ReduceOp.PROD, ReduceOp.BAND, ReduceOp.BOR, ReduceOp.BXOR):
        return functools.reduce(functools.partial(combine, op), _gather_list(comm, x))
    errors.fail(errors.ErrorClass.ERR_OP, f"unsupported reduction {op}")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def broadcast(comm: Communicator, value: Any, root: int = 0, spec: CollectiveSpec | None = None):
    """``MPI_Bcast``: every rank receives root's value."""

    _check_root(comm, root)

    def bcast_leaf(x):
        out = x.clone().contiguous()
        if not _local(comm):
            dist.broadcast(out, src=comm.global_ranks()[root], group=comm.process_group())
        return out

    return _leafwise(bcast_leaf, value)


def allreduce(
    comm: Communicator,
    value: Any,
    op: ReduceOp = ReduceOp.SUM,
    spec: CollectiveSpec | None = None,
):
    """``MPI_Allreduce``."""

    spec = resolve(spec, op=op)
    return _leafwise(lambda x: _reduce_array(comm, x, spec.op), value)


def reduce(
    comm: Communicator,
    value: Any,
    root: int = 0,
    op: ReduceOp = ReduceOp.SUM,
    spec: CollectiveSpec | None = None,
):
    """``MPI_Reduce``.  The result is replicated (stronger than MPI's
    root-only guarantee, as in the reference)."""

    _check_root(comm, root)
    return allreduce(comm, value, op=op, spec=spec)


def _block(x: torch.Tensor, axis: int, n: int, i: int) -> torch.Tensor:
    size = x.shape[axis] // n
    return x.narrow(axis, i * size, size)


def _check_divisible(x: torch.Tensor, axis: int, n: int, what: str) -> None:
    errors.check(
        x.dim() > axis and x.shape[axis] % n == 0,
        errors.ErrorClass.ERR_COUNT,
        f"{what} axis {axis} of shape {tuple(x.shape)} not divisible by {n}",
    )


def reduce_scatter(
    comm: Communicator,
    value: Any,
    op: ReduceOp = ReduceOp.SUM,
    spec: CollectiveSpec | None = None,
):
    """``MPI_Reduce_scatter_block``: reduce, then rank ``i`` keeps block
    ``i`` of dim ``spec.axis`` (an all-reduce and a slice on the wire)."""

    spec = resolve(spec, op=op)
    errors.check(
        spec.op is ReduceOp.SUM,
        errors.ErrorClass.ERR_OP,
        "reduce_scatter lowers to psum-scatter; only SUM is supported",
    )
    n = comm.size()

    def rs_leaf(x):
        _check_divisible(x, spec.axis, n, "reduce_scatter")
        full = _reduce_array(comm, x, ReduceOp.SUM)
        return _block(full, spec.axis, n, comm.rank()).contiguous()

    return _leafwise(rs_leaf, value)


def allgather(comm: Communicator, value: Any, spec: CollectiveSpec | None = None):
    """``MPI_Allgather``: concatenate (``tiled``) or stack ranks' values."""

    spec = resolve(spec)

    def ag_leaf(x):
        parts = _gather_list(comm, x)
        return torch.cat(parts, dim=spec.axis) if spec.tiled else torch.stack(parts, spec.axis)

    return _leafwise(ag_leaf, value)


def gather(comm: Communicator, value: Any, root: int = 0, spec: CollectiveSpec | None = None):
    """``MPI_Gather`` (result replicated, as in the reference)."""

    _check_root(comm, root)
    return allgather(comm, value, spec=spec)


def scatter(comm: Communicator, value: Any, root: int = 0, spec: CollectiveSpec | None = None):
    """``MPI_Scatter``: rank ``i`` receives root's ``i``-th block along
    ``spec.axis`` (a broadcast of root's value and a slice on the wire)."""

    _check_root(comm, root)
    spec = resolve(spec)
    n = comm.size()

    def sc_leaf(x):
        _check_divisible(x, spec.axis, n, "scatter")
        full = broadcast(comm, x, root)
        return _block(full, spec.axis, n, comm.rank()).contiguous()

    return _leafwise(sc_leaf, value)


def _alltoall_array(comm: Communicator, x: torch.Tensor, split_axis: int, concat_axis: int):
    n = comm.size()
    blocks = list(torch.chunk(x, n, dim=split_axis)) if n > 1 else [x]
    if _local(comm):
        received = [b.clone() for b in blocks]
    else:
        # block j goes to rank j; the wire orders ranks by global rank
        ranks = comm.global_ranks()
        order = sorted(range(n), key=lambda j: ranks[j])
        send = torch.stack([blocks[j] for j in order]).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=comm.process_group())
        by_pos = dict(zip(order, recv.unbind(0)))
        received = [by_pos[j] for j in range(n)]
    return torch.cat(received, dim=concat_axis)


def alltoall(
    comm: Communicator,
    value: Any,
    split_axis: int = 0,
    concat_axis: int = 0,
    spec: CollectiveSpec | None = None,
):
    """``MPI_Alltoall``."""

    n = comm.size()

    def a2a_leaf(x):
        errors.check(
            x.shape[split_axis] % n == 0,
            errors.ErrorClass.ERR_COUNT,
            f"alltoall split axis {split_axis} of {tuple(x.shape)} not divisible by {n}",
        )
        return _alltoall_array(comm, x, split_axis, concat_axis)

    return _leafwise(a2a_leaf, value)


# -- vector (ragged) variants ------------------------------------------------


def allgatherv(comm: Communicator, value: torch.Tensor, counts: Sequence[int]):
    """``MPI_Allgatherv``: per-rank leading-dim counts.  Each rank passes a
    buffer padded to ``max(counts)``; its valid prefix is ``counts[rank]``.
    Returns the tight concatenation (``sum(counts)`` rows)."""

    n = comm.size()
    errors.check(
        len(counts) == n,
        errors.ErrorClass.ERR_COUNT,
        f"counts has {len(counts)} entries for {n} ranks",
    )
    cmax = max(counts)
    x = torch.as_tensor(value)
    errors.check(
        x.shape[0] == cmax,
        errors.ErrorClass.ERR_TRUNCATE,
        f"allgatherv buffers must be padded to max(counts)={cmax}, got {x.shape[0]}",
    )
    parts = _gather_list(comm, x)
    return torch.cat([parts[r][: counts[r]] for r in range(n)], dim=0)


def alltoallv(comm: Communicator, value: torch.Tensor, send_counts: Sequence[int]):
    """``MPI_Alltoallv`` with a symmetric count row (each rank sends
    ``send_counts[j]`` items to rank ``j``, padded blocks of
    ``max(counts)``).  Returns ``(received, recv_counts)``: the tight
    concatenation of the valid prefixes received from every peer."""

    n = comm.size()
    errors.check(
        len(send_counts) == n,
        errors.ErrorClass.ERR_COUNT,
        f"send_counts has {len(send_counts)} entries for {n} ranks",
    )
    cmax = max(send_counts)
    x = torch.as_tensor(value)
    errors.check(
        x.shape[0] == n * cmax,
        errors.ErrorClass.ERR_TRUNCATE,
        f"alltoallv buffer must be (n*max_count, ...) = {n * cmax}, got {x.shape[0]}",
    )
    swapped = _alltoall_array(comm, x, 0, 0)
    blocks = swapped.reshape((n, cmax) + tuple(swapped.shape[1:]))
    pieces = [blocks[r, : send_counts[r]] for r in range(n)]
    return torch.cat(pieces, dim=0), tuple(send_counts)


# -- prefix reductions --------------------------------------------------------


def scan(comm: Communicator, value: torch.Tensor, op: ReduceOp = ReduceOp.SUM):
    """``MPI_Scan`` (inclusive prefix reduction over ranks)."""

    return _prefix(comm, value, op, inclusive=True)


def exscan(comm: Communicator, value: torch.Tensor, op: ReduceOp = ReduceOp.SUM):
    """``MPI_Exscan`` (exclusive; rank 0 receives the identity)."""

    return _prefix(comm, value, op, inclusive=False)


def _type_min(dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point else torch.iinfo(dtype).min


def _type_max(dtype):
    return torch.finfo(dtype).max if dtype.is_floating_point else torch.iinfo(dtype).max


def _prefix(comm: Communicator, value: torch.Tensor, op: ReduceOp, inclusive: bool):
    errors.check(
        op in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.PROD),
        errors.ErrorClass.ERR_OP,
        f"scan does not support {op}",
    )
    x = torch.as_tensor(value)
    g = torch.stack(_gather_list(comm, x))  # (n, ...)
    n = comm.size()
    steps = torch.arange(n, device=x.device).reshape((n,) + (1,) * x.dim())
    keep = steps < (comm.rank() + 1 if inclusive else comm.rank())
    if op is ReduceOp.SUM:
        return torch.where(keep, g, torch.zeros_like(g)).sum(dim=0).to(x.dtype)
    if op is ReduceOp.PROD:
        return torch.where(keep, g, torch.ones_like(g)).prod(dim=0).to(x.dtype)
    if op is ReduceOp.MAX:
        return torch.where(keep, g, torch.full_like(g, _type_min(x.dtype))).amax(dim=0)
    return torch.where(keep, g, torch.full_like(g, _type_max(x.dtype))).amin(dim=0)


# -- point-to-point -----------------------------------------------------------


def exchange(value: Any, *, me: int, src: int | None, dst: int | None,
             ranks: Sequence[int], group) -> Future:
    """One rank's side of a pairwise exchange, as one
    ``dist.batch_isend_irecv``: send ``value`` (a tensor or a nest of
    tensors) to ``dst`` and receive from ``src`` (flat ranks into
    ``ranks``, the global ranks; ``None`` for no partner).  Returns a
    :class:`Future` over the received value: zeros when there is no source,
    ``value`` itself when this rank is its own source (PyTorch refuses a
    send to one's own rank).  Receive buffers are allocated here,
    contiguous, as gloo needs them."""

    leaves, treedef = flatten(value)
    ops, received = [], []
    for x in leaves:
        x = torch.as_tensor(x).contiguous()
        if src is None:
            received.append(torch.zeros_like(x))
        elif src == me:
            received.append(x.clone())
        else:
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, buf, ranks[src], group))
            received.append(buf)
        if dst is not None and dst != me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst], group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Future(unflatten(treedef, received), works)


def send_recv_start(comm: Communicator, value: Any, perm: Sequence[tuple[int, int]]) -> Future:
    """Issue a matched ``MPI_Sendrecv`` — rank ``s`` sends to ``d`` for
    each ``(s, d)`` pair — without waiting: a :class:`Future` over the
    received value (zeros on a rank that receives from no one)."""

    _single_axis(comm)
    n = comm.size()
    for s, d in perm:
        errors.check(
            0 <= s < n and 0 <= d < n,
            errors.ErrorClass.ERR_RANK,
            f"send_recv pair ({s}, {d}) out of range for size {n}",
        )
    srcs = [s for s, _ in perm]
    errors.check(
        len(set(srcs)) == len(srcs),
        errors.ErrorClass.ERR_RANK,
        "a rank may send to at most one destination per send_recv",
    )
    me = comm.rank()
    return exchange(value, me=me,
                    src=next((s for s, d in perm if d == me), None),
                    dst=next((d for s, d in perm if s == me), None),
                    ranks=comm.global_ranks(), group=comm.process_group())


def send_recv(comm: Communicator, value: Any, perm: Sequence[tuple[int, int]]):
    """Matched ``MPI_Sendrecv`` (blocking form of :func:`send_recv_start`)."""

    return send_recv_start(comm, value, perm).get()


def shift_start(comm: Communicator, value: Any, offset: int = 1, wrap: bool = True) -> Future:
    """Issue a ring shift without waiting (see :func:`shift`)."""

    n = comm.size()
    if wrap:
        perm = [(i, (i + offset) % n) for i in range(n)]
    else:
        perm = [(i, i + offset) for i in range(n) if 0 <= i + offset < n]
    return send_recv_start(comm, value, perm)


def shift(comm: Communicator, value: Any, offset: int = 1, wrap: bool = True):
    """Ring shift (``MPI_Cart_shift`` + sendrecv): rank ``i`` sends to
    ``i + offset``."""

    return shift_start(comm, value, offset, wrap).get()


def barrier(comm: Communicator):
    """``MPI_Barrier``: a zero-byte all-reduce, the reference's token; the
    zero token comes back once every rank has entered."""

    return _all_reduce(comm, torch.zeros((), device=comm.device), dist.ReduceOp.SUM)
