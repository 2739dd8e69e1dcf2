"""Virtual process topologies & neighborhood collectives (MPI 4.0 ch. 8):
:mod:`repro.core.topology` over ``torch.distributed``.

* A :class:`CartComm` is a communicator whose ranks live on a ``dims`` grid
  with per-dim periodicity.  The host-level cart arithmetic
  (:func:`cart_coords_of`, :func:`cart_rank_of`, :func:`cart_shift_tables`,
  :class:`CartShift`) is copied from the reference, which a parity test
  pins.  :meth:`CartComm.shift_exchange` moves every rank's value ``disp``
  steps along one dimension with one ``dist.batch_isend_irecv`` over that
  dimension's process group and returns a :class:`~repro_torch.core.futures.
  Future` over the pending exchange; a rank whose source is
  :data:`PROC_NULL` receives zeros, and a rank that is its own source (a
  periodic ring of one) keeps its value without any transfer — PyTorch
  refuses a send to one's own rank.
* A :class:`DistGraphComm` (``MPI_Dist_graph_create_adjacent``) carries an
  explicit, possibly weighted and asymmetric, neighbor graph, declared for
  every rank at once as the reference declares it; both endpoints of every
  edge must agree (``ERR_TOPOLOGY``).
* The **neighborhood collectives** (``neighbor_allgather``,
  ``neighbor_alltoall``, ``neighbor_alltoallv`` with static counts and the
  persistent ``neighbor_alltoall_init``) are generic over the neighbor
  structure, as the reference's :class:`_NeighborComm` engine is.  The
  reference is one SPMD program; here every rank is a process and passes
  its own block, and the lowering is the reference's matching
  decomposition: one :func:`~repro_torch.core.collectives.exchange` (one
  ``dist.batch_isend_irecv``) per matching round of the edge set, the
  arrival scattered into its in-slot on the receiver.  A cart exchanges
  along its dimensions instead (``2·ndims`` shift exchanges).  Buffers pad
  to the maximum in/out degree over ranks; ``PROC_NULL`` and absent slots
  read as zeros.  The collectives return a :class:`~repro_torch.core.
  futures.DeferredFuture`: every round is issued at the call, and the
  scatter runs when the future is waited.
* The serving fan-out helpers (:func:`serving_fanout_adjacency`,
  :func:`fanout_routes`, :func:`fanout_rounds`) are host-level and copied
  from the reference; :func:`serving_fanout_graph` builds the graph over a
  serving bridge.

The reference's analyzer hooks (``analysis_events``) are left out until
its ``analysis/`` package is ported (ROADMAP A15); ``cart_refold`` comes
with elastic epochs (A15).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import collectives, datatypes, errors, tool
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import (
    DeferredFuture,
    Future,
    PersistentCollective,
    PersistentRequest,
    argument_signature,
)
from repro_torch.core.session import CART_PSET_PREFIX, Group, RankDevice, default_session

#: ``MPI_PROC_NULL``: the non-existent neighbor beyond a non-periodic edge.
PROC_NULL = -1


# ---------------------------------------------------------------------------
# host-level cart arithmetic (testable without devices)
# ---------------------------------------------------------------------------


def cart_coords_of(dims: Sequence[int], rank: int) -> tuple[int, ...]:
    """``MPI_Cart_coords``: row-major coordinates of ``rank`` in ``dims``."""

    n = math.prod(dims)
    errors.check(
        0 <= rank < n,
        errors.ErrorClass.ERR_RANK,
        f"rank {rank} out of range for cart grid {tuple(dims)}",
    )
    return tuple(int(c) for c in np.unravel_index(rank, tuple(dims)))


def cart_rank_of(
    dims: Sequence[int], periods: Sequence[bool], coords: Sequence[int]
) -> int:
    """``MPI_Cart_rank``: periodic dims wrap; out-of-range coordinates on a
    non-periodic dim are erroneous (``ERR_RANK``, as in the standard)."""

    errors.check(
        len(coords) == len(dims),
        errors.ErrorClass.ERR_DIMS,
        f"{len(coords)} coordinates for a {len(dims)}-dim grid",
    )
    fixed = []
    for c, d, p in zip(coords, dims, periods):
        c = int(c)
        if p:
            c %= d
        errors.check(
            0 <= c < d,
            errors.ErrorClass.ERR_RANK,
            f"coordinate {c} out of range for non-periodic dim of size {d}",
        )
        fixed.append(c)
    return int(np.ravel_multi_index(tuple(fixed), tuple(dims)))


def cart_shift_tables(
    dims: Sequence[int], periods: Sequence[bool], dim: int, disp: int = 1
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """``MPI_Cart_shift``: per-rank ``(sources, destinations)`` tables.

    ``sources[r]`` is the rank whose data arrives at ``r`` under the shift
    (``MPI_Cart_shift``'s ``rank_source``), ``destinations[r]`` where ``r``'s
    data goes; :data:`PROC_NULL` beyond a non-periodic boundary.
    """

    dims = tuple(int(d) for d in dims)
    errors.check(
        0 <= dim < len(dims),
        errors.ErrorClass.ERR_DIMS,
        f"shift dimension {dim} out of range for {len(dims)}-dim grid",
    )
    n = math.prod(dims)
    srcs, dsts = [], []
    for r in range(n):
        coords = list(cart_coords_of(dims, r))

        def _neighbor(offset: int) -> int:
            c = coords[dim] + offset
            if periods[dim]:
                c %= dims[dim]
            elif not (0 <= c < dims[dim]):
                return PROC_NULL
            nc = list(coords)
            nc[dim] = c
            return int(np.ravel_multi_index(tuple(nc), dims))

        dsts.append(_neighbor(disp))
        srcs.append(_neighbor(-disp))
    return tuple(srcs), tuple(dsts)


@dataclasses.dataclass(frozen=True)
class CartShift:
    """The result of :meth:`CartComm.cart_shift`.

    * ``sources`` / ``destinations`` — host tables, rank-indexed, with
      :data:`PROC_NULL` at non-periodic boundaries (``MPI_Cart_shift``'s two
      output ranks, for every rank at once — the SPMD program needs the full
      pattern, not one rank's view).
    * ``perm`` — flat-rank ``(src, dst)`` pairs for
      :func:`repro.core.collectives.send_recv` over the whole communicator.
    * ``axis_name`` / ``axis_perm`` — the same shift as *axis-local* pairs
      over just the shifted mesh axis: ``lax.ppermute(x, axis_name,
      axis_perm)`` lowers to a subgroup ``collective-permute`` (every color
      of the other axes shifts in the same program).
    """

    dim: int
    disp: int
    sources: tuple[int, ...]
    destinations: tuple[int, ...]
    perm: tuple[tuple[int, int], ...]
    axis_name: str
    axis_perm: tuple[tuple[int, int], ...]


# ---------------------------------------------------------------------------
# graph adjacency + matching decomposition (the sparse lowering engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Edge:
    src: int
    dst: int
    out_slot: int  # position in src's destination list
    in_slot: int   # position in dst's source list


def _matching_rounds(edges: Sequence[_Edge]) -> list[list[_Edge]]:
    """Greedy edge-colouring: split the edge set into rounds where every
    rank appears at most once as a source and once as a destination — one
    pairwise exchange per rank per round.  Round count is bounded by ~max
    degree (Vizing), the sparse analogue of the dense collective's
    O(world) steps."""

    rounds: list[tuple[set, set, list[_Edge]]] = []
    for e in edges:
        for srcs, dsts, members in rounds:
            if e.src not in srcs and e.dst not in dsts:
                srcs.add(e.src)
                dsts.add(e.dst)
                members.append(e)
                break
        else:
            rounds.append(({e.src}, {e.dst}, [e]))
    return [members for _, _, members in rounds]


def _build_edges(
    sources: Sequence[Sequence[int]], destinations: Sequence[Sequence[int]]
) -> list[_Edge]:
    """Pair every declared out-edge with its matching in-edge.  Repeated
    edges pair by occurrence order (k-th ``s`` in ``sources[d]`` matches the
    k-th ``d`` in ``destinations[s]``); a declaration present on one side
    only is ``ERR_TOPOLOGY`` — both endpoints of an edge must agree, exactly
    as ``MPI_Dist_graph_create_adjacent`` requires."""

    taken: dict[tuple[int, int], int] = {}
    edges: list[_Edge] = []
    for s, dsts in enumerate(destinations):
        for out_slot, d in enumerate(dsts):
            if d == PROC_NULL:
                continue
            occurrence = taken.get((s, d), 0)
            taken[(s, d)] = occurrence + 1
            matches = [j for j, x in enumerate(sources[d]) if x == s]
            errors.check(
                occurrence < len(matches),
                errors.ErrorClass.ERR_TOPOLOGY,
                f"edge {s}->{d} declared in destinations[{s}] but rank {d} "
                f"lists only {len(matches)} in-edges from {s}",
            )
            edges.append(_Edge(s, d, out_slot, matches[occurrence]))
    # the reverse check: every declared in-edge was produced by an out-edge
    for d, srcs in enumerate(sources):
        for s in srcs:
            if s == PROC_NULL:
                continue
            declared = sum(1 for x in destinations[s] if x == d)
            listed = sum(1 for x in srcs if x == s)
            errors.check(
                declared == listed,
                errors.ErrorClass.ERR_TOPOLOGY,
                f"rank {d} lists {listed} in-edges from {s} but rank {s} "
                f"declares {declared} out-edges to {d}",
            )
    return edges


def cart_edges(
    dims: Sequence[int], periods: Sequence[bool]
) -> list[_Edge]:
    """The Cartesian neighbor edge set with its slot pairing made explicit:
    the out-slot ``2d`` (−) send lands in the receiver's + slot (``2d+1``)
    and vice versa.  The generic occurrence-order pairing of
    :func:`_build_edges` would get this wrong exactly when both slots of a
    dim name the same rank (size-2 or size-1 periodic dims),
    desynchronising the neighbor_alltoallv recv-count table from the
    physical exchange."""

    dims = tuple(int(d) for d in dims)
    n = math.prod(dims)
    edges: list[_Edge] = []
    for dim in range(len(dims)):
        sources, destinations = cart_shift_tables(dims, periods, dim, 1)
        for r in range(n):
            if destinations[r] != PROC_NULL:
                edges.append(_Edge(r, destinations[r], 2 * dim + 1, 2 * dim))
            if sources[r] != PROC_NULL:
                edges.append(_Edge(r, sources[r], 2 * dim, 2 * dim + 1))
    return edges


def _join(parts: list[tuple[int, Future]], out: torch.Tensor) -> DeferredFuture:
    """A future over ``out`` once every pending exchange of ``parts`` has
    arrived, each arrival written into its slot (``-1``: nothing to keep,
    a send's completion only)."""

    def resolve():
        for slot, fut in parts:
            got = fut.get()
            if slot >= 0:
                out[slot] = got
        return out

    return DeferredFuture(resolve, probe=lambda: all(f.test() for _, f in parts))


class _NeighborComm(Communicator):
    """Shared engine: a communicator with a neighbor structure.

    Subclasses populate ``_sources`` / ``_destinations`` (per-rank ordered
    neighbor slot lists, :data:`PROC_NULL` allowed) and the derived matching
    ``_rounds``; the neighborhood collectives below are generic over them.
    Each rank passes its own block and receives its own result.
    """

    _sources: tuple[tuple[int, ...], ...]
    _destinations: tuple[tuple[int, ...], ...]
    _rounds: list[list[_Edge]]

    # -- degrees ------------------------------------------------------------

    def indegree(self, rank: int | None = None) -> int:
        """Neighbor slots on the receive side (``PROC_NULL`` slots count:
        the buffer keeps their position, as in MPI cart neighborhoods)."""

        if rank is None:
            return max(len(s) for s in self._sources)
        return len(self._sources[rank])

    def outdegree(self, rank: int | None = None) -> int:
        if rank is None:
            return max(len(d) for d in self._destinations)
        return len(self._destinations[rank])

    # -- the exchange engine --------------------------------------------------

    def _round_tables(self):
        n = self.size()
        tables = []
        for round_edges in self._rounds:
            out_slot = np.full((n,), -1, np.int32)
            in_slot = np.full((n,), -1, np.int32)
            perm = []
            for e in round_edges:
                out_slot[e.src] = e.out_slot
                in_slot[e.dst] = e.in_slot
                perm.append((e.src, e.dst))
            tables.append((out_slot, in_slot, tuple(perm)))
        return tables

    def _check_alltoall(self, x: torch.Tensor, degree: int) -> None:
        errors.check(
            x.dim() >= 1 and x.shape[0] == degree,
            errors.ErrorClass.ERR_COUNT,
            f"neighbor_alltoall buffer needs leading dim {degree} "
            f"(max outdegree), got {tuple(x.shape)}",
        )

    def _exchange(self, x: Any, *, alltoall: bool) -> DeferredFuture:
        """One neighborhood exchange: per matching round, this rank sends
        its block (its out-slot's for alltoall, the whole buffer for
        allgather) and receives one, through one
        :func:`~repro_torch.core.collectives.exchange`; the arrival lands
        in this rank's in-slot.  ``PROC_NULL`` slots stay zero."""

        x = torch.as_tensor(x)
        if alltoall:
            self._check_alltoall(x, self.outdegree())
        block_shape = tuple(x.shape[1:] if alltoall else x.shape)
        out = torch.zeros((self.indegree(),) + block_shape, dtype=x.dtype, device=x.device)
        me, ranks, group = self._member_rank(), self.global_ranks(), self.process_group()
        parts = []
        for out_slot, in_slot, perm in self._round_tables():
            src = next((s for s, d in perm if d == me), None)
            dst = next((d for s, d in perm if s == me), None)
            if src is None and dst is None:
                continue
            send = x[max(int(out_slot[me]), 0)] if alltoall else x
            fut = collectives.exchange(send, me=me, src=src, dst=dst, ranks=ranks, group=group)
            parts.append((int(in_slot[me]) if src is not None else -1, fut))
        return _join(parts, out)

    # -- neighborhood collectives ---------------------------------------------

    def neighbor_allgather(self, value: Any) -> DeferredFuture:
        """``MPI_Neighbor_allgather``: each rank receives its in-neighbors'
        buffers, stacked ``(max_indegree, *shape)`` in neighbor-slot order
        (zeros at ``PROC_NULL`` / absent slots)."""

        tool.pvar_count("neighbor_allgather")
        return self._exchange(value, alltoall=False)

    def neighbor_alltoall(self, value: Any) -> DeferredFuture:
        """``MPI_Neighbor_alltoall``: block ``k`` of ``value`` (leading dim
        = max outdegree) goes to out-neighbor ``k``; the result's slot ``j``
        holds the block sent by in-neighbor ``j``."""

        tool.pvar_count("neighbor_alltoall")
        return self._exchange(value, alltoall=True)

    def neighbor_alltoallv(
        self, value: Any, send_counts: Sequence[Sequence[int]] | Sequence[int]
    ) -> DeferredFuture:
        """``MPI_Neighbor_alltoallv`` with static counts.

        ``send_counts`` is per-rank per-out-slot (``counts[rank][slot]``), or
        one shared per-slot row applied to every rank.  Buffers are padded
        blocks ``(max_outdegree, max_count, ...)``; the future resolves to
        ``(blocks, recv_counts)`` where ``blocks`` is the padded
        ``(max_indegree, max_count, ...)`` receive buffer (entries beyond
        the valid count zeroed) and ``recv_counts`` this rank's per-slot
        valid counts (int32).
        """

        tool.pvar_count("neighbor_alltoallv")
        n, d_out, d_in = self.size(), self.outdegree(), self.indegree()
        counts = np.asarray(send_counts, dtype=np.int64)
        if counts.ndim == 1:
            counts = np.tile(counts, (n, 1))
        errors.check(
            counts.shape == (n, d_out),
            errors.ErrorClass.ERR_COUNT,
            f"send_counts must be ({n}, {d_out}) (ranks x max outdegree), "
            f"got {counts.shape}",
        )
        errors.check(
            bool((counts >= 0).all()),
            errors.ErrorClass.ERR_COUNT,
            "send_counts must be non-negative",
        )
        cmax = int(counts.max()) if counts.size else 0
        # receive counts: slot j of rank d gets the count its in-edge's
        # source declared for the matching out-slot
        recv = np.zeros((n, d_in), np.int32)
        for round_edges in self._rounds:
            for e in round_edges:
                recv[e.dst, e.in_slot] = counts[e.src, e.out_slot]
        x = torch.as_tensor(value)
        errors.check(
            x.dim() >= 2 and tuple(x.shape[:2]) == (d_out, cmax),
            errors.ErrorClass.ERR_TRUNCATE,
            f"neighbor_alltoallv buffer must be padded to "
            f"({d_out}, {cmax}, ...), got {tuple(x.shape)}",
        )
        exchanged = self._exchange(x, alltoall=True)
        rc = torch.as_tensor(recv[self._member_rank()], device=x.device)   # (d_in,)

        def resolve():
            blocks = exchanged.get()
            valid = torch.arange(cmax, device=x.device)[None, :] < rc[:, None]
            mask = valid.reshape(valid.shape + (1,) * (blocks.dim() - 2))
            return torch.where(mask, blocks, torch.zeros_like(blocks)), rc

        return DeferredFuture(resolve, probe=exchanged.test)

    # -- persistent neighborhood collectives (MPI 4.0 §6.12 pattern) ---------

    def neighbor_alltoall_init(self, example: Any) -> PersistentCollective:
        """Persistent ``neighbor_alltoall`` (``MPI_Neighbor_alltoall_init``):
        one request per dtype bucket of ``example``'s datatype;
        ``start(value)`` re-fires them.  Aggregate buckets are split into
        ``max_outdegree`` equal chunks (``ERR_COUNT`` if a bucket does not
        divide); the reassembled aggregate is only returned when in/out
        degrees match (the exchange is shape-preserving then), raw buckets
        otherwise.  The requests donate nothing, so they run eagerly."""

        tool.pvar_count("neighbor_alltoall_init")
        d_out, d_in = self.outdegree(), self.indegree()

        def fire(b):
            return self._exchange(b, alltoall=True).get()

        if isinstance(example, (torch.Tensor, np.ndarray)):
            return PersistentCollective(
                "neighbor_alltoall", None, [PersistentRequest(fire, (torch.as_tensor(example),))]
            )
        dt = datatypes.datatype_of(example)
        requests = []
        for buf in dt.pack(example):
            extent = buf.numel()
            errors.check(
                extent % d_out == 0,
                errors.ErrorClass.ERR_COUNT,
                f"packed bucket extent {extent} not divisible by the "
                f"outdegree {d_out}",
            )

            def bucket_fire(b):
                return fire(b.reshape(d_out, -1)).reshape(-1)

            requests.append(PersistentRequest(bucket_fire, (buf,)))
        return PersistentCollective(
            "neighbor_alltoall",
            dt,
            requests,
            unpackable=(d_in == d_out),
            signature=argument_signature(example),
        )


# ---------------------------------------------------------------------------
# Cartesian topology
# ---------------------------------------------------------------------------


class CartComm(_NeighborComm):
    """``MPI_Cart_create`` result: a communicator whose ranks live on a
    ``dims`` grid with per-dim periodicity.

    ``parent`` takes the place of the reference's mesh: the cart spans its
    axes ``axis_names`` — all of them, or one, the line through this rank
    (the other axes are colors) — and reuses its process groups, so
    building a cart creates none.

    The neighbor structure (for the neighborhood collectives) follows the
    standard's cart convention: ``2·ndims`` slots ordered (dim 0 −, dim 0 +,
    dim 1 −, …); ``PROC_NULL`` slots at non-periodic boundaries stay in the
    buffer and read as zeros.
    """

    def __init__(
        self,
        parent: Communicator,
        axis_names: Sequence[str],
        *,
        dims: Sequence[int],
        periods: Sequence[bool],
        managed: bool = False,
        tag: str = "",
    ):
        axis_names = tuple(axis_names)
        self.dims = tuple(int(d) for d in dims)
        self.periods = tuple(bool(p) for p in periods)
        errors.check(
            len(self.dims) == len(self.periods) == len(axis_names),
            errors.ErrorClass.ERR_DIMS,
            f"dims {self.dims}, periods {self.periods} and axes "
            f"{axis_names} must have equal length",
        )
        for d, a in zip(self.dims, axis_names):
            errors.check(
                parent.axis_size(a) == d,
                errors.ErrorClass.ERR_DIMS,
                f"cart dim {d} does not match axis {a!r} "
                f"of size {parent.axis_size(a)}",
            )
        base = parent.split(*axis_names)
        super().__init__(base._group, base.shape, base.axis_names, managed=managed, tag=tag,
                         process_groups=(base._pg, base._axis_groups))
        n = self.size()
        # per-dim shift tables are rank-independent: compute once per dim
        shifts = [
            cart_shift_tables(self.dims, self.periods, dim, 1)
            for dim in range(len(self.dims))
        ]
        srcs, dsts = [], []
        for r in range(n):
            s_r, d_r = [], []
            for sources, destinations in shifts:
                # slot order per MPI: (dim −, dim +): the − slot receives
                # from the lower neighbor, i.e. the +1 shift's source
                s_r += [sources[r], destinations[r]]
                d_r += [sources[r], destinations[r]]
            srcs.append(tuple(s_r))
            dsts.append(tuple(d_r))
        self._sources = tuple(srcs)
        self._destinations = tuple(dsts)
        self._rounds = _matching_rounds(cart_edges(self.dims, self.periods))

    # -- cart queries -------------------------------------------------------

    @property
    def ndims(self) -> int:
        """``MPI_Cartdim_get``."""

        return len(self.dims)

    def cart_coords(self, rank: int) -> tuple[int, ...]:
        """``MPI_Cart_coords``."""

        return cart_coords_of(self.dims, rank)

    def cart_rank(self, coords: Sequence[int]) -> int:
        """``MPI_Cart_rank`` (periodic dims wrap)."""

        return cart_rank_of(self.dims, self.periods, coords)

    def cart_shift(self, dim: int, disp: int = 1) -> CartShift:
        """``MPI_Cart_shift``: source/destination tables plus the static
        permutations that move data by ``disp`` along ``dim``."""

        sources, destinations = cart_shift_tables(self.dims, self.periods, dim, disp)
        perm = tuple(
            (r, d) for r, d in enumerate(destinations) if d != PROC_NULL
        )
        size = self.dims[dim]
        if self.periods[dim]:
            axis_perm = tuple((i, (i + disp) % size) for i in range(size))
        else:
            axis_perm = tuple(
                (i, i + disp) for i in range(size) if 0 <= i + disp < size
            )
        return CartShift(
            dim=dim,
            disp=disp,
            sources=sources,
            destinations=destinations,
            perm=perm,
            axis_name=self.axis_names[dim],
            axis_perm=axis_perm,
        )

    def shift_exchange(self, value: Any, dim: int, disp: int = 1) -> Future:
        """``cart_shift`` + sendrecv in one call: every rank's ``value`` (a
        tensor or a nest of tensors) moves ``disp`` steps along ``dim``;
        ranks whose source is :data:`PROC_NULL` receive zeros.  One
        ``dist.batch_isend_irecv`` over the dimension's process group
        (:func:`~repro_torch.core.collectives.exchange`); returns a
        :class:`Future` over the received value, so the exchange can be
        overlapped (issue, compute, ``get()``)."""

        shift = self.cart_shift(dim, disp)
        me = self._member_rank()
        src, dst = shift.sources[me], shift.destinations[me]
        return collectives.exchange(
            value, me=me, src=None if src == PROC_NULL else src,
            dst=None if dst == PROC_NULL else dst,
            ranks=self.global_ranks(), group=self.axis_group(shift.axis_name))

    def cart_sub(self, remain_dims: Sequence[bool]) -> "CartComm":
        """``MPI_Cart_sub``: keep the dims flagged in ``remain_dims`` — all
        of them, or one (the line through this rank)."""

        remain = tuple(bool(x) for x in remain_dims)
        errors.check(
            len(remain) == self.ndims,
            errors.ErrorClass.ERR_DIMS,
            f"remain_dims has {len(remain)} entries for {self.ndims} dims",
        )
        errors.check(
            any(remain),
            errors.ErrorClass.ERR_DIMS,
            "cart_sub must retain at least one dimension",
        )
        keep = [i for i, k in enumerate(remain) if k]
        return CartComm(
            self,
            tuple(self.axis_names[i] for i in keep),
            dims=tuple(self.dims[i] for i in keep),
            periods=tuple(self.periods[i] for i in keep),
            managed=False,
            tag=self.tag,
        )

    # -- cart-specialised neighborhood exchange ------------------------------

    def _exchange(self, x: Any, *, alltoall: bool) -> DeferredFuture:
        """Cart override of the generic engine: one shift exchange per
        (dim, direction) over that dimension's process group instead of
        flat-rank rounds — ``2·ndims`` exchanges, the canonical
        halo-exchange lowering."""

        x = torch.as_tensor(x)
        degree = 2 * self.ndims
        if alltoall:
            self._check_alltoall(x, degree)
        parts = []
        for dim in range(self.ndims):
            # send slot 2d to the − neighbor, slot 2d+1 to the +; the
            # arrival fills the receiver's opposite slot
            to_plus, to_minus = (x[2 * dim + 1], x[2 * dim]) if alltoall else (x, x)
            parts += [(2 * dim, self.shift_exchange(to_plus, dim, 1)),
                      (2 * dim + 1, self.shift_exchange(to_minus, dim, -1))]
        block_shape = tuple(x.shape[1:] if alltoall else x.shape)
        out = torch.zeros((degree,) + block_shape, dtype=x.dtype, device=x.device)
        return _join(parts, out)

    def __repr__(self):
        return (
            f"CartComm(dims={self.dims}, periods={self.periods}, "
            f"axes={self.axis_names}, tag={self.tag!r})"
        )


# ---------------------------------------------------------------------------
# distributed graph topology
# ---------------------------------------------------------------------------


class DistGraphComm(_NeighborComm):
    """``MPI_Dist_graph_create_adjacent`` result: a communicator with an
    explicit (possibly weighted, possibly asymmetric) neighbor graph.

    Adjacency is declared for every rank at once (``sources[r]`` /
    ``destinations[r]``), as in the reference; both endpoints of every edge
    must agree, exactly as the standard requires of the adjacent
    constructor.  In/out degrees may differ per rank; buffers pad to the
    maxima (zeros in absent slots).  ``parent`` takes the place of the
    reference's mesh: the graph spans its ranks and reuses its process
    groups.
    """

    def __init__(
        self,
        parent: Communicator,
        *,
        sources: Sequence[Sequence[int]],
        destinations: Sequence[Sequence[int]],
        source_weights: Sequence[Sequence[float]] | None = None,
        dest_weights: Sequence[Sequence[float]] | None = None,
        managed: bool = False,
        tag: str = "",
    ):
        super().__init__(parent._group, parent.shape, parent.axis_names, managed=managed,
                         tag=tag, process_groups=(parent._pg, parent._axis_groups))
        n = self.size()
        errors.check(
            len(sources) == n and len(destinations) == n,
            errors.ErrorClass.ERR_TOPOLOGY,
            f"adjacency must cover all {n} ranks "
            f"(got {len(sources)} source rows, {len(destinations)} destination rows)",
        )
        for name, rows in (("sources", sources), ("destinations", destinations)):
            for r, row in enumerate(rows):
                for x in row:
                    errors.check(
                        0 <= int(x) < n or int(x) == PROC_NULL,
                        errors.ErrorClass.ERR_RANK,
                        f"{name}[{r}] names rank {x}; valid: [0, {n}) or "
                        f"PROC_NULL ({PROC_NULL}) for a placeholder slot",
                    )
        self._sources = tuple(tuple(int(x) for x in row) for row in sources)
        self._destinations = tuple(tuple(int(x) for x in row) for row in destinations)

        def _weights(weights, rows, kind):
            if weights is None:
                return tuple(tuple(1.0 for _ in row) for row in rows)
            errors.check(
                len(weights) == n
                and all(len(w) == len(r) for w, r in zip(weights, rows)),
                errors.ErrorClass.ERR_ARG,
                f"{kind} weights must align with the {kind} lists",
            )
            return tuple(tuple(float(x) for x in row) for row in weights)

        self.source_weights = _weights(source_weights, self._sources, "source")
        self.dest_weights = _weights(dest_weights, self._destinations, "destination")
        self._rounds = _matching_rounds(
            _build_edges(self._sources, self._destinations)
        )

    def dist_graph_neighbors_count(self, rank: int) -> tuple[int, int]:
        """``MPI_Dist_graph_neighbors_count`` → (indegree, outdegree)."""

        return len(self._sources[rank]), len(self._destinations[rank])

    def dist_graph_neighbors(self, rank: int):
        """``MPI_Dist_graph_neighbors`` → (sources, source_weights,
        destinations, dest_weights) for ``rank``."""

        return (
            self._sources[rank],
            self.source_weights[rank],
            self._destinations[rank],
            self.dest_weights[rank],
        )

    def __repr__(self):
        return (
            f"DistGraphComm(size={self.size()}, "
            f"max_in={self.indegree()}, max_out={self.outdegree()}, "
            f"tag={self.tag!r})"
        )


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


class _Shift(torch.autograd.Function):
    """The differentiable cart shift: forward, ``cart.shift_exchange``;
    backward, the cotangent sent back by ``-disp`` (zeros where the
    backward's source is :data:`PROC_NULL`), as a ``ppermute`` transposes
    to the reverse permutation."""

    @staticmethod
    def forward(ctx, x, cart, dim, disp):
        ctx.cart, ctx.dim, ctx.disp = cart, dim, disp
        return cart.shift_exchange(x, dim, disp).get()

    @staticmethod
    def backward(ctx, g):
        back = ctx.cart.shift_exchange(g.contiguous(), ctx.dim, -ctx.disp).get()
        return back, None, None, None


def shift_differentiable(cart: "CartComm", x: torch.Tensor, dim: int, disp: int = 1
                         ) -> torch.Tensor:
    """``cart.shift_exchange(x, dim, disp).get()`` of one tensor, on the
    autograd graph: the received tensor's gradient goes back to the rank
    that sent it (a shift by ``-disp``).  Every rank of the dimension calls
    it in the same order, forward and backward, as it calls any exchange;
    the ring's recompute and the pipeline's stage boundary run on it."""

    return _Shift.apply(x, cart, dim, disp)


def cart_create(
    comm_or_group: Communicator | Group,
    dims: Sequence[int],
    periods: Sequence[bool] | None = None,
    *,
    reorder: bool = False,
    axis_names: Sequence[str] | None = None,
    session=None,
    tag: str | None = None,
) -> CartComm:
    """``MPI_Cart_create``: fold a communicator's group onto a grid.

    Routed through the group algebra: the leading ``prod(dims)`` members of
    the parent group are carved out with ``incl`` (ranks beyond get no
    membership — MPI returns ``MPI_COMM_NULL`` for them; here their
    ``rank()`` is ``UNDEFINED``), the grid is registered as the session
    process set ``repro://cart/<dims>``, and the communicator is built by
    :meth:`Communicator.from_group` — the single canonical constructor.
    Collective over the process world, as ``MPI_Cart_create`` is.

    ``reorder=True`` is accepted for signature fidelity but performs no
    renumbering: ranks are processes, bound to their devices.
    """

    tool.pvar_count("cart_create")
    group = (
        comm_or_group.group()
        if isinstance(comm_or_group, Communicator)
        else comm_or_group
    )
    errors.check(
        isinstance(group, Group),
        errors.ErrorClass.ERR_GROUP,
        f"cart_create needs a Communicator or Group, got {type(comm_or_group).__name__}",
    )
    dims = tuple(int(d) for d in dims)
    errors.check(
        len(dims) > 0 and all(d > 0 for d in dims),
        errors.ErrorClass.ERR_DIMS,
        f"cart dims must be positive, got {dims}",
    )
    periods = (
        tuple(bool(p) for p in periods)
        if periods is not None
        else (False,) * len(dims)
    )
    errors.check(
        len(periods) == len(dims),
        errors.ErrorClass.ERR_DIMS,
        f"{len(periods)} periods for {len(dims)} dims",
    )
    n = math.prod(dims)
    errors.check(
        n <= group.size(),
        errors.ErrorClass.ERR_DIMS,
        f"cart grid {dims} needs {n} members, group has {group.size()}",
    )
    sub = group.incl(range(n))
    dims_str = "x".join(str(d) for d in dims)
    tag = tag if tag is not None else f"{CART_PSET_PREFIX}{dims_str}"
    if session is None:
        first = sub.device(0)
        device = first.device if isinstance(first, RankDevice) else first
        session = default_session(device_type=torch.device(device).type)
    # the default tag is keyed on dims alone: re-registering the SAME grid
    # is idempotent, but a different group under the same name would
    # silently clobber the first cart's process set — require an explicit
    # tag for that
    if tag in session.psets():
        errors.check(
            session.pset(tag) == tuple(sub.devices),
            errors.ErrorClass.ERR_ARG,
            f"process set {tag!r} already names a different device grid; "
            f"pass an explicit tag= to register a second {dims_str} cart",
        )
    session.register_pset(tag, sub)
    if axis_names is None:
        axis_names = tuple(f"cart{i}" for i in range(len(dims)))
    axis_names = tuple(axis_names)
    base = Communicator.from_group(sub, tag=tag, shape=dims, axis_names=axis_names)
    return CartComm(base, axis_names, dims=dims, periods=periods, managed=True, tag=tag)


def cart_refold(
    cart: CartComm,
    group: Group,
    *,
    elastic_axis: int = 0,
    session=None,
    tag: str | None = None,
) -> CartComm:
    """Re-fold an existing Cartesian topology onto an *arbitrary* survivor
    (or grown) group — the ULFM shrink/grow rebuild step for carts.

    The grid keeps every dim except ``elastic_axis`` (the data axis by
    convention), which re-resolves to ``group.size() // prod(fixed)``; the
    leading ``prod(dims)`` members fold row-major and any excess idles
    (``MPI_COMM_NULL``).  Periods and axis names carry over.  Pass an
    explicit ``tag``: across epochs the same dims can bind different
    members, which the dims-keyed default tag refuses by design.  Collective
    over the process world, as :func:`cart_create` is.
    """

    fixed = math.prod(d for i, d in enumerate(cart.dims) if i != elastic_axis)
    errors.check(
        group.size() >= fixed,
        errors.ErrorClass.ERR_DIMS,
        f"{group.size()} survivors cannot fold onto {cart.dims} "
        f"(needs at least {fixed})",
    )
    dims = tuple(
        group.size() // fixed if i == elastic_axis else d
        for i, d in enumerate(cart.dims)
    )
    return cart_create(
        group,
        dims,
        cart.periods,
        axis_names=cart.axis_names,
        session=session,
        tag=tag,
    )


def dist_graph_create_adjacent(
    comm: Communicator,
    sources: Sequence[Sequence[int]],
    destinations: Sequence[Sequence[int]],
    *,
    source_weights: Sequence[Sequence[float]] | None = None,
    dest_weights: Sequence[Sequence[float]] | None = None,
    reorder: bool = False,
) -> DistGraphComm:
    """``MPI_Dist_graph_create_adjacent`` over an existing communicator
    (``reorder=False`` semantics: ranks keep their identity; the
    ``reorder=True`` note of :func:`cart_create` applies).  Creates no
    process group."""

    tool.pvar_count("dist_graph_create")
    return DistGraphComm(
        comm,
        sources=sources,
        destinations=destinations,
        source_weights=source_weights,
        dest_weights=dest_weights,
        managed=False,
        tag=comm.tag,
    )


# ---------------------------------------------------------------------------
# serving fan-out graphs (heterogeneous prefill:decode, e.g. 2:6 / 3:5)
# ---------------------------------------------------------------------------


def serving_fanout_adjacency(
    num_prefill: int, num_decode: int
) -> tuple[list[list[int]], list[list[int]]]:
    """Adjacency of a ``P:D`` serving fan-out over a bridge ordered
    prefill-then-decode: ranks ``0..P-1`` are prefill workers, ``P..P+D-1``
    decode workers; decode rank ``P+j`` receives its KV from prefill rank
    ``j % P`` (round-robin), so the decode fleet is partitioned into ``P``
    disjoint fan-out sets.  Returns ``(sources, destinations)`` in the
    all-ranks-at-once form :class:`DistGraphComm` requires.  This is the
    heterogeneous-ratio shape (2:6, 3:5, ...) an axis split cannot express —
    the graph, not a grid, is the topology."""

    p, d = int(num_prefill), int(num_decode)
    errors.check(
        p >= 1 and d >= 1,
        errors.ErrorClass.ERR_DIMS,
        f"serving fan-out needs at least one prefill and one decode rank, "
        f"got {p}:{d}",
    )
    errors.check(
        d >= p,
        errors.ErrorClass.ERR_DIMS,
        f"serving fan-out {p}:{d} leaves {p - d} prefill ranks with no "
        "decode targets; use num_decode >= num_prefill",
    )
    sources: list[list[int]] = []
    destinations: list[list[int]] = []
    for i in range(p):
        sources.append([])
        destinations.append([p + j for j in range(d) if j % p == i])
    for j in range(d):
        sources.append([j % p])
        destinations.append([])
    return sources, destinations


def fanout_routes(
    sources: Sequence[Sequence[int]], destinations: Sequence[Sequence[int]]
) -> list[tuple[int, int]]:
    """The KV routing pairs of a fan-out adjacency: every declared edge as
    an origin→target ``(src, dst)`` pair, in target order.  Each decode
    target is written by exactly one origin, so the per-epoch
    duplicate-target check holds by construction; but an origin may feed
    several targets, which a single ``send_recv`` cannot carry — split the
    routes into per-``rput`` permutations with :func:`fanout_rounds`."""

    edges = [
        (r, int(dst))
        for r, row in enumerate(destinations)
        for dst in row
        if int(dst) != PROC_NULL
    ]
    for dst, row in enumerate(sources):
        for src in row:
            if int(src) != PROC_NULL and (int(src), dst) not in edges:
                edges.append((int(src), dst))
    return sorted(set(edges), key=lambda e: (e[1], e[0]))


def fanout_rounds(
    routes: Sequence[tuple[int, int]],
) -> list[list[tuple[int, int]]]:
    """Split fan-out routes into ``send_recv``-legal rounds: within a round
    every origin sends to at most one target and every target is written by
    at most one origin, so each round is directly usable as the ``perm`` of
    a window :meth:`~repro_torch.core.onesided.Window.rput`.  Greedy
    first-fit preserves the target order of :func:`fanout_routes`; a
    ``P:D`` fan-out yields ``ceil(D / P)`` rounds."""

    rounds: list[list[tuple[int, int]]] = []
    for src, dst in routes:
        for rnd in rounds:
            if all(s != src and d != dst for s, d in rnd):
                rnd.append((int(src), int(dst)))
                break
        else:
            rounds.append([(int(src), int(dst))])
    return rounds


def serving_fanout_graph(
    comm: Communicator, num_prefill: int, num_decode: int
) -> DistGraphComm:
    """``MPI_Dist_graph_create_adjacent`` over a serving bridge with the
    ``P:D`` fan-out adjacency (:func:`serving_fanout_adjacency`)."""

    errors.check(
        num_prefill + num_decode == comm.size(),
        errors.ErrorClass.ERR_TOPOLOGY,
        f"fan-out {num_prefill}:{num_decode} needs a bridge of "
        f"{num_prefill + num_decode} ranks, communicator has {comm.size()}",
    )
    sources, destinations = serving_fanout_adjacency(num_prefill, num_decode)
    return dist_graph_create_adjacent(comm, sources, destinations)


# -- method facade (paper style: comm.cart_create(...)) -----------------------

Communicator.cart_create = cart_create
Communicator.dist_graph_create_adjacent = dist_graph_create_adjacent
