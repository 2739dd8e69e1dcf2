"""Virtual process topologies (MPI 4.0 ch. 8): the Cartesian part of
:mod:`repro.core.topology`.

A :class:`CartComm` is a communicator whose ranks live on a ``dims`` grid
with per-dim periodicity.  The host-level cart arithmetic
(:func:`cart_coords_of`, :func:`cart_rank_of`, :func:`cart_shift_tables`,
:class:`CartShift`) is copied from the reference, which a parity test pins.
:meth:`CartComm.shift_exchange` moves every rank's value ``disp`` steps
along one dimension with one ``dist.batch_isend_irecv`` over that
dimension's process group and returns a :class:`~repro_torch.core.futures.
Future` over the pending exchange; a rank whose source is
:data:`PROC_NULL` receives zeros, and a rank that is its own source (a
periodic ring of one) keeps its value without any transfer — PyTorch
refuses a send to one's own rank.

Not ported yet: the neighborhood collectives, ``DistGraphComm`` and the
fanout helpers (with the disaggregated server), ``cart_refold`` (with
elastic epochs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import collectives, errors, tool
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import Future
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
# Cartesian topology
# ---------------------------------------------------------------------------


class CartComm(Communicator):
    """``MPI_Cart_create`` result: a communicator whose ranks live on a
    ``dims`` grid with per-dim periodicity.

    ``parent`` takes the place of the reference's mesh: the cart spans its
    axes ``axis_names`` — all of them, or one, the line through this rank
    (the other axes are colors) — and reuses its process groups, so
    building a cart creates none.
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

    def __repr__(self):
        return (
            f"CartComm(dims={self.dims}, periods={self.periods}, "
            f"axes={self.axis_names}, tag={self.tag!r})"
        )


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


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
