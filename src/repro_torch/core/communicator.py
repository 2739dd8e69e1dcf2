"""Communicators (paper §II, C1/C4 — and MPI 4.0 §11 Sessions) over the
ranks of a process world.

The reference's communicator is a JAX mesh plus a subset of its named axes.
Here a communicator is a group's members (:class:`~repro_torch.core.session.
RankDevice`, one process each) folded onto a named grid (``shape`` /
``axis_names``, row-major rank order), with ``torch.distributed`` process
groups behind it: one over the whole communicator and, for every axis, one
per line of ranks along it.  Every rank of the process world creates the
same groups in the same order at construction (``new_group`` is collective
over the world), members or not; a line of one rank needs no group.  A
process group orders its ranks by global rank, so one group serves every
order of the same members (the collectives map communicator ranks onto
it).
:meth:`Communicator.from_group` stays the one canonical constructor
(``MPI_Comm_create_from_group``); :func:`world` is a shim over the default
session's ``repro://world`` pset, :meth:`Communicator.create` wraps its
devices in a group first, and :meth:`~Communicator.split` and
:meth:`~Communicator.dup` derive their results from the parent's group.

Groups are shared through one cache, keyed by their members, unless they
are made under a :func:`group_scope`: then they belong to that scope's
owner, are never handed to anyone else, and :func:`release_groups` destroys
them (NCCL communicators included) and forgets them — the elastic epochs
(:mod:`repro_torch.core.epoch`) build each generation's fabric so and
release it when they revoke it.  The default group is shared by everyone
and never destroyed here.  The collectives are bound as methods by
:mod:`repro_torch.core._methods`.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import errors
from repro_torch.core.session import (
    GROUP_TIMEOUT,
    UNDEFINED,
    WORLD_PSET,
    Group,
    RankDevice,
    default_session,
)


def _axis_name_from_tag(tag: str) -> str:
    """Default axis name for a pset tag: its last path component, sanitised
    to an identifier (``repro://world`` → ``world``)."""

    leaf = tag.rsplit("/", 1)[-1] if tag else ""
    name = "".join(c if c.isalnum() or c == "_" else "_" for c in leaf)
    return name or "ranks"


# the default group → its subgroups by (owner, members in global-rank
# order[, "local"]): all ranks construct the same communicators in the same
# order, so the cache holds the same groups on every rank
_PROCESS_GROUPS: dict[Any, dict[tuple, Any]] = {}
# the owners whose groups the communicators constructed now create
# (group_scope), innermost last: (owner, whether the default group serves
# a communicator over the whole world)
_SCOPES: list[tuple[Any, bool]] = []
_DUPS = itertools.count()


def _groups() -> dict[tuple, Any]:
    if dist.group.WORLD not in _PROCESS_GROUPS:
        _PROCESS_GROUPS.clear()  # a new default group: the old subgroups are gone
        _PROCESS_GROUPS[dist.group.WORLD] = {}
    return _PROCESS_GROUPS[dist.group.WORLD]


def _process_group(ranks: tuple[int, ...], owner: Any = None, *, local: bool = False,
                   share_world: bool = True):
    """The process group over ``ranks`` (global ranks, any order): the
    default group when they are the whole world (unless ``share_world`` is
    off), ``None`` for a single rank outside a world of one (nothing to
    talk to), else ``owner``'s group over them — which every rank of the
    world must ask for, in the same order, or with ``local`` only the
    members (``use_local_synchronization``)."""

    world = dist.get_world_size()
    members = tuple(sorted(ranks))
    if share_world and members == tuple(range(world)):
        return dist.group.WORLD
    if len(members) == 1 and world > 1:
        return None
    key = (owner, members, "local") if local else (owner, members)
    groups = _groups()
    if key not in groups:
        groups[key] = dist.new_group(list(members), timeout=GROUP_TIMEOUT,
                                     use_local_synchronization=local)
    return groups[key]


def _group_of_one(rank: int, owner: Any = None):
    """A group of ``rank`` alone, made by it alone: a device mesh needs a
    group for each of its dims, a line of one rank included."""

    key = (owner, (rank,), "local")
    groups = _groups()
    if key not in groups:
        groups[key] = dist.new_group([rank], timeout=GROUP_TIMEOUT,
                                     use_local_synchronization=True)
    return groups[key]


@contextlib.contextmanager
def group_scope(owner: Any, *, share_world: bool = True):
    """Communicators constructed inside make their process groups as
    ``owner``'s: apart from every other owner's, and destroyed together by
    :func:`release_groups`.  ``share_world=False`` gives a communicator over
    the whole world a group of its own too."""

    _SCOPES.append((owner, share_world))
    try:
        yield
    finally:
        _SCOPES.pop()


def release_groups(owner: Any) -> list:
    """Destroy every process group ``owner`` made, in the order it made
    them (every member destroys a group at the same point, as it made it),
    and forget them: the cache never hands out a destroyed group.  Returns
    the destroyed groups."""

    if owner is None or not dist.is_initialized():
        return []
    groups = _groups()
    out = []
    for key in [k for k in groups if k[0] == owner]:
        pg = groups.pop(key)
        if pg is not None and pg is not dist.GroupMember.NON_GROUP_MEMBER:
            dist.destroy_process_group(pg)
            out.append(pg)
    return out


_TOKENS: dict[Any, int] = {}


def _mesh_token(owner: Any) -> int:
    """A number of ``owner``'s own, which its device meshes carry where
    ``DeviceMesh`` keeps a thread id (negative: a thread id is not)."""

    if owner not in _TOKENS:
        _TOKENS[owner] = -1 - len(_TOKENS)
    return _TOKENS[owner]


def _lines(shape: tuple[int, ...], axis: int) -> list[list[int]]:
    """The flat ranks of every line along ``axis``, in row-major order of
    the other coordinates; each line in coordinate order."""

    n = math.prod(shape)
    grid = np.arange(n).reshape(shape)
    moved = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
    return [[int(r) for r in line] for line in moved]


class Communicator:
    """A named-axis communicator over the members of one group.

    ``process_groups`` (``(whole, {axis: (group, global ranks of this
    rank's line)})``) lets a derived communicator reuse its parent's groups;
    by default they are created here."""

    def __init__(
        self,
        group: Group,
        shape: Sequence[int],
        axis_names: Sequence[str],
        *,
        managed: bool = False,
        tag: str = "",
        process_groups: tuple | None = None,
    ):
        self._group = group
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.managed = managed
        self.tag = tag
        # the owner of the groups this communicator makes (group_scope)
        self._owner, self._share_world = _SCOPES[-1] if _SCOPES else (None, True)
        if process_groups is None:
            process_groups = self._create_process_groups()
        self._pg, self._axis_groups = process_groups

    def _create_process_groups(self) -> tuple:
        ranks = self.global_ranks()
        if ranks is None or not dist.is_initialized():
            return None, {}  # members without a process behind them: one process
        me = self.rank()
        kw = dict(owner=self._owner, share_world=self._share_world)
        whole = _process_group(ranks, **kw)
        axis_groups = {}
        for axis, name in enumerate(self.axis_names):
            for line in _lines(self.shape, axis):
                line_ranks = tuple(ranks[i] for i in line)
                pg = _process_group(line_ranks, **kw)
                if me in line:
                    axis_groups[name] = (pg, line_ranks)
        return whole, axis_groups

    @classmethod
    def from_group(
        cls,
        group: Group,
        *,
        tag: str = "",
        shape: Sequence[int] | None = None,
        axis_names: Sequence[str] | None = None,
    ) -> "Communicator":
        """``MPI_Comm_create_from_group``: the canonical constructor.  By
        default one axis named after ``tag``; pass ``shape``/``axis_names``
        to fold the group onto a multi-axis grid (row-major rank order).
        Collective over the process world: every rank calls it alike."""

        errors.check(
            isinstance(group, Group),
            errors.ErrorClass.ERR_GROUP,
            f"from_group needs a Group, got {type(group).__name__}",
        )
        errors.check(
            group.size() > 0,
            errors.ErrorClass.ERR_GROUP,
            "cannot build a communicator from the empty group",
        )
        if shape is None:
            shape = (group.size(),)
        shape = tuple(int(s) for s in shape)
        errors.check(
            math.prod(shape) == group.size(),
            errors.ErrorClass.ERR_DIMS,
            f"shape {shape} does not fold a group of {group.size()} devices",
        )
        if axis_names is None:
            errors.check(
                len(shape) == 1,
                errors.ErrorClass.ERR_DIMS,
                "multi-axis from_group needs explicit axis_names",
            )
            axis_names = (_axis_name_from_tag(tag),)
        axis_names = tuple(axis_names)
        errors.check(
            len(axis_names) == len(shape),
            errors.ErrorClass.ERR_DIMS,
            f"{len(axis_names)} axis names for a {len(shape)}-dim shape {shape}",
        )
        return cls(group, shape, axis_names, managed=True, tag=tag)

    @classmethod
    def create(cls, shape: Sequence[int], axis_names: Sequence[str], devices=None):
        """Managed constructor: wraps ``devices[:prod(shape)]`` (by default
        the default session's world) in a group and routes through
        :meth:`from_group`."""

        if devices is None:
            devices = default_session().pset(WORLD_PSET)
        n = math.prod(shape)
        errors.check(
            n <= len(devices),
            errors.ErrorClass.ERR_DIMS,
            f"mesh of {n} devices requested, {len(devices)} available",
        )
        return cls.from_group(Group(devices[:n]), shape=shape, axis_names=tuple(axis_names))

    def dup(self) -> "Communicator":
        """``MPI_Comm_dup`` (the only sanctioned copy): a new handle over the
        same group and grid (``MPI_IDENT``) with process groups of its own, a
        communication context apart from this one's.  Collective over the
        process world, as :meth:`from_group` is."""

        with group_scope(("dup", next(_DUPS)), share_world=False):
            return Communicator(self._group, self.shape, self.axis_names, tag=self.tag)

    def __copy__(self):  # copy ctor is "deleted"
        errors.fail(
            errors.ErrorClass.ERR_COMM,
            "communicators are not copyable; use .dup() (MPI_Comm_dup)",
        )

    __deepcopy__ = __copy__

    # -- topology ----------------------------------------------------------

    def size(self) -> int:
        return self._group.size()

    def axis_size(self, name: str) -> int:
        errors.check(
            name in self.axis_names,
            errors.ErrorClass.ERR_TOPOLOGY,
            f"axis {name!r} not in communicator axes {self.axis_names}",
        )
        return self.shape[self.axis_names.index(name)]

    def group(self) -> Group:
        """``MPI_Comm_group``."""

        return self._group

    def rank(self) -> int:
        """``MPI_Comm_rank``: this process's rank, or ``UNDEFINED`` if it
        is not a member."""

        return self._group.rank()

    def coords(self) -> tuple[int, ...]:
        """This rank's coordinates on the grid (row-major)."""

        r = self._member_rank()
        return tuple(int(c) for c in np.unravel_index(r, self.shape))

    def global_ranks(self) -> tuple[int, ...] | None:
        """The members' ranks in the process world, in this communicator's
        rank order; ``None`` for members that are bare devices."""

        members = self._group.devices
        if not all(isinstance(m, RankDevice) for m in members):
            return None
        return tuple(m.rank for m in members)

    def process_group(self):
        """The ``torch.distributed`` group over every member (``None``
        without a process world behind the members)."""

        return self._pg

    def axis_group(self, name: str):
        """The process group of this rank's line along axis ``name``
        (``None`` for a line of one rank outside a world of one)."""

        self.axis_size(name)
        return self._axis_groups[name][0] if name in self._axis_groups else None

    def axis_ranks(self, name: str) -> tuple[int, ...]:
        """Global ranks of this rank's line along axis ``name``, in
        coordinate order."""

        self.axis_size(name)
        if name in self._axis_groups:
            return self._axis_groups[name][1]
        return (self._member_rank(),)

    @property
    def device_mesh(self):
        """A ``torch.distributed`` ``DeviceMesh`` over this communicator's
        ranks with its axis names (``DeviceMesh.from_group`` over the
        per-axis process groups), on which DTensor places a tree
        (:mod:`repro_torch.sharding.rules`).  A line of one rank, which has
        no group among the communicator's, gets a group of its own, made by
        this rank alone.  Built once per communicator; the mesh of a
        communicator made under a :func:`group_scope` equals no mesh made
        outside it."""

        mesh = getattr(self, "_device_mesh", None)
        if mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            ranks = self.global_ranks()
            errors.check(
                ranks is not None and dist.is_initialized(),
                errors.ErrorClass.ERR_COMM,
                f"{self!r} has no process world behind it: no device mesh",
            )
            self._member_rank()
            groups = []
            for name in self.axis_names:
                pg = self.axis_group(name)
                if pg is None:
                    pg = _group_of_one(ranks[self._member_rank()], self._owner)
                groups.append(pg)
            dev = self.device
            mesh = self._device_mesh = DeviceMesh.from_group(
                groups, dev.type, mesh=torch.tensor(ranks).reshape(self.shape),
                mesh_dim_names=self.axis_names)
            if self._owner is not None:
                # DTensor caches its sharding decisions keyed by meshes that
                # compare equal by layout, names and thread id: a decision
                # made on a mesh whose groups are destroyed would be handed
                # to a later mesh over the same ranks (in every thread that
                # ran one, the autograd engine's included).  An owner's
                # meshes compare equal to no one else's.
                mesh._thread_id = _mesh_token(self._owner)
        return mesh

    def split(self, *axis_names: str) -> "Communicator":
        """``MPI_Comm_split`` along topology axes: the communicator over the
        sub-grid through this rank that spans ``axis_names`` (in that order,
        row-major), the other axes fixed at this rank's coordinates (the
        color).  One axis, or all of them, reuses the process groups that
        exist; a sub-grid of several axes gets a group of its own, made by
        its members alone."""

        for name in axis_names:
            self.axis_size(name)
        errors.check(
            len(set(axis_names)) == len(axis_names) > 0,
            errors.ErrorClass.ERR_TOPOLOGY,
            f"split axes {axis_names} must be distinct axes of {self.axis_names}",
        )
        if tuple(axis_names) == self.axis_names:
            return Communicator(self._group, self.shape, self.axis_names, tag=self.tag,
                                process_groups=(self._pg, dict(self._axis_groups)))
        axes = [self.axis_names.index(name) for name in axis_names]
        coords = list(self.coords())
        flat = []
        for idx in np.ndindex(*(self.shape[a] for a in axes)):
            for a, i in zip(axes, idx):
                coords[a] = i
            flat.append(int(np.ravel_multi_index(tuple(coords), self.shape)))
        sub = self._group.incl(flat)
        shape = tuple(self.shape[a] for a in axes)
        axis_groups = {name: self._axis_groups[name] for name in axis_names
                       if name in self._axis_groups}
        if len(axes) == 1:
            (name,) = axis_names
            entry = axis_groups.get(name)
            whole = entry[0] if entry else None
        elif len(axes) == len(self.axis_names):
            whole = self._pg   # the same members in another order
        else:
            ranks = tuple(m.rank for m in sub.devices) if self._pg is not None else None
            whole = (_process_group(ranks, self._owner, local=True)
                     if ranks is not None else None)
        return Communicator(sub, shape, tuple(axis_names), tag=self.tag,
                            process_groups=(whole, axis_groups))

    def _member_rank(self) -> int:
        r = self.rank()
        errors.check(
            r != UNDEFINED,
            errors.ErrorClass.ERR_COMM,
            f"this process is not a member of {self!r}",
        )
        return r

    @property
    def device(self) -> torch.device:
        """This rank's device: where its share of the work runs."""

        member = self._group.device(self._member_rank())
        return member.device if isinstance(member, RankDevice) else member

    def __repr__(self):
        kind = "managed" if self.managed else "unmanaged"
        tag = f", tag={self.tag!r}" if self.tag else ""
        return f"Communicator(axes={self.axis_names}, size={self.size()}, {kind}{tag})"


_WORLD: dict[str, Communicator] = {}


def world(refresh: bool = False, device_type: str = "cuda") -> Communicator:
    """The ``mpi::world_communicator`` analogue: one axis over all ranks of
    the process world, on ``device_type``.  Managed singleton per device
    type."""

    comm: Any = _WORLD.get(device_type)
    if comm is None or refresh:
        sess = default_session(refresh=refresh, device_type=device_type)
        comm = _WORLD[device_type] = Communicator.from_group(
            sess.group("repro://world"), tag="repro://world"
        )
    return comm


def local_ranks(comm: Communicator) -> np.ndarray:
    """Host-side rank layout (for tests and IO): the rank each grid
    position holds."""

    return np.arange(math.prod(comm.shape)).reshape(comm.shape)
