"""The Sessions model (MPI 4.0 §11) over the ranks of a process world.

A :class:`Session` enumerates the ranks of the default
``torch.distributed`` process group, one device per rank (``cuda:<local
rank>``, or the CPU when ``device_type="cpu"``), into named process sets —
``repro://world``, ``repro://self``, ``repro://host/<i>``,
``repro://platform/<type>`` and ``repro://slice/<k>`` — plus user-registered
sets.  Each member is a :class:`RankDevice`.  If no process group exists,
the session initialises one: from ``RANK`` / ``WORLD_SIZE`` (``env://``, as
``torchrun`` sets them) when they are set, otherwise a world of one.  The
backend is NCCL for ``cuda`` and gloo for ``cpu``; the card never falls back
to gloo.

A slice (the reference's TPU pod slice: devices joined by the fast fabric,
slices joined by the slow one) is a port-only reading: a member that
carries a ``slice_index`` (as the reference's devices do, and the tests'
fakes) is in the slice it names; otherwise, in a world that spans several
hosts, a slice is one host, since NVLink joins the cards inside a node and
the NIC links nodes.  A world on one host has no slice sets, as a TPU
backend that reports no slices has none.

:class:`Group` is the immutable ordered member set with the full MPI group
algebra, copied from :mod:`repro.core.session`.

A session over ``cuda`` on a machine with no CUDA device raises
``ERR_SESSION``: the port never falls back to the CPU on its own; the caller
asks for it with ``device_type="cpu"``.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import os
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import errors

#: ``MPI_UNDEFINED`` analogue for rank queries that have no answer.
UNDEFINED = -1

#: The builtin process-set namespace.  ``mpi://`` spellings are accepted as
#: aliases (``mpi://world`` → ``repro://world``).
_SCHEME = "repro://"
_ALIAS_SCHEME = "mpi://"

WORLD_PSET = _SCHEME + "world"
SELF_PSET = _SCHEME + "self"

_BUILTIN_PREFIXES = (f"{_SCHEME}host/", f"{_SCHEME}platform/", f"{_SCHEME}slice/")

#: Device types a session can enumerate.
DEVICE_TYPES = ("cuda", "cpu")

#: Process-group backend of each device type.  A process that computes on
#: the card also keeps CPU tensors on gloo (a CPU-side communicator beside
#: the card's, as the card-against-CPU checks use); CUDA tensors always go
#: through NCCL.
BACKENDS = {"cuda": "cpu:gloo,cuda:nccl", "cpu": "gloo"}

#: Timeout of every process group the port creates: a rank that dies
#: leaves its peers blocked in a collective for at most this long.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

#: Session-registered Cartesian process sets: ``repro://cart/<dims>``.
CART_PSET_PREFIX = _SCHEME + "cart/"


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One member of the process world: a rank of the default process
    group and the device it computes on."""

    rank: int
    device: torch.device


def _is_builtin_pset(name: str) -> bool:
    return name in (WORLD_PSET, SELF_PSET) or name.startswith(_BUILTIN_PREFIXES)


class GroupComparison(enum.Enum):
    """``MPI_Group_compare`` results."""

    IDENT = "ident"        # same members, same order
    SIMILAR = "similar"    # same members, different order
    UNEQUAL = "unequal"


class Group:
    """Immutable ordered set of devices (``MPI_Group``).

    Rank *r* in the group is position *r* in :attr:`devices`.  All algebra
    follows MPI ordering rules: ``union`` keeps ``self``'s order then appends
    ``other``'s new members; ``intersection`` and ``difference`` are ordered
    by ``self``.
    """

    __slots__ = ("_devices", "_index")

    def __init__(self, devices: Iterable[Any] = ()):
        seen: dict[Any, int] = {}
        for d in devices:
            if d not in seen:
                seen[d] = len(seen)
        self._devices = tuple(seen)
        self._index = seen

    # -- introspection -----------------------------------------------------

    @property
    def devices(self) -> tuple[Any, ...]:
        return self._devices

    def size(self) -> int:
        """``MPI_Group_size``."""

        return len(self._devices)

    def rank(self, device: Any = None) -> int:
        """``MPI_Group_rank``: the calling process's rank, or
        :data:`UNDEFINED` if it is not a member.

        The SPMD analogue of "the calling process" is this host's first
        device that belongs to the group; pass ``device`` explicitly to ask
        about a specific member (``rank(dev)``).
        """

        if device is not None:
            return self._index.get(device, UNDEFINED)
        for d in _local_devices_safe():
            r = self._index.get(d)
            if r is not None:
                return r
        return UNDEFINED

    def device(self, rank: int) -> Any:
        """The member at ``rank`` (inverse of :meth:`rank`)."""

        errors.check(
            0 <= rank < len(self._devices),
            errors.ErrorClass.ERR_RANK,
            f"rank {rank} out of range for group of size {len(self._devices)}",
        )
        return self._devices[rank]

    def __len__(self) -> int:
        return len(self._devices)

    def __bool__(self) -> bool:
        return bool(self._devices)

    def __iter__(self):
        return iter(self._devices)

    def __contains__(self, device: Any) -> bool:
        return device in self._index

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Group) and self._devices == other._devices

    def __hash__(self) -> int:
        return hash(self._devices)

    def __repr__(self) -> str:
        return f"Group(size={len(self._devices)})"

    # -- algebra -----------------------------------------------------------

    def union(self, other: "Group") -> "Group":
        """``MPI_Group_union``: self's members, then other's new members."""

        return Group(self._devices + other._devices)

    def intersection(self, other: "Group") -> "Group":
        """``MPI_Group_intersection``: members of both, ordered by self."""

        return Group(d for d in self._devices if d in other)

    def difference(self, other: "Group") -> "Group":
        """``MPI_Group_difference``: members of self not in other."""

        return Group(d for d in self._devices if d not in other)

    __or__ = union
    __and__ = intersection
    __sub__ = difference

    def incl(self, ranks: Sequence[int]) -> "Group":
        """``MPI_Group_incl``: the subgroup at ``ranks``, in that order."""

        ranks = list(ranks)
        errors.check(
            len(set(ranks)) == len(ranks),
            errors.ErrorClass.ERR_RANK,
            f"incl ranks must be distinct: {ranks}",
        )
        return Group(self.device(r) for r in ranks)

    def excl(self, ranks: Sequence[int]) -> "Group":
        """``MPI_Group_excl``: everything but ``ranks``, order preserved."""

        ranks = list(ranks)
        errors.check(
            len(set(ranks)) == len(ranks),
            errors.ErrorClass.ERR_RANK,
            f"excl ranks must be distinct: {ranks}",
        )
        drop = {self.device(r) for r in ranks}
        return Group(d for d in self._devices if d not in drop)

    def translate_ranks(self, ranks: Sequence[int], other: "Group") -> list[int]:
        """``MPI_Group_translate_ranks``: where self's ``ranks`` sit in
        ``other`` (:data:`UNDEFINED` for non-members)."""

        return [other.rank(self.device(r)) for r in ranks]

    def compare(self, other: "Group") -> GroupComparison:
        """``MPI_Group_compare``."""

        if self._devices == other._devices:
            return GroupComparison.IDENT
        if set(self._devices) == set(other._devices):
            return GroupComparison.SIMILAR
        return GroupComparison.UNEQUAL


def platform_devices(device_type: str = "cuda") -> tuple[torch.device, ...]:
    """The devices of one type this process can use: every visible CUDA
    device, or the one CPU device."""

    errors.check(
        device_type in DEVICE_TYPES,
        errors.ErrorClass.ERR_ARG,
        f"unknown device type {device_type!r}; known: {DEVICE_TYPES}",
    )
    if device_type == "cpu":
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


#: The members this process is, one per device type it opened a session on.
_LOCAL: dict[str, RankDevice] = {}


def _local_devices_safe() -> tuple[Any, ...]:
    # this process's own world members, then every device it can see
    return tuple(_LOCAL.values()) + platform_devices("cuda") + platform_devices("cpu")


def _local_world_size(world: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def _rank_device(device_type: str, rank: int, world: int) -> torch.device:
    """The device of ``rank``: ranks fill each host's CUDA devices in order
    (``cuda:<rank mod local world size>``); every rank's CPU is ``cpu``."""

    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % _local_world_size(world))


def process_world(device_type: str = "cuda") -> tuple[int, int]:
    """(rank, world size) of the default process group, initialising it if
    none exists: from ``RANK`` / ``WORLD_SIZE`` when set, otherwise a world
    of one over an in-process store.  A world of more than one rank must
    run ``device_type``'s wire (NCCL for ``cuda``, gloo for ``cpu``)."""

    backend = BACKENDS[device_type]
    wire = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            if device_type == "cuda":
                torch.cuda.set_device(_rank_device("cuda", rank, world))
            dist.init_process_group(backend, timeout=GROUP_TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=GROUP_TIMEOUT)
    rank, world = dist.get_rank(), dist.get_world_size()
    errors.check(
        world == 1 or wire in str(dist.get_backend()).lower(),
        errors.ErrorClass.ERR_SESSION,
        f"a {device_type} session over {world} ranks needs the {wire} backend; the "
        f"default process group runs {dist.get_backend()}",
    )
    return rank, world


def _normalize(name: str) -> str:
    name = name.lower()
    if name.startswith(_ALIAS_SCHEME):
        name = _SCHEME + name[len(_ALIAS_SCHEME):]
    return name


class Session:
    """``MPI_Session``: a handle onto the named process sets of one device
    type.  :meth:`finalize` closes it, after which every query raises
    ``ERR_SESSION``.  Usable as a context manager."""

    def __init__(
        self,
        devices: Sequence[Any] | None = None,
        *,
        info: Mapping | None = None,
        device_type: str = "cuda",
    ):
        self.device_type = device_type
        self._local: RankDevice | None = None
        if devices is None:
            devices = self._world_members()
        self._devices = tuple(devices)
        errors.check(
            len(self._devices) > 0,
            errors.ErrorClass.ERR_SESSION,
            "a session needs at least one device",
        )
        self.info = dict(info or {})
        self._finalized = False
        self._psets: dict[str, tuple[Any, ...]] = {}
        self._enumerate()

    @classmethod
    def init(
        cls,
        devices: Sequence[Any] | None = None,
        *,
        info: Mapping | None = None,
        device_type: str = "cuda",
    ) -> "Session":
        """``MPI_Session_init``."""

        return cls(devices, info=info, device_type=device_type)

    # -- platform enumeration ----------------------------------------------

    def _world_members(self) -> tuple[RankDevice, ...]:
        """Every rank of the process world (initialised here if need be),
        one :class:`RankDevice` each; this process's own is ``_local``."""

        device_type = self.device_type
        errors.check(
            len(platform_devices(device_type)) > 0,
            errors.ErrorClass.ERR_SESSION,
            f"no {device_type} device is visible; pass device='cpu' "
            f"(--device cpu) to run on the CPU",
        )
        rank, world = process_world(device_type)
        devices = tuple(RankDevice(r, _rank_device(device_type, r, world))
                        for r in range(world))
        self._local = _LOCAL[device_type] = devices[rank]
        errors.check(
            self._local.device.type == "cpu"
            or self._local.device.index < torch.cuda.device_count(),
            errors.ErrorClass.ERR_SESSION,
            f"rank {rank} computes on {self._local.device}, but this process sees "
            f"{torch.cuda.device_count()} CUDA devices",
        )
        return devices

    def _enumerate(self) -> None:
        self._psets[WORLD_PSET] = self._devices
        self._psets[SELF_PSET] = ((self._local,) if self._local in self._devices
                                  else self._devices)
        local_world = _local_world_size(len(self._devices))
        by_host: dict[int, list[Any]] = {}
        by_platform: dict[str, list[Any]] = {}
        for d in self._devices:
            host = d.rank // local_world if isinstance(d, RankDevice) else 0
            by_host.setdefault(host, []).append(d)
            dev = d.device if isinstance(d, RankDevice) else d
            by_platform.setdefault(getattr(dev, "type", "unknown"), []).append(d)
        for host, devs in sorted(by_host.items()):
            self._psets[f"{_SCHEME}host/{host}"] = tuple(devs)
        for platform, devs in sorted(by_platform.items()):
            self._psets[f"{_SCHEME}platform/{platform}"] = tuple(devs)
        # slices: a member's own slice_index where it has one, else the
        # hosts of a world that spans several
        by_slice: dict[int, list[Any]] = {}
        for d in self._devices:
            s = getattr(d, "slice_index", None)
            if s is not None:
                by_slice.setdefault(s, []).append(d)
        if not by_slice and len(by_host) > 1:
            by_slice = by_host
        for s, devs in sorted(by_slice.items()):
            self._psets[f"{_SCHEME}slice/{s}"] = tuple(devs)

    # -- lifecycle ---------------------------------------------------------

    def refresh(self, devices: Sequence[Any] | None = None) -> "Session":
        """Re-enumerate the world (elastic resize): the builtin process sets
        are rebuilt from the current members; user-registered sets keep
        only the members that are still there, and a set whose members all
        vanished is dropped (a pset naming a rank that is gone is a stale
        handle, the bug ULFM's revoke exists to prevent).

        ``devices`` overrides the enumeration (by default every rank of the
        process world), so that a test can model members that disappear
        and reappear between refreshes."""

        self._live()
        user = {k: v for k, v in self._psets.items() if not _is_builtin_pset(k)}
        self._devices = tuple(self._world_members() if devices is None else devices)
        self._psets = {}
        self._enumerate()
        alive = set(self._devices)
        for name, members in user.items():
            survivors = tuple(d for d in members if d in alive)
            if survivors:
                self._psets[name] = survivors
        return self

    @property
    def finalized(self) -> bool:
        return self._finalized

    def finalize(self) -> None:
        """``MPI_Session_finalize``.  Idempotent."""

        self._finalized = True

    def __enter__(self) -> "Session":
        self._live()
        return self

    def __exit__(self, *exc) -> None:
        self.finalize()

    def _live(self) -> None:
        if self._finalized:
            errors.fail(
                errors.ErrorClass.ERR_SESSION,
                "session is finalized (MPI_Session_finalize was called)",
            )

    # -- process-set discovery ---------------------------------------------

    def num_psets(self) -> int:
        """``MPI_Session_get_num_psets``."""

        self._live()
        return len(self._psets)

    def psets(self) -> list[str]:
        """All process-set names (``MPI_Session_get_nth_pset``, vectorised)."""

        self._live()
        return list(self._psets)

    def pset(self, name: str) -> tuple[Any, ...]:
        """The device tuple behind a named process set."""

        self._live()
        key = _normalize(name)
        errors.check(
            key in self._psets,
            errors.ErrorClass.ERR_ARG,
            f"unknown process set {name!r}; known: {list(self._psets)}",
        )
        return self._psets[key]

    def pset_info(self, name: str) -> dict:
        """``MPI_Session_get_pset_info`` (the standard mandates ``mpi_size``)."""

        devs = self.pset(name)
        return {"mpi_size": len(devs), "size": len(devs), "name": _normalize(name)}

    def group(self, name: str = WORLD_PSET) -> Group:
        """``MPI_Group_from_session_pset``."""

        return Group(self.pset(name))

    # -- user-registered sets ----------------------------------------------

    def register_pset(self, name: str, members: "Group | Sequence[Any]") -> str:
        """Register a user process set (over devices or an existing group).
        Returns the normalised name.  Builtin sets cannot be shadowed."""

        self._live()
        key = _normalize(name)
        errors.check(
            not _is_builtin_pset(key),
            errors.ErrorClass.ERR_ARG,
            f"cannot shadow builtin process set {name!r}",
        )
        devices = tuple(
            dict.fromkeys(members.devices if isinstance(members, Group) else members)
        )
        errors.check(
            len(devices) > 0, errors.ErrorClass.ERR_GROUP, f"process set {name!r} is empty"
        )
        known = set(self._devices)
        for d in devices:
            errors.check(
                d in known,
                errors.ErrorClass.ERR_GROUP,
                f"device {d} of pset {name!r} is not part of this session",
            )
        self._psets[key] = devices
        return key

    def register_mesh_psets(self, comm, *, prefix: str = _SCHEME + "mesh") -> list[str]:
        """Expose a communicator's sub-grids as process sets: for each axis
        ``a`` and index ``i``, ``<prefix>/<a>/<i>`` holds the members of the
        sub-grid with ``a`` fixed to ``i`` (row-major over the other axes) —
        the session-native spelling of "the i-th data-parallel replica" /
        "the i-th pipeline stage".  The reference takes a mesh; the port's
        communicator is its members folded onto a named grid."""

        self._live()
        grid = np.arange(len(comm.group().devices)).reshape(comm.shape)
        names = []
        for axis_pos, axis in enumerate(comm.axis_names):
            for i in range(comm.shape[axis_pos]):
                sub = comm.group().incl(grid.take(i, axis=axis_pos).reshape(-1).tolist())
                names.append(self.register_pset(f"{prefix}/{axis}/{i}", sub))
        return names

    def __repr__(self) -> str:
        state = "finalized" if self._finalized else f"{len(self._psets)} psets"
        return f"Session(devices={len(self._devices)}, {state})"


_DEFAULT: dict[str, Session] = {}


def default_session(refresh: bool = False, device_type: str = "cuda") -> Session:
    """The process-default session of one device type.  ``refresh=True``
    re-enumerates the world in place (elastic resize; user process sets
    are pruned, not dropped); a finalized default is replaced."""

    sess = _DEFAULT.get(device_type)
    if sess is None or sess.finalized:
        sess = _DEFAULT[device_type] = Session.init(device_type=device_type)
    elif refresh:
        sess.refresh()
    return sess
