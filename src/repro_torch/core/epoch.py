"""Elastic communicator epochs: ULFM-style shrink/grow on the Sessions
model — :mod:`repro.core.epoch` over the ranks of a process world.

The ULFM fault-tolerance proposal (MPI's error classes 75/76) spells the
recovery loop as: detect → ``MPI_Comm_revoke`` → ``MPI_Comm_shrink`` →
rebuild from the survivor group → continue.  The Sessions model makes that
loop constructive: process sets are re-enumerable, groups have the full
algebra (``Group.difference`` is the shrink), and
``Communicator.from_group`` is the one constructor a rebuilt fabric routes
through.

:class:`CommEpoch` is a **generation-numbered bundle** of

* the session **process set** the epoch registers
  (``repro://epoch/<name>/<g>``),
* the member :class:`~repro_torch.core.session.Group`: the **pool** (every
  rank enrolled, survivors first, in the order they joined) and the
  **active** group, its leading ``prod(dims)`` members,
* the :class:`~repro_torch.core.communicator.Communicator` over the active
  group (a :class:`~repro_torch.core.topology.CartComm` when the epoch's
  :class:`TopologySpec` has periods), built lazily,
* a **cache** of state derived from the fabric (the trainer's step request,
  a gradient sync), built once per epoch and gone with it.

On a failure the runtime revokes the epoch (every further use raises
``ERR_REVOKED``), shrinks the pool (``Group.difference``) and builds
generation ``g+1``; :meth:`CommEpoch.grow` hot-joins new members and
re-folds the elastic axis.  Survivors that do not fold onto the topology
keep their place in the pool but get no communicator (``MPI_COMM_NULL``:
their ``comm.rank()`` is ``UNDEFINED``) until a later grow folds them in.

What the port adds, because ranks are processes and the fabric lives on
the card:

* **Who builds the groups.**  A ``torch.distributed`` group is made by
  every rank of the process world, in the same order (``new_group`` is
  collective over the world).  So every rank of the world — members,
  evicted and idle ranks alike — runs every epoch transition and builds
  every generation's communicator; a rank outside the active group holds
  the communicator but no member rank in it.  Every shrink and grow first
  meets all ranks of the world at a barrier on the default group's store
  (its time limit is :data:`TRANSITION_TIMEOUT`, not a collective's), so
  that no group is destroyed while a member still uses it, and a rank that
  idles ahead of the others waits there.
* **Revoke releases.**  :meth:`CommEpoch.revoke` also releases what the
  epoch holds on the card: each cached value's ``release()`` (a
  :class:`~repro_torch.core.futures.PersistentRequest` drops its CUDA graph
  and the graph's memory pool), the cache itself, and the process groups
  the epoch made (under :func:`~repro_torch.core.communicator.group_scope`:
  never shared, so destroying them, NCCL communicators included, touches
  no other communicator).  A communicator the epoch adopted at generation
  0 belongs to its caller and is left alone.  Generations pile up neither
  device memory nor communicators.
* **Fold order.**  A process group orders its ranks by global rank, and
  DTensor's shards follow that order along every mesh dim; so the
  communicator folds the active members in global-rank order (the
  reference folds them in pool order; the members are the same).

Groups and specs are device-agnostic, so the epoch algebra (generations,
shrink/grow, the cache) works on groups of any members; only
:attr:`CommEpoch.comm` needs a process world.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist

from repro_torch.core import errors, tool
from repro_torch.core.communicator import Communicator, group_scope, release_groups
from repro_torch.core.session import Group, RankDevice, Session, default_session

tool.pvar_register("epoch:create", "communicator epochs constructed (generation 0)")
tool.pvar_register("epoch:advance", "epoch transitions (shrink + grow)")
tool.pvar_register("epoch:revoke", "epochs revoked (MPI_Comm_revoke analogue)")
tool.pvar_register("epoch:rebuild", "communicator fabrics built from an epoch's group")
tool.pvar_register(
    "epoch:request_rebuild",
    "per-epoch cached derivations built (persistent requests, topologies)",
)

#: The elastic-dimension placeholder in a :class:`TopologySpec` shape.
ELASTIC = -1

_EPOCH_PSET_PREFIX = "repro://epoch/"

#: How long a rank waits at a transition for the rest of the world: an
#: evicted or idle rank walks the schedule without computing and may reach
#: the next transition long before the members that train.
TRANSITION_TIMEOUT = datetime.timedelta(minutes=30)

# the owners of the epochs' process groups, and the transitions of this
# process world (every rank counts the same ones)
_OWNERS = itertools.count()
_TRANSITIONS = itertools.count()


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """How an epoch folds its group onto a fabric.

    ``shape`` may mark at most one dimension :data:`ELASTIC` (``-1``); it
    resolves to ``floor(size / prod(fixed))`` at fold time, so the same spec
    describes the topology at every world size.  ``periods=None`` builds a
    plain multi-axis communicator; a periods tuple builds a Cartesian
    topology (:func:`repro_torch.core.topology.cart_create`) with the
    resolved dims.
    """

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    periods: tuple[bool, ...] | None = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if self.periods is not None:
            object.__setattr__(self, "periods", tuple(bool(p) for p in self.periods))
        errors.check(
            len(self.shape) == len(self.axis_names),
            errors.ErrorClass.ERR_DIMS,
            f"{len(self.axis_names)} axis names for shape {self.shape}",
        )
        errors.check(
            self.periods is None or len(self.periods) == len(self.shape),
            errors.ErrorClass.ERR_DIMS,
            f"{len(self.periods or ())} periods for shape {self.shape}",
        )
        errors.check(
            sum(d == ELASTIC for d in self.shape) <= 1,
            errors.ErrorClass.ERR_DIMS,
            f"at most one elastic (-1) dimension, got shape {self.shape}",
        )
        errors.check(
            all(d > 0 for d in self.shape if d != ELASTIC),
            errors.ErrorClass.ERR_DIMS,
            f"fixed dims must be positive, got shape {self.shape}",
        )

    @property
    def is_cart(self) -> bool:
        return self.periods is not None

    @property
    def fixed_size(self) -> int:
        """Product of the non-elastic dims — the fold granularity."""

        return math.prod(d for d in self.shape if d != ELASTIC)

    def resolve(self, size: int) -> tuple[int, ...]:
        """Concrete dims for a group of ``size`` members: the elastic dim
        becomes ``floor(size / fixed_size)`` (``ERR_DIMS`` when not even one
        fold fits).  Members beyond ``prod(dims)`` do not fold — they idle
        (``MPI_COMM_NULL``) until a grow makes the count divisible."""

        fixed = self.fixed_size
        errors.check(
            size >= fixed,
            errors.ErrorClass.ERR_DIMS,
            f"{size} members cannot fold onto {self.shape} (needs at least {fixed})",
        )
        if ELASTIC not in self.shape:
            return self.shape
        return tuple(size // fixed if d == ELASTIC else d for d in self.shape)

    @classmethod
    def from_plan(cls, plan) -> "TopologySpec":
        """The spec a :class:`~repro_torch.configs.base.ParallelPlan` folds
        to: the plan's fixed axes stay fixed, the data axis is marked
        :data:`ELASTIC` so the same plan re-folds at every survivor count."""

        dims = plan.fold_dims()
        return cls((ELASTIC,) + tuple(dims[1:]), plan.fold_axes(), plan.fold_periods())

    @classmethod
    def from_communicator(cls, comm: Communicator, *, elastic_axis: int = 0) -> "TopologySpec":
        """Derive a spec from an existing communicator: its axes and sizes,
        with ``elastic_axis`` marked elastic (the data axis by convention).
        Cartesian communicators keep their periods."""

        from repro_torch.core import topology

        shape = tuple(ELASTIC if i == elastic_axis else int(d)
                      for i, d in enumerate(comm.shape))
        periods = comm.periods if isinstance(comm, topology.CartComm) else None
        return cls(shape, comm.axis_names, periods)


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c in "_-" else "_" for c in name) or "epoch"


def _ranked(group: Group) -> bool:
    """The members are ranks of a process world."""

    return group.size() > 0 and all(isinstance(m, RankDevice) for m in group.devices)


def _fold_order(group: Group) -> Group:
    """The members in the order the fabric folds them: ranks by global rank
    (a process group's own order), other members as they are."""

    if not _ranked(group):
        return group
    return Group(sorted(group.devices, key=lambda m: m.rank))


class CommEpoch:
    """One generation of a rebuildable communication fabric.

    The epoch owns a **pool** (every member currently enrolled, survivors in
    fold order) and derives from it the **active** group — the leading
    ``prod(dims)`` members after :meth:`TopologySpec.resolve` — plus the
    communicator and any cached per-epoch state.  The fabric is built
    lazily: the epoch algebra works on plain groups.

    Lifecycle (the ULFM loop)::

        epoch = CommEpoch.create(comm)          # generation 0 adopts comm
        ...
        epoch.revoke()                          # MPI_Comm_revoke
        epoch = epoch.shrink([dead_rank])       # MPI_Comm_shrink -> gen+1
        step = epoch.cached("train_step", build)  # rebuilt lazily
        ...
        epoch = epoch.grow(spare_ranks)         # hot-join -> gen+1
    """

    def __init__(
        self,
        pool: Group,
        spec: TopologySpec,
        *,
        session: Session | None = None,
        name: str = "train",
        generation: int = 0,
        _comm: Communicator | None = None,
    ):
        errors.check(
            isinstance(pool, Group) and pool.size() > 0,
            errors.ErrorClass.ERR_GROUP,
            "an epoch needs a non-empty member Group",
        )
        self.pool = pool
        self.spec = spec
        self.name = _sanitize(name)
        self.generation = int(generation)
        self._session = session
        self._revoked = False
        self._comm = _comm
        self._cache: dict[str, Any] = {}
        # the owner of the process groups this epoch makes (none if adopted)
        self._owner = None if _comm is not None else ("epoch", next(_OWNERS))
        #: the process groups the revoke destroyed
        self.destroyed: list = []
        self.dims = spec.resolve(pool.size())
        #: the active group: leading prod(dims) pool members, fold order
        self.active = pool.incl(range(math.prod(self.dims)))
        if generation == 0:
            tool.pvar_count("epoch:create")

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls,
        comm_or_group: Communicator | Group,
        spec: TopologySpec | None = None,
        *,
        session: Session | None = None,
        name: str = "train",
    ) -> "CommEpoch":
        """Generation 0.  From a :class:`Communicator`, the epoch *adopts*
        it — the existing fabric stays live and the spec defaults to
        :meth:`TopologySpec.from_communicator`.  From a :class:`Group`,
        ``spec`` is required and the fabric is built lazily."""

        if isinstance(comm_or_group, Communicator):
            comm = comm_or_group
            derived = TopologySpec.from_communicator(comm)
            spec = spec if spec is not None else derived
            # adopt the live fabric only when the requested spec IS the
            # comm's own shape — a Cartesian spec over a plain communicator
            # must rebuild through cart_create
            return cls(comm.group(), spec, session=session, name=name,
                       _comm=comm if spec == derived else None)
        errors.check(
            spec is not None,
            errors.ErrorClass.ERR_ARG,
            "CommEpoch.create from a Group needs an explicit TopologySpec",
        )
        return cls(comm_or_group, spec, session=session, name=name)

    # -- liveness ------------------------------------------------------------

    @property
    def revoked(self) -> bool:
        return self._revoked

    def revoke(self) -> None:
        """``MPI_Comm_revoke``: mark the epoch dead.  Idempotent.  Every
        subsequent fabric access raises ``ERR_REVOKED`` — consumers must
        re-derive from the successor epoch.  The first revoke also releases
        the cached state (each value's ``release()``: a persistent
        request's CUDA graph) and destroys the process groups the epoch
        made.  Cooperative: nothing interrupts work in flight, and every
        rank of the world revokes at the same point of its schedule."""

        if self._revoked:
            return
        tool.pvar_count("epoch:revoke")
        self._revoked = True
        for value in self._cache.values():
            release = getattr(value, "release", None)
            if callable(release):
                release()
        self._cache.clear()
        self._comm = None
        self.destroyed = release_groups(self._owner)

    def _live(self) -> None:
        if self._revoked:
            errors.fail(
                errors.ErrorClass.ERR_REVOKED,
                f"epoch {self.generation} of {self.name!r} is revoked; "
                f"re-derive from the successor epoch",
            )

    # -- the fabric ----------------------------------------------------------

    @property
    def session(self) -> Session:
        if self._session is None:
            first = self.pool.device(0)
            device = first.device if isinstance(first, RankDevice) else first
            kind = device.type if isinstance(device, torch.device) else "cuda"
            self._session = default_session(device_type=kind)
        return self._session

    @property
    def pset_name(self) -> str:
        return f"{_EPOCH_PSET_PREFIX}{self.name}/{self.generation}"

    @property
    def comm(self) -> Communicator:
        """The epoch's communicator, built lazily from the active group via
        the canonical constructors (``Communicator.from_group`` /
        ``cart_create``) and registered as the epoch's process set.
        Collective over the process world the first time."""

        self._live()
        if self._comm is None:
            self._comm = self._build_comm()
        return self._comm

    @property
    def member(self) -> bool:
        """This process is a rank of the active group (it computes in this
        epoch; the others idle, ``MPI_COMM_NULL``)."""

        return self.active.rank() >= 0

    def _build_comm(self) -> Communicator:
        from repro_torch.core import topology

        tool.pvar_count("epoch:rebuild")
        self.session.register_pset(self.pset_name, self.active)
        members = _fold_order(self.active)
        with group_scope(self._owner):
            if self.spec.is_cart:
                # epoch-scoped cart tag: membership changes across
                # generations, so the dims-keyed default tag would trip the
                # clobber guard
                dims_str = "x".join(str(d) for d in self.dims)
                return topology.cart_create(
                    members, self.dims, self.spec.periods, axis_names=self.spec.axis_names,
                    session=self.session, tag=f"{self.pset_name}/cart/{dims_str}")
            return Communicator.from_group(members, tag=self.pset_name, shape=self.dims,
                                           axis_names=self.spec.axis_names)

    def axis_size(self, name: str) -> int:
        return self.dims[self.spec.axis_names.index(name)]

    # -- per-epoch derived state (persistent requests, topologies, buckets) --

    def cached(self, key: str, build: Callable[["CommEpoch"], Any]) -> Any:
        """Derived state bound to THIS epoch's fabric, built lazily once.

        The canonical tenant is the trainer's step request, bound to the
        epoch's placements (and, on the card, a CUDA graph over its
        buffers): consumers ask the *current* epoch, and the successor
        rebuilds it here on first use — lazy, exactly once per (epoch,
        key)."""

        self._live()
        if key not in self._cache:
            tool.pvar_count("epoch:request_rebuild")
            self._cache[key] = build(self)
        return self._cache[key]

    def peek(self, key: str) -> Any | None:
        """The cached value if already built (no build trigger)."""

        return self._cache.get(key)

    def invalidate(self, key: str | None = None) -> None:
        if key is None:
            self._cache.clear()
        else:
            self._cache.pop(key, None)

    # -- the ULFM transitions --------------------------------------------------

    def barrier(self) -> None:
        """Every rank of the process world meets here, members of this
        epoch or not (a no-op without a process world behind the pool).
        Its time limit is :data:`TRANSITION_TIMEOUT`."""

        if not (_ranked(self.pool) and dist.is_initialized()):
            return
        store = dist.distributed_c10d._get_default_store()
        key = f"repro_torch/epoch/transition/{next(_TRANSITIONS)}"
        if store.add(key, 1) == dist.get_world_size():
            store.set(key + "/all", "1")
        store.wait([key + "/all"], TRANSITION_TIMEOUT)

    def _successor(self, pool: Group) -> "CommEpoch":
        errors.check(
            pool.size() > 0,
            errors.ErrorClass.ERR_PROC_FAILED,
            f"epoch {self.generation} of {self.name!r} has no survivors",
        )
        tool.pvar_count("epoch:advance")
        return CommEpoch(pool, self.spec, session=self._session, name=self.name,
                         generation=self.generation + 1)

    def _as_devices(self, members: Iterable[Any]) -> list[Any]:
        """Ranks (ints, resolved in the ACTIVE group) or members, mixed."""

        return [self.active.device(m) if isinstance(m, int) else m for m in members]

    def shrink(self, dead: Iterable[Any] | Group) -> "CommEpoch":
        """``MPI_Comm_shrink``: the successor epoch over the survivor pool
        (``Group.difference``).  ``dead`` is a Group, or an iterable of
        members / active-group ranks.  Revokes this epoch; ``ERR_PROC_FAILED``
        when no member survives."""

        dead_group = dead if isinstance(dead, Group) else Group(self._as_devices(dead))
        self.barrier()
        self.revoke()
        return self._successor(self.pool.difference(dead_group))

    def grow(self, new_members: Iterable[Any] | Group) -> "CommEpoch":
        """The reverse path: hot-join ``new_members`` (appended in pool
        order — ``Group.union`` keeps survivors' ranks stable) and re-fold
        the elastic axis.  Revokes this epoch.  No new members is legal: it
        advances the generation over the same pool."""

        new_group = new_members if isinstance(new_members, Group) else Group(new_members)
        self.barrier()
        self.revoke()
        return self._successor(self.pool.union(new_group))

    def __repr__(self) -> str:
        state = "revoked" if self._revoked else "live"
        return (f"CommEpoch({self.name!r}, gen={self.generation}, dims={self.dims}, "
                f"pool={self.pool.size()}, {state})")
