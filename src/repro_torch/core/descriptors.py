"""Scoped enumerations, description objects and defaults (paper §II, C4).

The paper replaces MPI's loose ``int`` constants with scoped enumerations and
replaces long argument lists with *description objects*.  We mirror both:

* every operation selector is a :class:`enum.Enum` (``ReduceOp``,
  ``Algorithm``, ``ThreadLevel``, ``Mode``, ...) so erroneous values cannot be
  passed and editors can complete them;
* operations with many knobs accept a frozen dataclass descriptor
  (:class:`CollectiveSpec`, :class:`WindowSpec`, :class:`FileSpec`) carrying
  meaningful defaults, instead of positional argument soup.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


class ReduceOp(enum.Enum):
    """Scoped analogue of ``MPI_Op`` (MPI 4.0 §6.9.2)."""

    SUM = "sum"
    PROD = "prod"
    MAX = "max"
    MIN = "min"
    LAND = "land"   # logical and
    LOR = "lor"     # logical or
    LXOR = "lxor"
    BAND = "band"   # bitwise and
    BOR = "bor"
    BXOR = "bxor"
    MAXLOC = "maxloc"
    MINLOC = "minloc"
    # RMA-only operators (MPI 4.0 §12.3): REPLACE is valid for accumulate
    # (put-with-ordering semantics), NO_OP for get_accumulate/fetch_and_op
    # (pure fetch).  Collectives reject both with ERR_OP.
    REPLACE = "replace"
    NO_OP = "no_op"


class Algorithm(enum.Enum):
    """Collective algorithm selector.

    ``XLA`` emits the native XLA collective (the compiler schedules it);
    ``RING``/``BIDIRECTIONAL`` emit an explicitly decomposed ``ppermute``
    schedule whose per-step continuations can be fused with compute — the
    trace-level realisation of the paper's future continuations (C3).
    ``HIERARCHICAL`` splits a multi-axis reduction into intra/inter stages
    (reduce-scatter inside, all-reduce across, all-gather inside).
    """

    AUTO = "auto"
    XLA = "xla"
    RING = "ring"
    BIDIRECTIONAL = "bidirectional"
    HIERARCHICAL = "hierarchical"


class ThreadLevel(enum.Enum):
    """Analogue of ``MPI_THREAD_*`` — JAX dispatch is inherently
    ``MULTIPLE``-safe; kept for interface completeness."""

    SINGLE = "single"
    FUNNELED = "funneled"
    SERIALIZED = "serialized"
    MULTIPLE = "multiple"


class Mode(enum.Flag):
    """File access mode flags (``MPI_MODE_*``, MPI 4.0 §14.2.1)."""

    RDONLY = enum.auto()
    WRONLY = enum.auto()
    RDWR = enum.auto()
    CREATE = enum.auto()
    EXCL = enum.auto()
    APPEND = enum.auto()
    DELETE_ON_CLOSE = enum.auto()


class Compression(enum.Enum):
    """Payload compression for wide (cross-pod / DCN) reductions."""

    NONE = "none"
    INT8 = "int8"           # per-block-scaled int8 with error feedback


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """Description object for collectives (paper: "functions with a large
    number of arguments accept description objects").

    Attributes
    ----------
    op: reduction operator where applicable.
    algorithm: which lowering to use; ``AUTO`` picks ``XLA`` unless a fused
        continuation is attached to the returned future.
    num_chunks: decomposition granularity for ``RING``/``BIDIRECTIONAL``.
    compression: wire compression for reduction payloads (hierarchical DCN
        stage only, applied with error feedback by the caller).
    tiled: ``tiled=True`` concatenates along an existing axis rather than
        stacking a new one (mirrors ``jax.lax`` semantics).
    axis: operand axis the collective concatenates / scatters over.
    """

    op: ReduceOp = ReduceOp.SUM
    algorithm: Algorithm = Algorithm.AUTO
    num_chunks: int | None = None
    compression: Compression = Compression.NONE
    tiled: bool = True
    axis: int = 0


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Description object for one-sided windows (``MPI_Win_create``).

    Attributes
    ----------
    accumulate_op: the default operator for ``accumulate`` / ``raccumulate``
        / ``get_accumulate`` when no explicit op is passed (the
        ``accumulate_ops`` info-key analogue).
    no_locks: the ``no_locks`` info key.  Passive-target lock/unlock has no
        SPMD analogue (see the honesty note in :mod:`repro.core.onesided`),
        so only ``no_locks=True`` windows can be created; asking for lock
        support raises ``ERR_UNSUPPORTED_OPERATION`` instead of silently
        pretending.
    fence_barrier: emit an ``optimization_barrier`` at every ``fence`` so
        XLA cannot move operations across the epoch boundary.  Disable only
        when program order already pins the schedule (cheaper epochs).
    num_pages: default page count for paged transfers (``put``/``rput`` with
        ``page=(i, n)``); the paged-KV-block granularity.
    dynamic: ``MPI_Win_create_dynamic`` analogue.  The window starts with
        *no* pages attached; memory must be registered page-by-page with
        :meth:`~repro.core.onesided.Window.attach` before a ``put`` may
        target it (``ERR_RMA_RANGE`` otherwise, the dynamic-window
        out-of-range class).  ``attach``/``detach`` double as the
        sub-allocation free-list a paged KV block pool rides
        (:mod:`repro.runtime.kvpool`).  Dynamic windows are addressed at
        page granularity: full-window puts require every page attached.
    """

    accumulate_op: ReduceOp = ReduceOp.SUM
    no_locks: bool = True
    fence_barrier: bool = True
    num_pages: int = 1
    dynamic: bool = False


@dataclasses.dataclass(frozen=True)
class FileSpec:
    """Description object for parallel IO (``MPI_File_open``).

    Attributes
    ----------
    mode: access mode flags.  ``EXCL`` raises ``ERR_FILE`` when the dataset
        already exists — with or without ``CREATE``, matching
        ``MPI_ERR_FILE_EXISTS`` semantics.
    atomic: manifests are written atomically (tmp + rename).
    checksum: record per-fragment checksums and verify them on read.
    verify: read each fragment back after writing it and compare checksums
        before the write is reported complete (read-back verify — the
        durability check an async checkpoint save runs before committing its
        manifest).
    """

    mode: Mode = Mode.RDONLY
    atomic: bool = True          # manifests are written atomically
    checksum: bool = True
    verify: bool = False


DEFAULT_COLLECTIVE = CollectiveSpec()


def resolve(spec: CollectiveSpec | None, **overrides: Any) -> CollectiveSpec:
    """Meaningful defaults: merge a possibly-``None`` descriptor with keyword
    overrides (the paper's defaulted trailing arguments)."""

    base = spec if spec is not None else DEFAULT_COLLECTIVE
    if overrides:
        base = dataclasses.replace(base, **overrides)
    return base
