"""The event ledger — layer 1 of the communication-correctness analyzer
(the MUST / MPI-Checker role for this interface), :mod:`repro.analysis.events`
for the port.

MUST observes an MPI program by interposing on the profiling interface and
recording one event per communication call per rank; checkers then walk the
event graph for defects the type system cannot rule out (mismatched
collective order, wait-for cycles, leaked requests).  The reference traces a
single-controller SPMD program, so one recorded event there describes the
operation for every rank at once, and its ledger also accepts explicitly
per-rank events (``rank=``) for multi-controller traces.

**Port-only choice: per-rank recording.**  The port is multi-process, one
process per rank, as MPI and MUST see a program.  Every hook of the port's
interface records with ``rank=`` the communicator rank of its process, so
each process's ledger holds its own rank's events only — the path the
reference keeps for multi-controller traces.  A run over several ranks
writes one ledger file a rank (:func:`dump`); :func:`merge` reads them back
into one ledger, keying each rank's process-local ids (future and request
tokens, windows, checkpoint managers) by its rank, and the checkers walk
the merged ledger.  Files, not a gather: a run with mismatched collectives
or a wait-for cycle may hang, and that is what the checkers exist to report
(:mod:`repro_torch.analysis.lint`).  A point-to-point matching round
recorded per rank carries the whole round's permutation; the deadlock
checker takes from it that rank's own operations, and matches the k-th
round of a communicator on one rank with the k-th on the others, as MPI
matches them in order.

The hooks run in Python when the interface is called.  Inside a captured
CUDA graph (a persistent request's steady state, :mod:`repro_torch.core.
futures`) they therefore run at the capture and at each ``start()``, not
at a replay: a replay calls no Python.  That matches the reference's
trace-time semantics, where a hook runs when the step is traced, not when
the compiled executable runs.

Recording is **off by default** and toggled by the ``analysis_recording``
control variable (:mod:`repro_torch.core.tool`).  The interface layers
guard every hook on the module-level :data:`RECORDING` bool, so the
disabled cost is one attribute read.

This module is import-light on purpose (no ``repro_torch.core`` imports): the
core layers import it at module scope without cycles.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
from pathlib import Path
from typing import Any, Iterable, Sequence

#: Hot-path guard.  The interface layers read this module attribute directly
#: (``if events.RECORDING: events.record(...)``); everything else — ledger
#: allocation, locking, metadata extraction — happens only when it is True.
RECORDING = False

_LOCK = threading.Lock()
_TOKENS = itertools.count(1)

#: the ``data`` fields that name a process-local object (a future or request
#: token, a window, a checkpoint manager, a file handle's split collective),
#: which :func:`merge` keys by rank
_LOCAL_IDS = ("token", "win", "mgr", "path")


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded communication/lifecycle event.

    ``ranks`` is the rank set the event applies to (``None`` = every rank of
    the communicator is implied, the SPMD default); ``data`` holds
    kind-specific fields (perms, dtype buckets, epoch ids, tokens).
    """

    seq: int
    kind: str
    comm: str = ""
    op: str = ""
    ranks: tuple[int, ...] | None = None
    data: dict[str, Any] = dataclasses.field(default_factory=dict)


class Ledger:
    """Append-only event log plus the live-object tables the lifecycle
    checkers need (outstanding futures, window epochs)."""

    def __init__(self) -> None:
        self.events: list[Event] = []
        self._seq = itertools.count()

    def append(self, kind: str, **kw: Any) -> Event:
        data = kw.pop("data", None) or {}
        ev = Event(seq=next(self._seq), kind=kind, data=data, **kw)
        with _LOCK:
            self.events.append(ev)
        return ev

    def of_kind(self, *kinds: str) -> list[Event]:
        return [e for e in self.events if e.kind in kinds]

    def __len__(self) -> int:
        return len(self.events)


_LEDGER = Ledger()


def ledger() -> Ledger:
    return _LEDGER


def reset() -> Ledger:
    """Drop all recorded events (new empty ledger); returns it."""

    global _LEDGER
    _LEDGER = Ledger()
    return _LEDGER


def set_recording(enabled: bool) -> bool:
    """Toggle event recording; returns the previous value.  Normally driven
    by the ``analysis_recording`` cvar, not called directly."""

    global RECORDING
    prev = RECORDING
    RECORDING = bool(enabled)
    return prev


def process_rank() -> int:
    """This process's rank in the process world (0 without one): the
    ``rank=`` of a lifecycle event, whose object belongs to the process
    rather than to a communicator."""

    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def next_token() -> int:
    """A process-unique id for tracked objects (futures, requests, windows).
    Monotonic — never reused, unlike ``id()``."""

    return next(_TOKENS)


# ---------------------------------------------------------------------------
# per-rank ledgers: one file a rank, merged by the parent
# ---------------------------------------------------------------------------


def dump(path: str | Path, ledger: Ledger | None = None) -> Path:
    """Write ``ledger`` (by default this process's) to ``path``, one JSON
    object an event.  Values JSON cannot hold are written as their
    ``repr``."""

    ledger = ledger or _LEDGER
    path = Path(path)
    with _LOCK:
        events = list(ledger.events)
    path.write_text("".join(
        json.dumps({"kind": e.kind, "comm": e.comm, "op": e.op,
                    "ranks": list(e.ranks) if e.ranks is not None else None,
                    "data": e.data}, default=repr) + "\n"
        for e in events))
    return path


def load(path: str | Path) -> Ledger:
    """A ledger read back from a :func:`dump` file."""

    out = Ledger()
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        ev = json.loads(line)
        ranks = tuple(ev["ranks"]) if ev["ranks"] is not None else None
        out.append(ev["kind"], comm=ev["comm"], op=ev["op"], ranks=ranks, data=ev["data"])
    return out


def merge(ledgers: Iterable[Ledger]) -> Ledger:
    """One ledger from per-rank ledgers, in order (each rank's events keep
    their order).  A process-local id (a token, a window, a checkpoint
    manager, a file handle's path) of an event recorded with ``rank=`` is
    keyed by that rank, so that two processes' equal counters never name
    one object."""

    out = Ledger()
    for led in ledgers:
        for ev in led.events:
            data = dict(ev.data)
            if ev.ranks is not None and len(ev.ranks) == 1:
                for key in _LOCAL_IDS:
                    if key in data:
                        data[key] = f"{ev.ranks[0]}:{data[key]}"
            out.append(ev.kind, comm=ev.comm, op=ev.op, ranks=ev.ranks, data=data)
    return out


# ---------------------------------------------------------------------------
# typed record helpers (all no-ops unless RECORDING; callers still guard on
# the bool to keep the disabled path to one attribute read)
# ---------------------------------------------------------------------------


def _comm_size(comm: Any) -> int:
    size = getattr(comm, "size", None)
    return int(size()) if callable(size) else 0


def _span(ranks: Sequence[int]) -> str:
    """Process-world ranks, a contiguous run as ``a-b``."""

    ranks = list(ranks)
    if ranks and ranks == list(range(ranks[0], ranks[0] + len(ranks))):
        return f"{ranks[0]}-{ranks[-1]}"
    return ",".join(str(r) for r in ranks)


def comm_id(comm: Any) -> str:
    """A stable per-communicator key: tag + axis names + size, and, for a
    communicator over processes, its members' ranks in the process world
    (port-only: each process records its own rank's events, and two
    communicators of one shape over other processes are other
    communicators).  Distinct communicator objects over the same members
    compare equal on purpose — a ``dup()`` is ``MPI_IDENT`` and shares the
    match order."""

    if isinstance(comm, str):
        return comm
    tag = getattr(comm, "tag", "") or ""
    axes = ",".join(getattr(comm, "axis_names", ()) or ())
    key = f"{tag}|{axes}|{_comm_size(comm)}"
    global_ranks = getattr(comm, "global_ranks", None)
    members = global_ranks() if callable(global_ranks) else None
    return key + (f"|{_span(members)}" if members else "")


def _leaves(value: Any) -> list:
    if isinstance(value, dict):
        return [x for k in sorted(value, key=str) for x in _leaves(value[k])]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _leaves(v)]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return [x for f in dataclasses.fields(value) for x in _leaves(getattr(value, f.name))]
    return [value]


def dtype_bucket(value: Any) -> tuple[str, ...]:
    """The dtype-bucket signature of an operand aggregate: the sorted tuple
    of leaf dtype names — the C2 datatype key a collective is matched on."""

    names = []
    for leaf in _leaves(value):
        dt = getattr(leaf, "dtype", None)
        names.append(str(dt) if dt is not None else type(leaf).__name__)
    return tuple(sorted(names))


def _one(rank: int | None) -> tuple[int, ...] | None:
    return (int(rank),) if rank is not None else None


def record_collective(
    comm: Any,
    op: str,
    operand: Any = None,
    *,
    rank: int | None = None,
) -> None:
    """One collective call on ``comm`` (op kind + dtype bucket).  With
    ``rank`` the event applies to that rank only (per-rank traces: every
    hook of the port); otherwise to every rank of the communicator."""

    if not RECORDING:
        return
    ranks = (rank,) if rank is not None else tuple(range(_comm_size(comm)))
    _LEDGER.append(
        "collective",
        comm=comm_id(comm),
        op=op,
        ranks=ranks,
        data={"bucket": dtype_bucket(operand) if operand is not None else ()},
    )


def record_p2p_round(
    comm: Any,
    perm: Sequence[tuple[int, int]],
    *,
    mode: str = "sendrecv",
    op: str = "send_recv",
    size: int | None = None,
    rank: int | None = None,
) -> None:
    """One matching round of point-to-point traffic.

    ``mode="sendrecv"`` is the combined ``MPI_Sendrecv`` form (completes
    atomically; cycles are legal — every ring schedule is one).
    ``mode="sync"`` models unbuffered blocking sends issued before the
    matching receives — the schedule the deadlock checker must reject when
    the round's permutation contains a cycle.  With ``rank`` (port-only,
    every hook of the port) the event is that rank's part of the round.
    """

    if not RECORDING:
        return
    if size is None:
        size = _comm_size(comm)
    _LEDGER.append(
        "p2p_round",
        comm=comm_id(comm),
        op=op,
        ranks=_one(rank),
        data={"perm": tuple((int(s), int(d)) for s, d in perm),
              "mode": mode, "size": int(size)},
    )


def record_p2p(kind: str, rank: int, peer: int, *, comm: str = "", op: str = "") -> None:
    """A raw blocking ``send``/``recv`` op for one rank (per-rank traces and
    seeded-defect schedules)."""

    if not RECORDING:
        return
    _LEDGER.append(kind, comm=comm, op=op or kind, ranks=(int(rank),),
                   data={"peer": int(peer)})


def record(kind: str, **kw: Any) -> None:
    """Generic escape hatch (lifecycle hooks use the typed wrappers below)."""

    if not RECORDING:
        return
    _LEDGER.append(kind, **kw)


# -- future / request lifecycle ---------------------------------------------


def record_future_create(token: int, label: str = "", *, rank: int | None = None) -> None:
    if not RECORDING:
        return
    _LEDGER.append("tf_create", ranks=_one(rank),
                   data={"token": int(token), "label": label})


def record_future_consume(token: int, how: str = "get", *, rank: int | None = None) -> None:
    if not RECORDING:
        return
    _LEDGER.append("tf_consume", ranks=_one(rank), data={"token": int(token), "how": how})


def record_persistent_init(token: int, *, donated: bool, label: str = "",
                           rank: int | None = None) -> None:
    if not RECORDING:
        return
    _LEDGER.append(
        "preq_init", ranks=_one(rank),
        data={"token": int(token), "donated": bool(donated), "label": label}
    )


def record_persistent_start(
    token: int, *, donated: bool, prev_outstanding: bool, has_continuations: bool,
    rank: int | None = None,
) -> None:
    if not RECORDING:
        return
    _LEDGER.append(
        "preq_start", ranks=_one(rank),
        data={"token": int(token), "donated": bool(donated),
              "prev_outstanding": bool(prev_outstanding),
              "has_continuations": bool(has_continuations)},
    )


# -- RMA windows -------------------------------------------------------------


def record_fence(win: int, epoch: int, *, rank: int | None = None) -> None:
    if not RECORDING:
        return
    _LEDGER.append("win_fence", ranks=_one(rank), data={"win": int(win), "epoch": int(epoch)})


def record_rma_put(
    win: int, epoch: int, targets: Iterable[int], page: Any, *, requested: bool,
    rank: int | None = None,
) -> None:
    if not RECORDING:
        return
    _LEDGER.append(
        "rma_put", ranks=_one(rank),
        data={"win": int(win), "epoch": int(epoch),
              "targets": tuple(int(t) for t in targets),
              "page": page, "requested": bool(requested)},
    )


def record_rma_apply(win: int, issue_epoch: int, apply_epoch: int, *,
                     rank: int | None = None) -> None:
    if not RECORDING:
        return
    _LEDGER.append(
        "rma_apply", ranks=_one(rank),
        data={"win": int(win), "issue_epoch": int(issue_epoch),
              "apply_epoch": int(apply_epoch)},
    )


def record_rma_pages(kind: str, win: int, count: int, *, rank: int | None = None) -> None:
    """``kind`` ∈ {"rma_attach", "rma_detach"} — dynamic-window page
    registration traffic (mirrored from ``kvpool.bind_window``)."""

    if not RECORDING:
        return
    _LEDGER.append(kind, ranks=_one(rank), data={"win": int(win), "count": int(count)})


# -- file I/O / checkpoint ---------------------------------------------------


def record_io_split(kind: str, path: str, name: str, *, rank: int | None = None) -> None:
    """``kind`` ∈ {"io_split_begin", "io_split_end"} — File split
    collectives (one active per handle; unended begins are findings)."""

    if not RECORDING:
        return
    _LEDGER.append(kind, ranks=_one(rank), data={"path": path, "name": name})


def record_ckpt(kind: str, mgr: int, step: int | None = None, *,
                rank: int | None = None) -> None:
    """``kind`` ∈ {"ckpt_save", "ckpt_join"} — async checkpoint saves must
    be joined before the run exits."""

    if not RECORDING:
        return
    _LEDGER.append(kind, ranks=_one(rank), data={"mgr": int(mgr), "step": step})
