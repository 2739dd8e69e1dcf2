"""Tool interface (paper §II — MPI 4.0 chapter 15, ``MPI_T_``): the pvar/cvar
registry of :mod:`repro.core.tool`, and its hardware model for the roofline
with an NVIDIA H100's numbers in place of the TPU's.

**Port-only choice: dispatch counts in place of HLO counts.**  The
reference's roofline pvars come from a compiled XLA executable
(``cost_analysis`` and the HLO text).  The port has no executable: its dry
run (:mod:`repro_torch.launch.dryrun`) traces a step once on fake tensors
under a ``__torch_dispatch__`` mode that counts, one aten op at a time and
with no fusion, the op's flops (``torch.utils.flop_counter``'s formulas and
the port's kernels' own), the bytes it reads and writes, and each
collective's operand, result and wire bytes (:class:`CollectiveStats`).
:func:`flops_and_bytes` and :func:`roofline_terms` keep the reference's
names and return keys over that count.  The same mode records a step's
program as text (:mod:`repro_torch.core.hloanalysis`), which
:func:`parse_hlo_collectives` reads in place of HLO text.

* **pvars** are call-site counters (``pvar_count`` / ``pvar_add``), with a
  documented registry (``PVARS``) and an optional strict mode that rejects
  writes to unregistered names.
* **cvars** are a typed runtime configuration registry (error checking,
  the analyzer's event recording).
* **the hardware model** (:data:`PEAK_FLOPS_BF16` and friends, the
  reference's names) and the ring algorithm's wire bytes
  (:func:`_wire_factor`): what the tuner (:mod:`repro_torch.tune`) scores
  plans with, and the bounds ``chip_smoke.py`` holds kernels to.

Kernel launch counts are not pvars: each kernel wrapper keeps a plain
integer, fed through the launch-counter registry below, so that a CUDA graph
replay (which launches kernels without calling their wrappers) can add back
the launches its capture recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
from collections import Counter, defaultdict
from typing import Any, Callable, Iterator

from repro_torch.analysis import events as analysis_events
from repro_torch.core import errors

# --------------------------------------------------------------------------
# hardware model: one NVIDIA H100 SXM5 80GB, NVLink 4 inside a node
# --------------------------------------------------------------------------
#
# The reference's names, each meaning on this card:
#
# * PEAK_FLOPS_BF16 — dense bf16 tensor-core FLOP/s of one card (NVIDIA
#   H100 datasheet, SXM part, without sparsity; at the 700 W power limit);
# * HBM_BANDWIDTH — HBM3 bytes/s of one card (datasheet);
# * ICI_BANDWIDTH — the link between two cards of a node: NVLink 4, 900
#   GB/s a card in both directions together (datasheet), 450e9 a direction;
# * DCN_BANDWIDTH — across nodes: one 400 Gb/s NDR InfiniBand NIC a card,
#   50e9 bytes/s (the DGX H100's layout);
# * HBM_BYTES — ``torch.cuda.get_device_properties(0).total_memory`` as
#   read on an NVIDIA H100 80GB HBM3 (``tools/shard_ranks.py --tune``);
# * COLLECTIVE_LAUNCH_S — the fixed cost of one collective: the median
#   latency of an 8-byte NCCL ``all_reduce`` over four H100s joined by
#   NVLink, host launch included (``tools/shard_ranks.py --tune``).

PEAK_FLOPS_BF16 = 989e12     # FLOP/s per card
HBM_BANDWIDTH = 3.35e12      # bytes/s per card
ICI_BANDWIDTH = 450e9        # bytes/s per card and direction (NVLink 4)
DCN_BANDWIDTH = 50e9         # bytes/s per card (one 400 Gb/s NIC)
HBM_BYTES = 85_017_493_504   # bytes on the card: NVIDIA H100 80GB HBM3
COLLECTIVE_LAUNCH_S = 9.2746e-5  # seconds per collective: 92.7 µs

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
)


@dataclasses.dataclass
class CollectiveStats:
    """Aggregated collective pvars for one traced step (per device)."""

    count: dict[str, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    operand_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    result_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    wire_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )

    @property
    def total_operand_bytes(self) -> float:
        return float(sum(self.operand_bytes.values()))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.count.values()))

    def as_dict(self) -> dict[str, Any]:
        return {
            "count": dict(self.count),
            "operand_bytes": dict(self.operand_bytes),
            "result_bytes": dict(self.result_bytes),
            "wire_bytes": dict(self.wire_bytes),
            "total_operand_bytes": self.total_operand_bytes,
            "total_wire_bytes": self.total_wire_bytes,
        }


def flops_and_bytes(counted) -> tuple[float, float]:
    """(flops, bytes accessed) of one traced step on one device: ``counted``
    is the dry run's dispatch count (:class:`repro_torch.launch.dryrun.
    DispatchCount`, with ``flops`` and ``bytes``), where the reference reads
    an executable's ``cost_analysis``."""

    return float(counted.flops), float(counted.bytes)


def roofline_terms(
    counted,
    *,
    chips: int = 1,
    peak_flops: float = PEAK_FLOPS_BF16,
    hbm_bw: float = HBM_BANDWIDTH,
    link_bw: float = ICI_BANDWIDTH,
) -> dict[str, Any]:
    """The three roofline terms (seconds) for one traced step, the
    reference's keys.  ``counted`` is the dry run's dispatch count of one
    device's step (``flops``, ``bytes`` and ``collectives``, a
    :class:`CollectiveStats`); ``chips`` divides, for whole-model
    analyses, as in the reference."""

    flops, bytes_accessed = flops_and_bytes(counted)
    colls = counted.collectives
    terms = {
        "compute_s": flops / (chips * peak_flops),
        "memory_s": bytes_accessed / (chips * hbm_bw),
        "collective_s": colls.total_operand_bytes / (chips * link_bw),
        "collective_wire_s": colls.total_wire_bytes / (chips * link_bw),
        "hlo_flops": flops,
        "hlo_bytes": bytes_accessed,
        "collectives": colls.as_dict(),
    }
    terms["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]
    )
    return terms


def _wire_factor(kind: str, n: int) -> float:
    """Ring-algorithm bytes crossing one device's link, as a multiple of the
    payload (operand bytes for reductions, result bytes for gathers)."""

    if kind in ("collective-permute", "collective-broadcast"):
        # permutes/broadcasts move the payload once regardless of group
        # size; they carry source-target pairs, not replica_groups, so the
        # parsed group size (default 1) must not zero them out — ring
        # schedules and ch. 8 neighbor exchanges are all permutes, and
        # their wire bytes used to read as 0 here
        return 1.0
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * frac
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return frac
    return 1.0


def _add_collective(stats: CollectiveStats, kind: str, operand_bytes: float,
                    result_bytes: float, n: int) -> None:
    """Count one collective of ``kind`` over a group of ``n`` into
    ``stats``: its operand and result bytes, and its wire bytes (the
    operand for reductions, all-to-alls and permutes, the result for
    gathers and broadcasts, times :func:`_wire_factor`)."""

    payload = operand_bytes if kind in ("all-reduce", "reduce-scatter", "all-to-all",
                                        "collective-permute") else result_bytes
    stats.count[kind] += 1
    stats.operand_bytes[kind] += operand_bytes
    stats.result_bytes[kind] += result_bytes
    stats.wire_bytes[kind] += payload * _wire_factor(kind, n)


# --------------------------------------------------------------------------
# recorded programs (repro_torch.core.hloanalysis's text)
# --------------------------------------------------------------------------

#: bytes an element of each dtype name of a program's types (XLA's short
#: names); ``b<bits>`` names a dtype XLA has none for
DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "s16": 2, "u16": 2,
               "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
               "f64": 8, "c64": 8, "c128": 16}

_PROGRAM_HEADER_RE = re.compile(r"^# repro_torch program: (\d+) ops$")
_PROGRAM_LINE_RE = re.compile(r"^%(\d+) = (\S+?)\(([^()]*)\) -> \(([^()]*)\)((?: \w+=\S+)*)$")
_TYPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")


def _dtype_bytes(name: str) -> int:
    if name in DTYPE_BYTES:
        return DTYPE_BYTES[name]
    errors.check(name.startswith("b") and name[1:].isdigit(), errors.ErrorClass.ERR_ARG,
                 f"unknown dtype {name!r} in a recorded program")
    return int(name[1:]) // 8


def _type_bytes(segment: str) -> int:
    """Bytes of every ``<dtype>[<dims>]`` type in ``segment``."""

    total = 0
    for m in _TYPE_RE.finditer(segment):
        dims = m.group(2)
        total += (math.prod(int(d) for d in dims.split(",")) if dims else 1) * _dtype_bytes(
            m.group(1))
    return total


def _program_ops(text: str) -> Iterator[tuple[str, str, str, dict[str, str]]]:
    """(op, operands, results, attributes) of each op line of recorded
    program text (one program or several concatenated).  ``ERR_ARG`` on
    text without a program's header, a line that is not an op, or a
    program whose op count is not its header's."""

    errors.check(isinstance(text, str), errors.ErrorClass.ERR_ARG,
                 f"a recorded program's text is a str, got {type(text).__name__}")
    expected, seen, programs = None, 0, 0
    for raw in text.splitlines():
        header = _PROGRAM_HEADER_RE.match(raw)
        if header:
            errors.check(expected is None or seen == expected, errors.ErrorClass.ERR_ARG,
                         f"recorded program of {expected} ops has {seen} op lines")
            expected, seen, programs = int(header.group(1)), 0, programs + 1
            continue
        m = _PROGRAM_LINE_RE.match(raw)
        errors.check(m is not None and expected is not None, errors.ErrorClass.ERR_ARG,
                     f"not a line of a recorded program: {raw[:200]!r}")
        seen += 1
        attrs = dict(kv.split("=", 1) for kv in m.group(5).split())
        yield m.group(2), m.group(3), m.group(4), attrs
    errors.check(programs > 0, errors.ErrorClass.ERR_ARG,
                 "not a recorded program (no '# repro_torch program' header): "
                 "see repro_torch.core.hloanalysis")
    errors.check(seen == expected, errors.ErrorClass.ERR_ARG,
                 f"recorded program of {expected} ops has {seen} op lines")


def parse_hlo_collectives(hlo_text: str, default_group: int = 1) -> CollectiveStats:
    """Every collective of recorded program text
    (:mod:`repro_torch.core.hloanalysis`, in place of the reference's HLO
    text): per kind, the count, the operand and result bytes (from the
    types the line gives) and the ring-adjusted wire bytes over the line's
    group (``default_group`` where a line names none)."""

    stats = CollectiveStats()
    for _op, _operands, _results, attrs in _program_ops(hlo_text):
        kind = attrs.get("kind")
        if kind is None:
            continue
        _add_collective(stats, kind, float(_type_bytes(attrs["operand"])),
                        float(_type_bytes(attrs["result"])),
                        int(attrs.get("group", default_group)))
    return stats


# --------------------------------------------------------------------------
# control variables (cvars)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Cvar:
    name: str
    type: type
    value: Any
    doc: str
    on_set: Callable[[Any], None] | None = None


_CVARS: dict[str, _Cvar] = {}


def cvar_register(
    name: str, type_: type, default: Any, doc: str, on_set: Callable[[Any], None] | None = None
) -> None:
    _CVARS[name] = _Cvar(name, type_, default, doc, on_set)
    if on_set:
        on_set(default)


def cvar_set(name: str, value: Any) -> None:
    v = _CVARS.get(name)
    if v is None:
        errors.fail(errors.ErrorClass.ERR_ARG, f"unknown control variable {name!r}")
    if not isinstance(value, v.type):
        errors.fail(
            errors.ErrorClass.ERR_TYPE,
            f"cvar {name!r} expects {v.type.__name__}, got {type(value).__name__}",
        )
    v.value = value
    if v.on_set:
        v.on_set(value)


def cvar_get(name: str) -> Any:
    v = _CVARS.get(name)
    if v is None:
        errors.fail(errors.ErrorClass.ERR_ARG, f"unknown control variable {name!r}")
    return v.value


def cvar_list() -> dict[str, str]:
    return {v.name: v.doc for v in _CVARS.values()}


cvar_register(
    "error_checking",
    bool,
    True,
    "argument validation (the paper's compile-time macro)",
    on_set=errors.set_error_checking,
)

cvar_register(
    "analysis_recording",
    bool,
    False,
    "record communication events into the repro_torch.analysis ledger "
    "(MUST-style event-graph lint; off by default — disabled cost is one "
    "module-attribute read per call site)",
    on_set=analysis_events.set_recording,
)


# --------------------------------------------------------------------------
# pvar call-site counters
# --------------------------------------------------------------------------

pvar_counters: dict[str, int] = defaultdict(int)

# `+=` on a dict entry is not atomic, so updates take this lock
_PVAR_LOCK = threading.Lock()

#: Documented performance variables (``MPI_T_pvar_get_info`` analogue).
PVARS: dict[str, str] = {}


def pvar_register(name: str, doc: str) -> None:
    """Describe a pvar (idempotent).  Counting does not require prior
    registration — unknown counters still count — but registered pvars are
    enumerable via :func:`pvar_info` with a zero initial value."""

    PVARS.setdefault(name, doc)


#: When True, counting an unregistered pvar is an ``ERR_ARG`` instead of a
#: silent new counter.
PVAR_STRICT = False


def pvar_strict(enabled: bool) -> bool:
    """Toggle fail-fast on unregistered pvar writes; returns the previous
    value."""

    global PVAR_STRICT
    prev = PVAR_STRICT
    PVAR_STRICT = bool(enabled)
    return prev


def _pvar_check(op: str) -> None:
    if op not in PVARS:
        errors.fail(
            errors.ErrorClass.ERR_ARG,
            f"pvar {op!r} written but never registered — add a "
            f"pvar_register({op!r}, ...) where the counter is defined",
        )


#: Per thread, the open :func:`pvars_paused` blocks that pause counting.
_PAUSED = threading.local()


@contextlib.contextmanager
def pvars_paused(paused: bool = True) -> Iterator[None]:
    """Count no pvar in this thread inside the block, when ``paused``.  A
    persistent request that re-runs its step eagerly at every start pauses
    its counters after the first: the reference traces such a step once and
    counts its pvars at that trace.  Other threads (background file I/O)
    go on counting."""

    depth = getattr(_PAUSED, "depth", 0)
    _PAUSED.depth = depth + int(paused)
    try:
        yield
    finally:
        _PAUSED.depth = depth


def _paused() -> bool:
    return getattr(_PAUSED, "depth", 0) > 0


def pvar_count(op: str) -> None:
    if PVAR_STRICT:
        _pvar_check(op)
    if _paused():
        return
    with _PVAR_LOCK:
        pvar_counters[op] += 1


def pvar_add(op: str, amount: int) -> None:
    """Add to an accumulating pvar (byte counters and the like)."""

    if PVAR_STRICT:
        _pvar_check(op)
    if _paused():
        return
    with _PVAR_LOCK:
        pvar_counters[op] += int(amount)


def pvar_reset() -> None:
    with _PVAR_LOCK:
        pvar_counters.clear()


def pvar_read() -> dict[str, int]:
    counts = {name: 0 for name in PVARS}
    with _PVAR_LOCK:
        counts.update(pvar_counters)
    return counts


def pvar_info() -> dict[str, str]:
    return dict(PVARS)


# request-layer pvars (persistent / partitioned operations, C3)
pvar_register("persistent_init", "persistent requests initialised (argument list bound)")
pvar_register("persistent_start", "MPI_Start analogues fired on persistent requests")
pvar_register("partitioned_init", "partitioned requests constructed (Psend_init)")
pvar_register("partitioned_start", "partitioned request activations (MPI_Start)")
pvar_register("partition_ready", "partitions marked ready (MPI_Pready)")
pvar_register("cart_create", "Cartesian topologies constructed (MPI_Cart_create)")
pvar_register("dist_graph_create",
              "distributed graph topologies constructed (MPI_Dist_graph_create_adjacent)")
pvar_register("neighbor_allgather", "neighborhood allgathers issued (MPI_Neighbor_allgather)")
pvar_register("neighbor_alltoall", "neighborhood alltoalls issued (MPI_Neighbor_alltoall)")
pvar_register("neighbor_alltoallv", "vector neighborhood alltoalls issued (MPI_Neighbor_alltoallv)")
pvar_register("neighbor_alltoall_init",
              "persistent neighborhood alltoalls initialised (MPI_Neighbor_alltoall_init)")
pvar_register("rma_fence", "window fence epochs opened/closed (MPI_Win_fence)")
pvar_register("rma_put", "blocking window puts (MPI_Put)")
pvar_register("rma_rput", "request-based window puts (MPI_Rput)")
pvar_register("rma_get", "blocking window gets (MPI_Get)")
pvar_register("rma_rget", "request-based window gets (MPI_Rget)")
pvar_register("rma_accumulate", "window accumulates (MPI_Accumulate/Raccumulate)")
pvar_register("rma_attach", "pages attached to dynamic windows (MPI_Win_attach)")
pvar_register("rma_detach", "pages detached from dynamic windows (MPI_Win_detach)")


# --------------------------------------------------------------------------
# kernel launch counters
# --------------------------------------------------------------------------

#: C entry point of each hand-written kernel → the function that adds to its
#: wrapper's launch count (``kernels/*/kernel.py`` register at import).
_LAUNCH_COUNTERS: dict[str, Callable[[int], None]] = {}
#: Open :func:`recording_launches` blocks, innermost last.
_LAUNCH_RECORDINGS: list[Counter] = []


def launch_counter(symbol: str, add: Callable[[int], None]) -> Callable[[], None]:
    """Register the launch count of the kernel entry ``symbol``; ``add(n)``
    adds ``n`` to it.  Returns the function its wrapper calls once a launch:
    it counts the launch, or, inside :func:`recording_launches`, records it
    there instead (the launch was captured into a CUDA graph, not run)."""

    _LAUNCH_COUNTERS[symbol] = add

    def count() -> None:
        if _LAUNCH_RECORDINGS:
            _LAUNCH_RECORDINGS[-1][symbol] += 1
        else:
            add(1)

    return count


@contextlib.contextmanager
def recording_launches() -> Iterator[Counter]:
    """Divert the wrappers' launch counts into the yielded counter for the
    block's duration — a CUDA graph capture, which records kernels without
    running them.  Launches from every thread are diverted: the capture's
    backward runs in autograd's device thread."""

    recorded: Counter = Counter()
    _LAUNCH_RECORDINGS.append(recorded)
    try:
        yield recorded
    finally:
        _LAUNCH_RECORDINGS.remove(recorded)


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (a recording) to the wrappers' launch counts: what a
    replay of the recorded graph launched."""

    for symbol, n in counts.items():
        _LAUNCH_COUNTERS[symbol](n)
