"""The cost of a recorded step (the tool interface's deep pvar source),
:mod:`repro.core.hloanalysis` for the port.

**Port-only choice: a recorded program in place of XLA's HLO.**  The
reference walks the HLO text of a compiled XLA executable.  The port has no
executable.  The text here is the port's **recorded program**: the ordered
list of ops that one run of a step dispatches on one rank, one line an op,
written by :class:`Recorder` (a ``__torch_dispatch__`` mode).  It is not XLA
HLO; the module keeps the reference's names (:func:`analyze_hlo`,
:class:`HloCost`) for the mirror's sake.  The program is one rank's, where
the reference's module is one SPMD program: at an open end of a line of
ranks a rank sends less than its neighbours.

Python loops are unrolled as they run, so the program is flat: it needs no
trip-count correction, and the reference's nested computations
(``Computation``, ``parse_computations``) have no counterpart (ROADMAP A16).

**The text** (:meth:`Program.as_text`), one header line a program, then one
line an op::

    # repro_torch program: <n> ops
    %<i> = <op>(<operands>) -> (<results>) flops=<f> bytes=<b>
    %<i> = <op>(<operands>) -> (<results>) kind=<kind> group=<g> operand=<types> result=<types>

``<op>`` is the op's qualified name with its overload (``aten.mm.default``,
``c10d.allreduce_.default``, ``repro_torch.flash_attention_fwd.default``).
``<operands>`` and ``<results>`` are the tensors among its arguments and
among its outputs, in order, separated by a space, each as
``<dtype>[<d0>,<d1>,...]`` with XLA's short dtype names (``f32[8,16]``,
``bf16[]``; ``b<bits>`` for a dtype XLA has no name for).  A compute op
carries its ``flops`` (``torch.utils.flop_counter``'s formulas and the
port's kernels') and the ``bytes`` it moves (each input read once and each
output written once; the kernels' own formulas,
:data:`repro_torch.kernels.registry.BYTES_FORMULAS`; none for a view, an
allocation or a wait), both computed as it is recorded, since a formula
reads arguments the listing does not keep (a convolution's strides, an
attention kernel's causal flag).  A collective carries its ``kind`` (the
reference's names, :data:`repro_torch.core.tool.COLLECTIVE_KINDS`), the size
of its process group, and its operand and result tensors joined by ``+``;
:func:`repro_torch.core.tool.parse_hlo_collectives` turns them into operand,
result and wire bytes.  Concatenated programs (a persistent collective's
buckets) are read as one.

The dry run's dispatch count (:class:`repro_torch.launch.dryrun.
DispatchCount`) is this recorder: its ``flops``, ``bytes`` and
``collectives`` are the sums :func:`analyze_hlo` reads back from the text.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import errors
from repro_torch.core.tool import (
    CollectiveStats,
    _add_collective,
    _program_ops,
    parse_hlo_collectives,
)
from repro_torch.kernels.registry import NAMESPACE, tensor_bytes

try:  # torch >= 2.12
    from torch._guards import active_fake_mode
except ImportError:  # the fake mode on the dispatch stack, as it reads it
    from torch._guards import detect_fake_mode as active_fake_mode

#: collective op (``namespace.name`` of its packet) → (kind, index of its
#: operand argument, index of the argument it writes its result to, or
#: None: the op returns it)
COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", 0, None),
    "_c10d_functional.all_reduce_": ("all-reduce", 0, 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0, None),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0, None),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0, None),
    "_c10d_functional.broadcast": ("collective-broadcast", 0, None),
    "c10d.allreduce_": ("all-reduce", 0, 0),
    "c10d.broadcast_": ("collective-broadcast", 0, 0),
    "c10d.allgather_": ("all-gather", 1, 0),
    "c10d._allgather_base_": ("all-gather", 1, 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1, 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "c10d.alltoall_": ("all-to-all", 1, 0),
    "c10d.alltoall_base_": ("all-to-all", 1, 0),
    "c10d.send": ("collective-permute", 0, None),
}
#: ops that move no bytes of their own: allocations, metadata, waits (a
#: receive's bytes are its sender's permute)
_NO_TRAFFIC = ("aten.empty", "aten.empty_strided", "aten.empty_like", "prim.device",
               "aten.detach", "aten.lift_fresh", "aten._to_copy_meta",
               "_c10d_functional.wait_tensor", "c10d.recv_")

#: torch dtype → XLA's short name in a program's types
_DTYPE_NAMES = {
    torch.bool: "pred", torch.uint8: "u8", torch.int8: "s8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128",
}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _DTYPE_NAMES[getattr(torch, _name)] = "u" + _name[4:]
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _DTYPE_NAMES[getattr(torch, _name)] = "f8" + _name[7:]

#: the kernels' op names in a program (``repro_torch.<kernel>``)
KERNEL_PREFIX = NAMESPACE + "."


def _group_size(args) -> int:
    """The size of the process group a collective op names (a group name
    string, a ProcessGroup, or the ``torch.ScriptObject`` a ``c10d`` op
    receives in its place); 1 if none is found.  Host-only: a name resolves
    in the process's group registry, a script object unboxes.

    ROADMAP C29: a ``c10d`` op (what ``dist.all_reduce`` and its kin
    dispatch) receives its group as a ``torch.ScriptObject`` with no
    ``size`` of its own, which read as a group of 1: every such
    collective's wire bytes were 0."""

    import torch.distributed as dist

    for a in args:
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
        if isinstance(a, torch.ScriptObject):
            if not a._type().qualified_name().endswith(".c10d.ProcessGroup"):
                continue
            a = dist.ProcessGroup.unbox(a)
        if isinstance(a, dist.ProcessGroup):
            return int(a.size())
    return 1


def _tensors(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _types(tree: Any) -> tuple:
    """(dtype, shape) of every tensor of a nest: what a line lists."""

    return tuple((t.dtype, tuple(t.shape)) for t in _tensors(tree))


def _type_text(dtype: torch.dtype, shape: tuple) -> str:
    name = _DTYPE_NAMES.get(dtype) or f"b{8 * dtype.itemsize}"
    return f"{name}[{','.join(str(int(d)) for d in shape)}]"


@dataclasses.dataclass(frozen=True)
class Op:
    """One line of a program: an op, its tensors' types, and what it costs
    (a compute op) or moves (a collective)."""

    op: str
    operands: tuple
    results: tuple
    flops: int = 0
    bytes: int = 0
    kind: str | None = None
    group: int = 1
    operand: tuple = ()
    result: tuple = ()

    def as_text(self, index: int) -> str:
        head = (f"%{index} = {self.op}({' '.join(_type_text(*t) for t in self.operands)}) -> "
                f"({' '.join(_type_text(*t) for t in self.results)})")
        if self.kind is None:
            return f"{head} flops={self.flops} bytes={self.bytes}"
        joined = ["+".join(_type_text(*t) for t in ts) or "-" for ts in (self.operand,
                                                                          self.result)]
        return (f"{head} kind={self.kind} group={self.group} operand={joined[0]} "
                f"result={joined[1]}")


@dataclasses.dataclass
class Program:
    """The ops one run of a step dispatched on one rank, in order: the
    port's stand-in for a compiled module (``as_text()`` for the passes of
    :mod:`repro_torch.analysis.hlo`)."""

    ops: list[Op] = dataclasses.field(default_factory=list)

    def as_text(self) -> str:
        lines = [f"# repro_torch program: {len(self.ops)} ops"]
        lines += [op.as_text(i) for i, op in enumerate(self.ops)]
        return "\n".join(lines)

    def kernels(self) -> dict[str, int]:
        """Calls of each of the port's kernel ops (``repro_torch.<kernel>``,
        overload dropped): the launches the program makes on the card."""

        return dict(Counter(op.op.rsplit(".", 1)[0] for op in self.ops
                            if op.op.startswith(KERNEL_PREFIX)))


class Recorder(TorchDispatchMode):
    """A ``__torch_dispatch__`` mode that records one rank's run of a step
    as a :class:`Program` (``program``), and reads its sums: ``flops``,
    ``bytes``, ``collectives`` (a :class:`~repro_torch.core.tool.
    CollectiveStats`), ``ops`` and the port's kernels by op (``kernels``).

    It lets DTensor run first (it returns ``NotImplemented`` on DTensor
    arguments), so it sees the local ops of this rank; it skips the ops
    DTensor's sharding propagation runs under a fake mode of its own, as
    ``MemTracker`` does (the mode active when recording began is the
    step's).  It reads shapes, dtypes and group names only: inside a CUDA
    graph capture it neither syncs nor allocates.
    """

    def __init__(self):
        super().__init__()
        self.program = Program()
        self._entry_fake = None

    @property
    def flops(self) -> int:
        return sum(op.flops for op in self.program.ops)

    @property
    def bytes(self) -> int:
        return sum(op.bytes for op in self.program.ops)

    @property
    def ops(self) -> int:
        return len(self.program.ops)

    @property
    def kernels(self) -> dict[str, int]:
        return self.program.kernels()

    @property
    def collectives(self) -> CollectiveStats:
        stats = CollectiveStats()
        for op in self.program.ops:
            if op.kind is not None:
                _add_collective(stats, op.kind, _types_bytes(op.operand),
                                _types_bytes(op.result), op.group)
        return stats

    def __enter__(self):
        self._entry_fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._entry_fake:
            return out          # DTensor's sharding propagation
        try:
            self.program.ops.append(_op(func, args, kwargs, out))
        except errors.Error:
            raise
        except Exception as e:  # lint: allow-broad-except — re-raised typed, never dropped
            raise errors.exception(errors.ErrorClass.ERR_OTHER,
                                   f"recording the program: {func} failed: {e}") from e
        return out


def _types_bytes(types: tuple) -> int:
    return sum(math.prod(shape) * dtype.itemsize for dtype, shape in types)


def _op(func, args, kwargs, out) -> Op:
    """The line of one dispatched op: a collective's kind, group and
    tensors, or a compute op's flops and bytes."""

    from torch.utils.flop_counter import flop_registry

    from repro_torch.kernels.registry import BYTES_FORMULAS

    packet = func.overloadpacket
    name = packet._qualified_op_name.replace("::", ".")
    operands, results = _types((args, kwargs)), _types(out)
    coll = COLLECTIVE_OPS.get(name)
    if coll is not None:
        kind, operand_at, result_at = coll
        operand = args[operand_at]
        result = out if result_at is None else args[result_at]
        return Op(str(func), operands, results, kind=kind,
                  group=_group_size(list(args) + list(kwargs.values())),
                  operand=_types(operand), result=_types(result))
    flops = moved = 0
    flop = flop_registry.get(packet)
    if flop is not None:
        flops = int(flop(*args, **kwargs, out_val=out))
    if packet in BYTES_FORMULAS:
        moved = int(BYTES_FORMULAS[packet](args, kwargs, out))
    elif not func.is_view and name not in _NO_TRAFFIC:
        moved = tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
    return Op(str(func), operands, results, flops=flops, bytes=moved)


def record(fn, *args, **kwargs) -> tuple[Any, Program]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Recorder`: (its
    outputs, the program it dispatched on this rank)."""

    with Recorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.program


@dataclasses.dataclass
class HloCost:
    """One rank's program's flops, bytes accessed and collectives."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)


def analyze_hlo(hlo: str, default_group: int = 1) -> HloCost:
    """(flops, bytes, collectives) of one rank's recorded program text, one
    op at a time: the sums of the compute ops' ``flops`` and ``bytes``, and
    the collectives as :func:`~repro_torch.core.tool.parse_hlo_collectives`
    reads them (``default_group`` for a line without ``group=``).  Raises
    ``ERR_ARG`` on text that is not a whole recorded program."""

    cost = HloCost(collectives=parse_hlo_collectives(hlo, default_group))
    for _op, _operands, _results, attrs in _program_ops(hlo):
        if "kind" not in attrs:
            cost.flops += int(attrs["flops"])
            cost.bytes += int(attrs["bytes"])
    return cost
