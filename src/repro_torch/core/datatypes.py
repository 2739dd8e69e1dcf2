"""Automatic datatype generation via aggregate reflection (paper §II, C2) —
:mod:`repro.core.datatypes` over tensors.

The paper uses Boost.PFR to introspect aggregate classes at compile time and
derive ``MPI_Datatype``\\ s automatically.  Here, as in the reference, Python
aggregates (dataclasses, named tuples, dicts, sequences) are introspected
with :mod:`dataclasses` reflection and a :class:`DataType` is derived: the
tree structure plus a *packed layout* — leaves grouped by dtype and raveled
into one contiguous buffer per dtype group, so a single collective (or one
file fragment) moves the whole object.

The ``mpi::compliant`` concept maps onto :func:`is_compliant`: Python
``bool/int/float/complex`` (to torch's ``bool/int32/float32/complex64``,
as the reference maps them to jnp's), enumerations (as int32), tensors and
numpy arrays of a numeric dtype, and tuples, lists, dicts and dataclasses
of compliant members, recursively.  The reference's
``DataType.shape_dtype_structs`` (stand-ins for AOT lowering) has no
counterpart: eager PyTorch lowers nothing ahead of time.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Hashable

import numpy as np
import torch

from repro_torch.core import errors
from repro_torch.core.futures import flatten, unflatten

#: Explicit arithmetic-type → dtype mapping (the reference's, in torch).
_SCALAR_DTYPES: dict[type, torch.dtype] = {
    bool: torch.bool,
    int: torch.int32,
    float: torch.float32,
    complex: torch.complex64,
}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``float32``, ``bfloat16``,
    ``bool``): the name the reference's layouts and manifests record."""

    return str(dtype).removeprefix("torch.")


def _numpy_to_torch(dtype) -> torch.dtype | None:
    dtype = np.dtype(dtype)
    if dtype.kind not in "biufc":
        return None
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def _leaf_dtype(value: Any) -> torch.dtype | None:
    """dtype if ``value`` is a compliant *leaf*, else ``None``."""

    if isinstance(value, enum.Enum):
        return torch.int32
    t = builtin_type(value)
    if t in _SCALAR_DTYPES:
        return _SCALAR_DTYPES[t]
    if isinstance(value, torch.Tensor):
        return value.dtype
    if isinstance(value, (np.ndarray, np.generic)):
        return _numpy_to_torch(value.dtype)
    return None


def builtin_type(value: Any) -> type:
    # bool is a subclass of int: test in declaration order.
    for t in (bool, int, float, complex):
        if builtins_isinstance(value, t):
            return t
    return type(value)


def builtins_isinstance(value: Any, t: type) -> bool:
    return isinstance(value, t) and type(value) in (bool, int, float, complex)


def is_compliant(value: Any) -> bool:
    """The ``mpi::compliant`` concept, evaluated on an instance.  ``None``
    is compliant only as an aggregate *member*, as in the reference."""

    if _leaf_dtype(value) is not None:
        return True
    if isinstance(value, (tuple, list)):
        return all(_member_compliant(v) for v in value)
    if isinstance(value, dict):
        return all(isinstance(k, Hashable) for k in value) and all(
            _member_compliant(v) for v in value.values()
        )
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        register_aggregate(type(value))
        return all(
            _member_compliant(getattr(value, f.name))
            for f in dataclasses.fields(value)
        )
    return False


def _member_compliant(value: Any) -> bool:
    return value is None or is_compliant(value)


# ---------------------------------------------------------------------------
# Aggregate reflection (the Boost.PFR analogue)
# ---------------------------------------------------------------------------

_REGISTERED: set[type] = set()


def register_aggregate(cls: type) -> type:
    """Reflect a dataclass (idempotent; usable as a decorator).  The port's
    tree walk (:func:`repro_torch.core.futures.flatten`) already reads any
    dataclass's fields in declaration order, so registering only checks
    that ``cls`` is an aggregate and records it."""

    if cls in _REGISTERED:
        return cls
    errors.check(
        dataclasses.is_dataclass(cls),
        errors.ErrorClass.ERR_TYPE,
        f"{cls!r} is not an aggregate (dataclass) and cannot be reflected",
    )
    _REGISTERED.add(cls)
    return cls


def _ensure_registered(obj: Any) -> None:
    """Walk an aggregate, registering every unregistered dataclass type."""

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        register_aggregate(type(obj))
        for f in dataclasses.fields(obj):
            _ensure_registered(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _ensure_registered(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            _ensure_registered(v)


# ---------------------------------------------------------------------------
# DataType: tree structure + packed layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _LeafLayout:
    shape: tuple[int, ...]
    dtype: torch.dtype
    group: int       # index of the dtype group this leaf packs into
    offset: int      # element offset within the group buffer
    size: int        # number of elements


@dataclasses.dataclass(frozen=True)
class DataType:
    """Derived datatype: how an aggregate maps onto contiguous buffers.

    ``pack`` produces one 1-D tensor per distinct leaf dtype (a *dtype
    group*); ``unpack`` restores the aggregate, with Python scalars and
    enums coming back as 0-d tensors (as the reference's come back as 0-d
    arrays).
    """

    treedef: Any
    leaves: tuple[_LeafLayout, ...]
    group_dtypes: tuple[torch.dtype, ...]
    group_sizes: tuple[int, ...]

    @property
    def extent(self) -> int:
        """Total packed size in bytes (``MPI_Type_get_extent`` analogue)."""

        return int(sum(s * d.itemsize for s, d in zip(self.group_sizes, self.group_dtypes)))

    def pack(self, obj: Any) -> list[torch.Tensor]:
        """Aggregate → list of contiguous per-dtype buffers, on the device
        of the aggregate's first tensor (the CPU without one)."""

        leaves = flatten(obj)[0]
        errors.check(
            len(leaves) == len(self.leaves),
            errors.ErrorClass.ERR_COUNT,
            f"object has {len(leaves)} leaves, datatype describes {len(self.leaves)}",
        )
        device = next((v.device for v in leaves if isinstance(v, torch.Tensor)), None)
        parts: list[list[torch.Tensor]] = [[] for _ in self.group_dtypes]
        for value, layout in zip(leaves, self.leaves):
            arr = _as_array(value, layout.dtype, device)
            errors.check(
                tuple(arr.shape) == layout.shape,
                errors.ErrorClass.ERR_TRUNCATE,
                f"leaf shape {tuple(arr.shape)} does not match datatype {layout.shape}",
            )
            parts[layout.group].append(arr.reshape(-1))
        return [torch.cat(p) if len(p) > 1 else p[0].contiguous() for p in parts]

    def unpack(self, buffers: list[torch.Tensor]) -> Any:
        """Per-dtype buffers → aggregate."""

        errors.check(
            len(buffers) == len(self.group_dtypes),
            errors.ErrorClass.ERR_COUNT,
            f"expected {len(self.group_dtypes)} buffers, got {len(buffers)}",
        )
        leaves = []
        for layout in self.leaves:
            buf = buffers[layout.group]
            piece = buf[layout.offset:layout.offset + layout.size]
            leaves.append(piece.reshape(layout.shape).to(layout.dtype))
        return unflatten(self.treedef, leaves)

    def page_bounds(self, num_pages: int) -> list[list[tuple[int, int]]]:
        """Even page split of each packed group buffer: per group, a list of
        ``(offset, length)`` pairs (lengths differ by at most one element)
        — the paging a file view stores one fragment per page with."""

        errors.check(
            num_pages >= 1,
            errors.ErrorClass.ERR_COUNT,
            f"page_bounds needs >= 1 page, got {num_pages}",
        )
        return [even_page_bounds(size, num_pages) for size in self.group_sizes]

    def layout_signature(self) -> dict:
        """JSON-able description of the packed layout (group dtypes and
        element counts) — what a :class:`repro_torch.core.io.File` view
        records in the manifest, under the reference's dtype names, so that
        a reader's ``set_view`` is validated against the writer's."""

        return {
            "groups": [
                {"dtype": dtype_name(d), "size": int(s)}
                for d, s in zip(self.group_dtypes, self.group_sizes)
            ]
        }


def even_page_bounds(size: int, num_pages: int) -> list[tuple[int, int]]:
    """``num_pages`` contiguous ``(offset, length)`` spans covering ``size``
    elements, lengths differing by at most one (later pages may be empty when
    ``size < num_pages``)."""

    base, rem = divmod(int(size), int(num_pages))
    bounds, offset = [], 0
    for p in range(num_pages):
        length = base + (1 if p < rem else 0)
        bounds.append((offset, length))
        offset += length
    return bounds


def _as_array(value: Any, dtype: torch.dtype, device=None) -> torch.Tensor:
    if isinstance(value, enum.Enum):
        value = value.value
    if isinstance(value, (np.ndarray, np.generic)):
        value = torch.from_numpy(np.array(value))
    return torch.as_tensor(value, dtype=dtype, device=device)


_DATATYPE_CACHE: dict[Any, DataType] = {}


def datatype_of(obj: Any) -> DataType:
    """Derive (and cache) the :class:`DataType` of an aggregate instance.

    The cache key is the structural signature (tree structure + leaf
    shapes/dtypes), so derivation cost is paid once per *type*, mirroring
    the paper's compile-time generation.
    """

    _ensure_registered(obj)
    leaves, treedef = flatten(obj)
    layouts_raw = []
    for leaf in leaves:
        dt = _leaf_dtype(leaf)
        if dt is None:
            errors.fail(
                errors.ErrorClass.ERR_TYPE,
                f"leaf of type {type(leaf).__name__} is not mpi-compliant",
            )
        shape = tuple(np.shape(leaf)) if not isinstance(leaf, enum.Enum) else ()
        layouts_raw.append((shape, dt))
    key = (treedef, tuple(layouts_raw))
    cached = _DATATYPE_CACHE.get(key)
    if cached is not None:
        return cached

    group_index: dict[torch.dtype, int] = {}
    group_sizes: list[int] = []
    layouts: list[_LeafLayout] = []
    for shape, dtype in layouts_raw:
        g = group_index.setdefault(dtype, len(group_index))
        if g == len(group_sizes):
            group_sizes.append(0)
        size = int(np.prod(shape)) if shape else 1
        layouts.append(_LeafLayout(shape, dtype, g, group_sizes[g], size))
        group_sizes[g] += size

    dt = DataType(
        treedef=treedef,
        leaves=tuple(layouts),
        group_dtypes=tuple(group_index.keys()),
        group_sizes=tuple(group_sizes),
    )
    _DATATYPE_CACHE[key] = dt
    return dt


def pack(obj: Any) -> tuple[list[torch.Tensor], DataType]:
    """Convenience: derive the datatype and pack in one call."""

    dt = datatype_of(obj)
    return dt.pack(obj), dt


def unpack(buffers: list[torch.Tensor], dt: DataType) -> Any:
    return dt.unpack(buffers)


# ---------------------------------------------------------------------------
# Communication adapter: apply a buffer-level collective to any aggregate
# ---------------------------------------------------------------------------


def apply_packed(fn, obj: Any):
    """Run ``fn`` (a collective over a single 1-D buffer) on every packed
    buffer of ``obj`` and restore the aggregate: one message per dtype
    group, not one per leaf (paper Listing 1)."""

    dt = datatype_of(obj)
    buffers = dt.pack(obj)
    out = [fn(b) for b in buffers]
    return dt.unpack(out)
