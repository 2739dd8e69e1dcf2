"""Communicators (paper §II, C1/C4 — and MPI 4.0 §11 Sessions), single
process.

The reference's communicator is a JAX mesh plus a subset of its named axes.
The port's first slice runs in one process on one device type, so a
communicator here is the group's devices folded onto a named grid
(``shape`` / ``axis_names``) with no collective behind it yet.
:meth:`Communicator.from_group` stays the one canonical constructor
(``MPI_Comm_create_from_group``); :func:`world` is a shim over the default
session's ``repro://world`` pset.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from repro_torch.core import errors
from repro_torch.core.session import Group, default_session


def _axis_name_from_tag(tag: str) -> str:
    """Default axis name for a pset tag: its last path component, sanitised
    to an identifier (``repro://world`` → ``world``)."""

    leaf = tag.rsplit("/", 1)[-1] if tag else ""
    name = "".join(c if c.isalnum() or c == "_" else "_" for c in leaf)
    return name or "ranks"


class Communicator:
    """A named-axis communicator over the devices of one group."""

    def __init__(
        self,
        group: Group,
        shape: Sequence[int],
        axis_names: Sequence[str],
        *,
        managed: bool = False,
        tag: str = "",
    ):
        self._group = group
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.managed = managed
        self.tag = tag

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
        to fold the group onto a multi-axis grid (row-major rank order)."""

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

    def __copy__(self):  # copy ctor is "deleted"
        errors.fail(
            errors.ErrorClass.ERR_COMM,
            "communicators are not copyable",
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

    @property
    def device(self) -> torch.device:
        """The device of rank 0: where a single-device workload runs."""

        return self._group.device(0)

    def __repr__(self):
        kind = "managed" if self.managed else "unmanaged"
        tag = f", tag={self.tag!r}" if self.tag else ""
        return f"Communicator(axes={self.axis_names}, size={self.size()}, {kind}{tag})"


_WORLD: dict[str, Communicator] = {}


def world(refresh: bool = False, device_type: str = "cuda") -> Communicator:
    """The ``mpi::world_communicator`` analogue: one axis over all devices
    of ``device_type``.  Managed singleton per device type."""

    comm: Any = _WORLD.get(device_type)
    if comm is None or refresh:
        sess = default_session(refresh=refresh, device_type=device_type)
        comm = _WORLD[device_type] = Communicator.from_group(
            sess.group("repro://world"), tag="repro://world"
        )
    return comm
