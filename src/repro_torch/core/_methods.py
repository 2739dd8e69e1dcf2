"""Paper-style method facade: binds the collective/future API onto
:class:`~repro_torch.core.communicator.Communicator`, as
:mod:`repro.core._methods` does, so user code reads like the paper's
examples::

    total = comm.immediate_allreduce(x).then(lambda f: ...).get()

Counters for the MPI_T pvar interface are incremented at this layer, under
the reference's names.  The immediate forms of ``send_recv`` and ``shift``
return a future over the pending point-to-point work; the other immediate
collectives run when issued (on the card they are queued on the stream) and
their future's ``get()`` waits for the device.
``comm.immediate_ring_allgather`` returns the ring gather's deferred future
(:class:`~repro_torch.core.overlap.RingAllGatherFuture`).  ``comm.persistent`` and the
persistent collectives (``allreduce_init`` and friends) bind
persistent requests (:class:`~repro_torch.core.futures.PersistentRequest`);
``comm.partitioned_allreduce`` a partitioned request
(:class:`~repro_torch.core.futures.PartitionedRequest`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import events
from repro_torch.core import collectives, datatypes, overlap, tool
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import (
    Future,
    PersistentCollective,
    PersistentRequest,
    argument_signature,
)

_BLOCKING = (
    "broadcast",
    "allreduce",
    "reduce",
    "reduce_scatter",
    "allgather",
    "gather",
    "scatter",
    "alltoall",
    "allgatherv",
    "alltoallv",
    "scan",
    "exscan",
    "send_recv",
    "shift",
    "barrier",
)
_IMMEDIATE = tuple(n for n in _BLOCKING if n not in ("allgatherv", "alltoallv"))


_STARTS = {"send_recv": collectives.send_recv_start, "shift": collectives.shift_start}


def _immediate(comm: Communicator, name: str, *a, **k) -> Future:
    if name in _STARTS:
        return _STARTS[name](comm, *a, **k)._track(f"immediate_{name}")
    return Future(getattr(collectives, name)(comm, *a, **k))._track(f"immediate_{name}")


def _bind() -> None:
    # blocking collectives (chapter 6)
    for name in _BLOCKING:
        fn = getattr(collectives, name)
        tool.pvar_register(name, f"blocking {name} calls issued (MPI_{name.capitalize()})")

        def method(self, *a, _fn=fn, _name=name, **k):
            tool.pvar_count(_name)
            if events.RECORDING and _name not in ("send_recv", "shift"):
                # send_recv/shift record a p2p matching round in
                # collectives.py instead (the deadlock checker's input)
                events.record_collective(self, _name, a[0] if a else None, rank=self.rank())
            return _fn(self, *a, **k)

        method.__name__ = name
        method.__doc__ = fn.__doc__
        setattr(Communicator, name, method)

    # immediate (future-returning) forms — requests as futures (C3)
    for name in _IMMEDIATE:
        tool.pvar_register(
            f"immediate_{name}",
            f"nonblocking {name} futures issued (MPI_I{name.capitalize()})",
        )

        def imethod(self, *a, _name=name, **k):
            tool.pvar_count(f"immediate_{_name}")
            if events.RECORDING and _name not in ("send_recv", "shift"):
                events.record_collective(self, _name, a[0] if a else None, rank=self.rank())
            return _immediate(self, _name, *a, **k)

        imethod.__name__ = f"immediate_{name}"
        imethod.__doc__ = f"Nonblocking {name}: returns a Future (MPI_I{name.capitalize()})."
        setattr(Communicator, f"immediate_{name}", imethod)

    # decomposed/overlappable forms
    tool.pvar_register("immediate_ring_allgather",
                       "ring-decomposed allgather futures (overlappable)")

    def immediate_ring_allgather(self, x, *, axis=0):
        tool.pvar_count("immediate_ring_allgather")
        if events.RECORDING:
            events.record_collective(self, "ring_allgather", x, rank=self.rank())
        return overlap.immediate_all_gather(self, x, axis=axis)

    immediate_ring_allgather.__doc__ = (
        "Ring-decomposed allgather: a :class:`~repro_torch.core.overlap."
        "RingAllGatherFuture` (``get()`` gathers, ``then_matmul`` fuses).")
    Communicator.immediate_ring_allgather = immediate_ring_allgather

    # persistent operations (MPI_*_init / MPI_Start)
    def persistent(self, fn, *example_args, donate_argnums=(), warm_start=False):
        return PersistentRequest(fn, example_args, donate_argnums=tuple(donate_argnums),
                                 warm_start=warm_start)

    persistent.__doc__ = (
        "Persistent operation over this communicator (``MPI_Send_init`` "
        "analogue): bind ``fn`` — this rank's step, which may call the "
        "communicator's collectives — to the example argument list and return "
        "a :class:`PersistentRequest`; on the card a donating request replays "
        "one CUDA graph from its second start."
    )
    Communicator.persistent = persistent

    for name, unpackable in (("allreduce", True), ("alltoall", True),
                             # shape-changing: raw per-dtype buckets for aggregates
                             ("reduce_scatter", False), ("allgather", False)):
        _bind_init(name, unpackable)

    # partitioned communication (MPI_Psend_init / MPI_Pready)
    def partitioned_allreduce(self, num_partitions, *, continuation=None):
        return overlap.partitioned_allreduce(self, num_partitions, continuation=continuation)

    partitioned_allreduce.__doc__ = overlap.partitioned_allreduce.__doc__
    Communicator.partitioned_allreduce = partitioned_allreduce


_LEAF_OPERANDS = (torch.Tensor, np.ndarray, np.generic, bool, int, float, complex)


def _persistent_collective(comm, name, example, *, unpackable=True, **opkw):
    """One request per dtype bucket of ``example``'s datatype (MPI 4.0
    §6.12); a single array binds one request on its own shape."""

    fn = getattr(collectives, name)

    def step(buf):
        return fn(comm, buf, **opkw)

    if isinstance(example, _LEAF_OPERANDS):
        return PersistentCollective(name, None, [PersistentRequest(step, (example,))])
    dt = datatypes.datatype_of(example)
    requests = [PersistentRequest(step, (buf,)) for buf in dt.pack(example)]
    return PersistentCollective(name, dt, requests, unpackable=unpackable,
                                signature=argument_signature(example))


def _bind_init(name: str, unpackable: bool) -> None:
    tool.pvar_register(
        f"{name}_init",
        f"persistent {name} constructors (MPI_{name.capitalize()}_init)",
    )

    def init_method(self, example, _name=name, _u=unpackable, **k):
        tool.pvar_count(f"{_name}_init")
        return _persistent_collective(self, _name, example, unpackable=_u, **k)

    init_method.__name__ = f"{name}_init"
    init_method.__doc__ = (
        f"Persistent {name} (``MPI_{name.capitalize()}_init``): bind one {name} "
        f"per dtype bucket of ``example``'s datatype; ``start(value)`` re-fires them."
    )
    setattr(Communicator, f"{name}_init", init_method)


_bind()
