"""Paper-style method facade: binds the collective/future API onto
:class:`~repro_torch.core.communicator.Communicator`, as
:mod:`repro.core._methods` does, so user code reads like the paper's
examples::

    total = comm.immediate_allreduce(x).then(lambda f: ...).get()

Counters for the MPI_T pvar interface are incremented at this layer, under
the reference's names.  The immediate forms of ``send_recv`` and ``shift``
return a future over the pending point-to-point work; the other immediate
collectives run when issued (on the card they are queued on the stream) and
their future's ``get()`` waits for the device.  Persistent and partitioned
collectives come with the training slice.
"""

from __future__ import annotations

from repro_torch.core import collectives, tool
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import Future

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
        return _STARTS[name](comm, *a, **k)
    return Future(getattr(collectives, name)(comm, *a, **k))


def _bind() -> None:
    # blocking collectives (chapter 6)
    for name in _BLOCKING:
        fn = getattr(collectives, name)
        tool.pvar_register(name, f"blocking {name} calls issued (MPI_{name.capitalize()})")

        def method(self, *a, _fn=fn, _name=name, **k):
            tool.pvar_count(_name)
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
            return _immediate(self, _name, *a, **k)

        imethod.__name__ = f"immediate_{name}"
        imethod.__doc__ = f"Nonblocking {name}: returns a Future (MPI_I{name.capitalize()})."
        setattr(Communicator, f"immediate_{name}", imethod)


_bind()
