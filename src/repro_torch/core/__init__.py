"""repro_torch.core — the interface layer of the port: typed errors, the
MPI_T-style pvar/cvar registry, sessions and groups over the process world,
communicators with their collectives, Cartesian topologies and requests
(futures, and persistent requests that replay CUDA graphs on the card)."""

from repro_torch.core import _methods  # noqa: F401  (binds the method facade)
from repro_torch.core.futures import (  # noqa: F401
    DeferredFuture,
    Future,
    PartitionedRequest,
    PersistentCollective,
    PersistentRequest,
    when_all,
    when_any,
)
