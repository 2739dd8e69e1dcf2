"""repro_torch.core — the interface layer of the port: typed errors, the
MPI_T-style pvar/cvar registry, sessions and groups over the process world,
communicators with their collectives, Cartesian and graph topologies with
the neighborhood collectives, RMA windows and requests (futures, and
persistent requests that replay CUDA graphs on the card), and the
decomposed ring schedules of :mod:`~repro_torch.core.overlap`."""

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
from repro_torch.core.onesided import Window, create_window  # noqa: F401
from repro_torch.core.overlap import (  # noqa: F401
    all_gather_matmul,
    halo_exchange,
    hierarchical_allreduce,
    matmul_reduce_scatter,
    merge_partial_attention,
    partitioned_allreduce,
    partitioned_ring_all_gather,
    partitioned_ring_reduce_scatter,
    pipeline_spmd,
    ring_all_gather,
    ring_all_gather_bidirectional,
    ring_attention,
    ring_reduce_scatter,
)
from repro_torch.core.topology import (  # noqa: F401
    PROC_NULL,
    CartComm,
    CartShift,
    DistGraphComm,
    cart_create,
    dist_graph_create_adjacent,
)
