"""repro_torch.core — the interface layer of the port: typed errors, the
MPI_T-style pvar/cvar registry, sessions and groups over the process world,
communicators with their collectives, Cartesian and graph topologies with
the neighborhood collectives, RMA windows and requests (futures, and
persistent requests that replay CUDA graphs on the card), and the
decomposed ring schedules of :mod:`~repro_torch.core.overlap`.  The
package exports the reference's names (``repro.core``), but for its
``TraceFuture``, ``trace_when_all``, ``trace_when_any`` and
``hloanalysis``, which have no counterpart (ROADMAP A16)."""

from repro_torch.core import _methods  # noqa: F401  (binds the method facade)
from repro_torch.core import errors  # noqa: F401
from repro_torch.core.session import (  # noqa: F401
    UNDEFINED,
    Group,
    GroupComparison,
    Session,
    default_session,
)
from repro_torch.core.communicator import Communicator, world  # noqa: F401
from repro_torch.core.datatypes import (  # noqa: F401
    DataType,
    datatype_of,
    is_compliant,
    pack,
    register_aggregate,
    unpack,
)
from repro_torch.core.descriptors import (  # noqa: F401
    Algorithm,
    CollectiveSpec,
    Compression,
    FileSpec,
    Mode,
    ReduceOp,
    ThreadLevel,
    WindowSpec,
)
from repro_torch.core.futures import (  # noqa: F401
    DeferredFuture,
    Future,
    PartitionedRequest,
    PersistentCollective,
    PersistentRequest,
    when_all,
    when_any,
)
from repro_torch.core.collectives import (  # noqa: F401
    allgather,
    allgatherv,
    allreduce,
    alltoall,
    alltoallv,
    barrier,
    broadcast,
    exscan,
    gather,
    reduce,
    reduce_scatter,
    scan,
    scatter,
    send_recv,
    shift,
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
from repro_torch.core import compress, io, tool  # noqa: F401


def future(value) -> Future:
    """``mpi::future(request)`` analogue: wrap a value or pass futures
    through (requests returned by ``immediate_*`` already are futures).
    The reference also passes its ``TraceFuture`` through, which has no
    counterpart here (ROADMAP A16): :class:`Future` over ``dist.Work``
    takes its role."""

    if isinstance(value, Future):
        return value
    return Future(value)


set_error_checking = errors.set_error_checking
