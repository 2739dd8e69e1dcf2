"""The request subsystem (paper §II, C3; MPI 4.0 persistent operations),
eager PyTorch form.

* :class:`Future` — host level.  CUDA work is queued asynchronously on the
  current stream, so a returned tensor is a request: ``get()`` =
  ``MPI_Wait`` (synchronises the tensors' devices and consumes the future),
  ``test()`` = ``MPI_Test``, ``then()`` chains a continuation.  A future
  over pending ``torch.distributed`` work (``works``) waits on that work
  instead: on NCCL the current stream waits for it, on gloo the host does.
  These futures take the role of the reference's ``TraceFuture`` in eager
  mode: a point-to-point exchange is issued, compute proceeds, and the join
  (:func:`when_all`) waits.

* :class:`DeferredFuture` — host level, off the dispatch path: a future
  whose value a *resolver* produces at completion (background file I/O,
  :class:`repro_torch.core.io.IORequest`, and joins over such requests).
  ``then()`` chains lazily, and resolver errors propagate through
  ``get()``/``wait()``.

* :class:`PersistentRequest` — ``MPI_Send_init`` + ``MPI_Start``.  Init
  binds the argument list (tree structure and each leaf's shape and dtype)
  and every start validates against it: drift raises ``ERR_REQUEST``.  A
  request whose arguments live on the card and that donates some of them
  runs its steady state as one CUDA graph replay: the first start runs
  eagerly (the warm-up), the second captures the step and replays it, every
  later start replays.  Other requests run the step eagerly at each start.

  A request's program — the ops one run of its step dispatches on this
  rank (:mod:`repro_torch.core.hloanalysis`) — is recorded once, where the
  step runs anyway: at the capture, or at an eager request's first start
  (``compiled``, ``as_text()``, ``cost_analysis()``).

* :class:`PersistentCollective` — ``MPI_Allreduce_init`` and friends: one
  persistent request per dtype bucket of the example's reflected datatype.

* :class:`PartitionedRequest` — ``MPI_Psend_init`` / ``MPI_Pready``: one
  operation in independently ready partitions, issued in index order.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis import events as analysis_events
from repro_torch.core import errors, tool


def _leaves(tree: Any) -> list:
    return flatten(tree)[0]


def flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, treedef) of a nest of dicts (sorted keys, as JAX does),
    lists, tuples and dataclasses; ``None`` is an empty node, every other
    object a leaf.  The treedef is hashable."""

    leaves: list = []
    return leaves, _walk(tree, leaves)


# _walk and _build recurse at module level: a nested function that calls
# itself sits in a reference cycle with its closure, which would hold the
# leaves (a model's whole KV cache) until the cyclic garbage collector ran


def _walk(node: Any, leaves: list) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, len(node), tuple(_walk(x, leaves) for x in node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = tuple(f.name for f in dataclasses.fields(node))
        return (type(node), fields, tuple(_walk(getattr(node, f), leaves) for f in fields))
    leaves.append(node)
    return "*"


def unflatten(treedef: Any, leaves: Sequence) -> Any:
    """Inverse of :func:`flatten`: the nest ``treedef`` describes, with
    ``leaves`` in its leaf positions."""

    return _build(treedef, iter(leaves))


def _build(node: Any, it) -> Any:
    if node is None:
        return None
    if node == "*":
        return next(it)
    kind, names, children = node
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(names, children)}
    if kind in ("list", "tuple"):
        items = [_build(c, it) for c in children]
        return items if kind == "list" else tuple(items)
    return kind(**{f: _build(c, it) for f, c in zip(names, children)})


def _capturing() -> bool:
    """This thread's current CUDA stream is capturing a graph."""

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _sync(tree: Any) -> None:
    devices = {
        leaf.device for leaf in _leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda
    }
    for d in devices:
        torch.cuda.synchronize(d)


class Future:
    """Host-level future over queued (asynchronous) results; with ``works``
    (a sequence of ``torch.distributed`` work handles, possibly empty), a
    request whose completion is that work's.

    Under analysis recording, the futures a caller is handed for pending
    communication (the immediate collectives, a persistent start, and the
    chains and joins over them) carry a ledger token, so that the lifecycle
    checker sees which were never consumed (``get()``, ``then()``,
    :func:`when_all`) — the reference's ``TraceFuture`` bookkeeping."""

    #: the ledger token of a tracked future (0: not tracked)
    _token = 0

    def __init__(self, value: Any, works: Sequence | None = None):
        self._value = value
        self._works = None if works is None else list(works)
        self._valid = True

    def _track(self, label: str) -> "Future":
        """Record this future's creation in the analyzer's ledger (under
        recording); returns it."""

        if analysis_events.RECORDING:
            self._token = analysis_events.next_token()
            analysis_events.record_future_create(
                self._token, label, rank=analysis_events.process_rank())
        return self

    def _consume(self, how: str) -> bool:
        """Record the consumption of a tracked future; whether it was
        tracked."""

        token, self._token = self._token, 0
        if token:
            analysis_events.record_future_consume(
                token, how, rank=analysis_events.process_rank())
        return bool(token)

    def _complete(self) -> None:
        if self._works is None:
            _sync(self._value)
            return
        capturing = _capturing()
        for w in self._works:
            # a work another future already waited (a when_all join, a
            # window's fence) is complete: gloo would wait for a second
            # transfer on it.  Under CUDA graph capture an NCCL work's
            # completion cannot be queried (it is recorded, not run): its
            # wait only makes the stream wait, which the graph records
            if capturing or not w.is_completed():
                w.wait()
        self._works = []

    def valid(self) -> bool:
        return self._valid

    def get(self) -> Any:
        """``MPI_Wait`` + value retrieval (consumes the future)."""

        errors.check(self._valid, errors.ErrorClass.ERR_REQUEST, "future already consumed")
        self._valid = False
        self._consume("get")
        return self._wait_value()

    def _wait_value(self) -> Any:
        """Block until the value is complete and return it (no validity
        bookkeeping — ``get``/``wait`` own that)."""

        self._complete()
        return self._value

    def wait(self) -> "Future":
        """Block until complete (does not consume; ``get()`` does)."""

        errors.check(self._valid, errors.ErrorClass.ERR_REQUEST, "future already consumed")
        self._complete()
        return self

    def test(self) -> bool:
        """Non-blocking completion probe (``MPI_Test``): the pending work has
        completed, or else the current streams of the tensors' devices have
        drained."""

        if self._works is not None:
            return all(w.is_completed() for w in self._works)
        devices = {
            leaf.device for leaf in _leaves(self._value)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda
        }
        return all(torch.cuda.current_stream(d).query() for d in devices)

    def then(self, fn: Callable[["Future"], Any]) -> "Future":
        """Chain a continuation (paper Listing 2); consumes this future."""

        errors.check(
            self._valid, errors.ErrorClass.ERR_REQUEST, "then() on a consumed future"
        )
        result = fn(self)
        self._valid = False
        tracked = self._consume("then")
        if result is self:
            out = Future(self._value, self._works)
        elif isinstance(result, Future):
            out = result
        else:
            out = Future(result)
        return out._track("then") if tracked and not out._token else out


class DeferredFuture(Future):
    """Host future whose value is produced by a *resolver* at completion
    time — the host-level request behind operations that finish off the
    device's queue (background file I/O, joins over such requests).

    ``get()``/``wait()`` run the resolver exactly once; an error raised
    there (e.g. ``ERR_IO`` from a failed background write) propagates to the
    caller — a failed operation can never read as success.  ``test()`` uses
    the optional ``probe`` (e.g. a thread-completion event); without one it
    reports completion only after resolution.

    ``then()`` on a deferred request is itself deferred: the continuation
    runs when the *chained* request is waited, not at chain time, so a chain
    built over in-flight I/O does not block the issuing thread.
    """

    def __init__(self, resolver: Callable[[], Any], probe: Callable[[], bool] | None = None):
        super().__init__(None)
        self._resolver = resolver
        self._probe = probe
        self._resolved = False

    def _complete(self) -> None:
        if not self._resolved:
            self._value = self._resolver()
            self._resolved = True
        _sync(self._value)

    def test(self) -> bool:
        if self._resolved:
            return True
        if self._probe is not None:
            return bool(self._probe())
        return False

    def then(self, fn: Callable[["Future"], Any]) -> "DeferredFuture":
        errors.check(
            self._valid, errors.ErrorClass.ERR_REQUEST, "then() on a consumed future"
        )
        self._valid = False
        tracked = self._consume("then")
        parent = self

        def resolver():
            # the chain owns the parent request now: re-validate it for the
            # continuation's own get()/wait(), as the eager form hands fn a
            # still-valid future
            parent._valid = True
            try:
                result = fn(parent)
            finally:
                parent._valid = False
            if result is parent:
                return parent._wait_value()
            if isinstance(result, Future):
                return result._wait_value()
            return result

        # no probe: the continuation only runs at wait, so completion is not
        # observable earlier
        out = DeferredFuture(resolver)
        return out._track("then") if tracked else out


def when_all(futures: Sequence[Future]) -> Future:
    """``MPI_Waitall`` join: a future over the tuple of results.

    Like ``MPI_Waitall``, the joined requests are consumed: each input must
    still be valid (``ERR_REQUEST`` otherwise, exactly as a double ``get()``
    would raise) and is invalidated by the join.  The join waits on every
    input's pending work; if any input is a plain host future, it also
    synchronises the devices of the results."""

    seen: set[int] = set()
    for i, f in enumerate(futures):
        errors.check(
            f.valid() and id(f) not in seen,
            errors.ErrorClass.ERR_REQUEST,
            f"when_all: future {i} already consumed",
        )
        seen.add(id(f))
    tracked = False
    for f in futures:
        f._valid = False
        tracked |= f._consume("when_all")
    if any(isinstance(f, DeferredFuture) for f in futures):
        # a join over in-flight host I/O stays lazy: waiting the join waits
        # every input (in order) and surfaces the first failure (ERR_IO from
        # a background write propagates, MPI_Waitall-style)
        inputs = tuple(futures)
        out = DeferredFuture(
            lambda: tuple(f._wait_value() for f in inputs),
            probe=lambda: all(f.test() for f in inputs),
        )
    else:
        values = tuple(f._value for f in futures)
        out = (Future(values) if any(f._works is None for f in futures)
               else Future(values, [w for f in futures for w in f._works]))
    return out._track("when_all") if tracked else out


def when_any(
    futures: Sequence[Future],
    poll_interval_s: float = 1e-4,
    timeout_s: float | None = None,
) -> tuple[Future, int]:
    """``MPI_Waitany`` join: first completed future and its index.

    Inputs must be valid (unconsumed); the winner is returned still valid so
    the caller retrieves its value with ``get()``.  With ``timeout_s`` set,
    ``ERR_PENDING`` is raised if no input completes in time (instead of
    busy-waiting forever on a never-ready future).
    """

    errors.check(len(futures) > 0, errors.ErrorClass.ERR_REQUEST, "when_any of no futures")
    for i, f in enumerate(futures):
        errors.check(
            f.valid(),
            errors.ErrorClass.ERR_REQUEST,
            f"when_any: future {i} already consumed",
        )
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        for i, f in enumerate(futures):
            if f.test():
                return f, i
        if deadline is not None and time.monotonic() >= deadline:
            errors.fail(
                errors.ErrorClass.ERR_PENDING,
                f"when_any: none of {len(futures)} futures completed "
                f"within {timeout_s}s",
            )
        time.sleep(poll_interval_s)


def _leaf_signature(leaf: Any) -> tuple:
    """(shape, dtype) of a leaf; a DTensor's adds its mesh and placements,
    so a request bound to one layout refuses another (``ERR_REQUEST``), as
    the reference's compiled step refuses a sharding drift."""

    shape = tuple(getattr(leaf, "shape", ()))
    dtype = getattr(leaf, "dtype", None)
    sig = (shape, dtype if dtype is None else str(dtype))
    if _is_dtensor(leaf):
        mesh = leaf.device_mesh
        sig += ((tuple(mesh.mesh_dim_names or ()), tuple(mesh.mesh.shape)),
                tuple(str(p) for p in leaf.placements))
    return sig


def _is_dtensor(leaf: Any) -> bool:
    return type(leaf).__name__ == "DTensor" and hasattr(leaf, "to_local")


def _local_leaf(leaf: Any) -> Any:
    """A DTensor's local shard (the buffer a graph reads); any other leaf
    as it is."""

    return leaf.to_local() if _is_dtensor(leaf) else leaf


def argument_signature(tree: Any) -> tuple:
    """Hashable (treedef, per-leaf shape/dtype) key for one argument list —
    the signature a :class:`PersistentRequest` is bound to; also the key of
    per-shape-bucket requests."""

    leaves, treedef = flatten(tree)
    return treedef, tuple(_leaf_signature(l) for l in leaves)


def _donated_leaves(args: tuple, donate_argnums: tuple[int, ...]) -> list[bool]:
    """Per leaf of the argument list ``args``: whether it lies in a donated
    argument."""

    mask: list[bool] = []
    for i, arg in enumerate(args):
        mask += [i in donate_argnums] * len(_leaves(arg))
    return mask


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` views exactly the elements of ``b``, which is alive (so its
    memory cannot have been handed to another tensor); DTensors compare
    their local shards."""

    a, b = _local_leaf(a), _local_leaf(b)
    return (a.data_ptr() == b.data_ptr() and a.device == b.device and a.dtype == b.dtype
            and a.shape == b.shape and a.stride() == b.stride())


def _capturable(leaf: Any) -> bool:
    """A leaf a CUDA graph can read at each replay: a tensor on the card
    (a Python scalar would be baked into the graph)."""

    return isinstance(leaf, torch.Tensor) and leaf.is_cuda


def _zeros_maker(leaf: Any) -> Callable[[], Any]:
    """A function making zeros of ``leaf``'s shape, strides, dtype, device
    (a DTensor's mesh and placements) and ``requires_grad``, holding no
    reference to its buffer (a numpy array's zeros likewise); any other
    leaf as it is."""

    if isinstance(leaf, np.ndarray):
        shape, dtype = leaf.shape, leaf.dtype
        return lambda: np.zeros(shape, dtype)
    if not isinstance(leaf, torch.Tensor):
        return lambda: leaf
    grad = leaf.requires_grad and leaf.is_leaf
    shape, dtype = tuple(leaf.shape), leaf.dtype
    if _is_dtensor(leaf):
        from torch.distributed.tensor import zeros

        mesh, placements = leaf.device_mesh, tuple(leaf.placements)
        return lambda: zeros(shape, dtype=dtype, device_mesh=mesh, placements=placements,
                             requires_grad=grad)
    stride, device = leaf.stride(), leaf.device
    return lambda: torch.empty_strided(shape, stride, dtype=dtype, device=device).zero_(
    ).requires_grad_(grad)


def _graph_capture(fn: Callable, args: tuple) -> tuple[Any, Any]:
    """Capture ``fn(*args)`` as a ``torch.cuda.CUDAGraph`` (its kernels
    are recorded, not run): (the graph, the outputs, which are the graph's
    static output buffers)."""

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


class PersistentRequest:
    """Persistent operation: a step function bound to its argument list.

    * **validation** — every start checks tree structure and leaf
      shapes/dtypes against the init-time argument list; any mismatch raises
      ``ERR_REQUEST`` (a persistent request is *bound* to its arguments).
    * **donation** — ``donate_argnums`` names the arguments whose buffers
      the step reuses, as the reference's donated inputs are aliased into
      its outputs: at each start the caller gives them up and goes on with
      the step's outputs.
    * **CUDA graphs** — a request that donates, and whose arguments are
      all tensors on the card, runs its steady state as one graph replay:

      - start 1 runs the step eagerly on the caller's arguments.  It is
        the warm-up (it builds the kernels, loads the libraries' handles
        and settles the allocator) and a real step: no warm-up runs on
        state the caller owns, which an in-place step would advance;
      - start 2 captures the step on its own arguments as a
        ``torch.cuda.CUDAGraph`` and replays it;
      - every later start copies each input leaf whose buffer is not the
        one the graph reads into that buffer, then replays.

      The graph reads in place the donated leaves and the leaves that were
      the same buffers at the two starts before the capture (the weights);
      the others (a new token, a batch) it reads from copies it owns.  If
      an in-place leaf that is not donated comes in another buffer, the
      step is captured again.  The outputs are the graph's static
      buffers, so the next start overwrites them, as it reuses a donating
      step's buffers: read them first.  The kernel launches recorded during
      the capture are added to the wrappers' counts at each replay
      (:func:`repro_torch.core.tool.recording_launches`).  A capture or
      replay that fails raises (``ERR_NO_MEM`` when memory ran out,
      ``ERR_OTHER`` otherwise); it never falls back to the eager step.
      :meth:`release` drops the graph; the next start captures anew.
    * **eager** — a request that donates nothing runs its step eagerly at
      every start: the reference's outputs are fresh buffers at every
      start, which a graph's private memory pool gives only through a copy,
      and each such request (a prefill per prompt-length bucket, each
      persistent collective) would pin a pool of its own.  On the CPU every
      request is eager.
    * **warm start** — ``warm_start=True`` fires the step once at init on
      zeros the request owns in place of its tensor arguments (safe under
      donation), so that kernel builds and allocator growth happen before
      the first real start; on the card, start 1 still runs eagerly.
    * **the program** — ``compiled`` (a :class:`~repro_torch.core.
      hloanalysis.Program`), ``as_text()`` and ``cost_analysis()`` (XLA's
      ``"flops"`` and ``"bytes accessed"``, this rank's) read the ops one
      run of the step dispatches here.  They are recorded once, where the
      step runs anyway: at the capture (the graph holds exactly those
      ops), or at an eager request's first start; never at a later start
      or a replay.  Asked for before then, they are recorded by one run on
      zeros the request owns (the warm start's, safe under donation): a
      collective call when the step communicates, which counts no pvar and
      no kernel launch and never touches the caller's buffers.  A recording
      that fails raises (``ERR_OTHER``) and leaves no program.
    * **continuations** — ``then(fn)`` registers a continuation applied to
      every start's host future.
    """

    def __init__(
        self,
        fn: Callable,
        example_args: tuple,
        *,
        donate_argnums: tuple[int, ...] = (),
        warm_start: bool = False,
    ):
        tool.pvar_count("persistent_init")
        self._fn = fn
        self.donate_argnums = tuple(donate_argnums)
        errors.check(
            all(0 <= i < len(example_args) for i in self.donate_argnums),
            errors.ErrorClass.ERR_ARG,
            f"donate_argnums {self.donate_argnums} out of range for "
            f"{len(example_args)} arguments",
        )
        self._signature = argument_signature(example_args)
        self._donated = _donated_leaves(example_args, self.donate_argnums)
        self._continuations: list[Callable[[Future], Any]] = []
        self._started = 0
        leaves = _leaves(example_args)
        self._zeros = [_zeros_maker(leaf) for leaf in leaves]
        self._program: Any = None     # the recorded hloanalysis.Program
        #: whether the steady state is a CUDA graph replay
        self.captures = bool(self.donate_argnums and leaves) and all(map(_capturable, leaves))
        #: graphs captured so far (a release and a new buffer capture again)
        self.captured = 0
        self._graph: Any = None       # the torch.cuda.CUDAGraph, once captured
        self._bound: list = []       # per leaf: the buffer the graph reads
        self._in_place: list = []    # per leaf: the graph reads the caller's own buffer
        self._out: Any = None
        self._launches: dict[str, int] = {}
        self._previous: list = []    # weak references to the last start's leaves
        # analysis bookkeeping: the last start()'s chained future, held
        # weakly so the analyzer never extends buffer lifetimes
        self._token = 0
        self._last_future: weakref.ref | None = None
        if analysis_events.RECORDING:
            self._token = analysis_events.next_token()
            analysis_events.record_persistent_init(
                self._token, donated=bool(self.donate_argnums),
                rank=analysis_events.process_rank())
        if warm_start:
            self._warm_start()

    def _warm_start(self, record: bool = False) -> None:
        """Prefetch: fire once on zero buffers the request owns (recording
        the program, with ``record``)."""

        zeros = [make() for make in self._zeros]
        fn = self._recording(self._fn) if record else self._fn
        _sync(fn(*unflatten(self._signature[0], zeros)))

    def _recording(self, fn: Callable) -> Callable:
        """``fn``, recording the request's program at its call while there
        is none (then plain ``fn``: a stand-in graph's replays call it
        again).  It holds the request weakly: a graph that keeps it must
        not keep the request alive."""

        request = weakref.ref(self)

        def once(*args):
            req = request()
            if req is None or req._program is not None:
                return fn(*args)
            from repro_torch.core.hloanalysis import record

            out, req._program = record(fn, *args)
            return out

        return once

    @property
    def compiled(self):
        """The step's program on this rank (:class:`repro_torch.core.
        hloanalysis.Program`); recorded by a run on owned zeros if the step
        has not run under the recorder yet (collective)."""

        if self._program is None:
            with tool.pvars_paused(), tool.recording_launches():
                self._warm_start(record=True)
        return self._program

    def cost_analysis(self) -> dict[str, float]:
        """XLA's ``cost_analysis()`` keys over this rank's program:
        ``"flops"`` and ``"bytes accessed"``."""

        from repro_torch.core.hloanalysis import analyze_hlo

        cost = analyze_hlo(self.as_text())
        return {"flops": cost.flops, "bytes accessed": cost.bytes}

    def as_text(self) -> str:
        return self.compiled.as_text()

    @property
    def starts(self) -> int:
        return self._started

    @property
    def settled(self) -> bool:
        """The next start runs the steady state: no warm-up or capture is
        due (always, for an eager request)."""

        return not self.captures or self._graph is not None

    def release(self) -> None:
        """Drop the captured graph, its memory pool and its hold on the
        bound buffers.  The last outputs stay valid while the caller holds
        them; the next start captures again on its own arguments."""

        self._graph, self._out = None, None
        self._bound, self._in_place, self._launches = [], [], {}

    def _validate(self, args: tuple) -> None:
        treedef, sigs = argument_signature(args)
        bound_treedef, bound_sigs = self._signature
        errors.check(
            treedef == bound_treedef,
            errors.ErrorClass.ERR_REQUEST,
            "persistent start: argument structure does not match the "
            "init-time structure",
        )
        for i, (sig, bound) in enumerate(zip(sigs, bound_sigs)):
            errors.check(
                sig == bound,
                errors.ErrorClass.ERR_REQUEST,
                f"persistent start: argument leaf {i} is {sig}, request was "
                f"initialised with {bound}",
            )

    def __call__(self, *args: Any) -> Any:
        """Fire the persistent operation, returning the raw (asynchronously
        queued) outputs — the drop-in replacement for the step function."""

        if errors.error_checking_enabled():
            self._validate(args)
        if self.captures and self._started:
            out = self._replay(args)
        elif self.captures:
            out = self._fn(*args)
        else:
            out = self._recording(self._fn)(*args)
        if self.captures:
            self._previous = [weakref.ref(leaf) for leaf in _leaves(args)]
        tool.pvar_count("persistent_start")
        self._started += 1
        return out

    def _replay(self, args: tuple) -> Any:
        leaves, treedef = flatten(args)
        if self._graph is not None and not self._rebind(leaves):
            self.release()
        if self._graph is None:
            return self._capture(leaves, treedef)
        try:
            self._graph.replay()
        except RuntimeError as e:
            raise errors.exception(errors.ErrorClass.ERR_OTHER,
                                   f"persistent start: CUDA graph replay failed: {e}") from e
        tool.add_launches(self._launches)
        return self._out

    def _rebind(self, leaves: list) -> bool:
        """Copy each leaf into the buffer the graph reads for it, unless it
        is that buffer; False (nothing copied) if an in-place leaf that is
        not donated comes in another buffer, which needs a new capture."""

        copies = []
        for i, (leaf, bound) in enumerate(zip(leaves, self._bound)):
            if not _same_buffer(leaf, bound):
                # checked whether or not error checking is on: a graph reads
                # fixed buffers, and a copy would broadcast a drifted shape
                if leaf.shape != bound.shape or leaf.dtype != bound.dtype:
                    raise errors.exception(
                        errors.ErrorClass.ERR_REQUEST,
                        f"persistent start: argument leaf {i} is {tuple(leaf.shape)} "
                        f"{leaf.dtype}; the captured step reads {tuple(bound.shape)} "
                        f"{bound.dtype}")
                if self._in_place[i] and not self._donated[i]:
                    return False
                copies.append((bound, leaf))
        with torch.no_grad():
            for bound, leaf in copies:
                _local_leaf(bound).copy_(_local_leaf(leaf))
        return True

    def _capture(self, leaves: list, treedef: Any) -> Any:
        """Capture the step on ``leaves`` (the graph reads them, or copies
        of those that are neither donated nor the previous start's buffers)
        and replay it once."""

        bound, in_place = [], []
        for leaf, donated, ref in zip(leaves, self._donated, self._previous):
            prev = ref()
            keep = donated or (prev is not None and _same_buffer(leaf, prev))
            if not keep:
                leaf = leaf.detach().clone()
            bound.append(leaf)
            in_place.append(keep)
        try:
            with tool.recording_launches() as launches:
                graph, out = _graph_capture(self._recording(self._fn), unflatten(treedef, bound))
            graph.replay()
        except torch.OutOfMemoryError as e:
            raise errors.exception(
                errors.ErrorClass.ERR_NO_MEM,
                f"persistent start: capturing the step as a CUDA graph ran out of device "
                f"memory: {e}") from e
        except RuntimeError as e:
            raise errors.exception(
                errors.ErrorClass.ERR_OTHER,
                f"persistent start: capturing the step as a CUDA graph failed: {e}") from e
        self._graph, self._bound, self._in_place, self._out = graph, bound, in_place, out
        self._launches = dict(launches)
        self.captured += 1
        tool.add_launches(self._launches)
        return out

    def start(self, *args: Any) -> Future:
        """``MPI_Start``: fire the persistent operation; returns a host
        future, chained through any registered ``then()`` continuations."""

        if analysis_events.RECORDING and self._token:
            prev = self._last_future() if self._last_future else None
            analysis_events.record_persistent_start(
                self._token,
                donated=bool(self.donate_argnums),
                prev_outstanding=prev is not None and prev.valid(),
                has_continuations=bool(self._continuations),
                rank=analysis_events.process_rank(),
            )
        fut = Future(self(*args))._track("persistent_start")
        for fn in self._continuations:
            fut = fut.then(fn)
        if analysis_events.RECORDING and self._token:
            self._last_future = weakref.ref(fut)
        return fut

    def then(self, fn: Callable[[Future], Any]) -> "PersistentRequest":
        """Register a continuation applied to every start's future."""

        self._continuations.append(fn)
        return self


class PersistentCollective:
    """A persistent collective over a *datatype* (``MPI_Allreduce_init``).

    Built by ``comm.<op>_init(example)``: a single tensor gets one request
    on its own shape; an aggregate's datatype is derived (C2) and one
    :class:`PersistentRequest` is bound per dtype bucket.  ``start(value)``
    packs the new value (same datatype enforced), fires every bucket's
    request, and returns a host :class:`Future` over the reassembled
    aggregate (or the raw bucket list for shape-changing collectives,
    mirroring the blocking forms).  The requests donate nothing: a
    collective's result is a fresh buffer at every start, so they run
    eagerly.
    """

    def __init__(self, name: str, datatype, requests: list[PersistentRequest],
                 *, unpackable: bool = True, signature: tuple | None = None):
        self.name = name
        self.datatype = datatype          # None => single-array fast path
        self._requests = requests
        self._unpackable = unpackable
        self._signature = signature       # init-time aggregate signature

    @property
    def requests(self) -> list[PersistentRequest]:
        return self._requests

    @property
    def starts(self) -> int:
        """``MPI_Start`` events fired so far (max over the dtype-bucket
        requests — one logical start fires every bucket once)."""

        return max((r.starts for r in self._requests), default=0)

    def as_text(self) -> str:
        """The bucket requests' programs, one after another."""

        return "\n".join(r.as_text() for r in self._requests)

    def start(self, value: Any) -> Future:
        if self.datatype is None:
            return Future(self._requests[0](value))
        if self._signature is not None and errors.error_checking_enabled():
            # bind the aggregate too: pack() would silently cast drifted leaf
            # dtypes to the init-time layout, so check the signature first
            errors.check(
                argument_signature(value) == self._signature,
                errors.ErrorClass.ERR_REQUEST,
                f"persistent {self.name} start: aggregate does not match the "
                f"init-time datatype (shape/dtype/structure drift)",
            )
        outs = [req(b) for req, b in zip(self._requests, self.datatype.pack(value))]
        if self._unpackable:
            return Future(self.datatype.unpack(outs))
        return Future(outs)


# ---------------------------------------------------------------------------
# partitioned communication (MPI_Psend_init / MPI_Pready)
# ---------------------------------------------------------------------------


class PartitionedRequest:
    """Partitioned operation (``MPI_Psend_init`` family): one logical
    operation split into ``num_partitions`` partitions, partition ``i``
    computing ``fn(i, payload)``.

    ``pready(i, payload)`` marks partition ``i`` ready.  The reference's
    partitions are lazy trace futures that :meth:`wait` forces in index
    order; here a partition's operation is **issued in index order** as soon
    as it and every partition before it are ready (the longest ready
    prefix), whatever the order of the ``pready`` calls.  That is what
    collectives over NCCL and gloo need: every rank issues them in the same
    order, while ranks may mark their partitions ready in different orders.
    The result is therefore independent of the ``pready`` order, as the
    reference's is.  On the card an issued operation is queued on the
    stream and the host goes on.

    ``pready`` returns a host future over its partition's result; its
    ``get()`` raises ``ERR_PENDING`` while the partition waits for an
    earlier one to be ready.  The request is persistent in the MPI sense:
    :meth:`start` re-activates it for another round (``ERR_REQUEST`` on a
    double start, a pready without start, a duplicate pready or an index
    out of range; ``ERR_PENDING`` on a wait with partitions missing).
    """

    def __init__(self, fn: Callable[[int, Any], Any], num_partitions: int):
        errors.check(
            num_partitions > 0,
            errors.ErrorClass.ERR_COUNT,
            f"partitioned request needs >= 1 partition, got {num_partitions}",
        )
        tool.pvar_count("partitioned_init")
        self._fn = fn
        self._n = num_partitions
        self._payloads: list = [None] * num_partitions
        self._ready = [False] * num_partitions
        # this round's results, _PENDING until issued; a new list each round,
        # so a future of an earlier round keeps its own
        self._results: list = [_PENDING] * num_partitions
        self._issued = 0     # partitions 0 .. _issued - 1 have been issued
        self._active = False

    @property
    def num_partitions(self) -> int:
        return self._n

    def start(self) -> "PartitionedRequest":
        """``MPI_Start``: activate the request for one round of pready/wait."""

        errors.check(
            not self._active,
            errors.ErrorClass.ERR_REQUEST,
            "partitioned start: request already active (wait() first)",
        )
        tool.pvar_count("partitioned_start")
        self._payloads = [None] * self._n
        self._ready = [False] * self._n
        self._results = [_PENDING] * self._n
        self._issued = 0
        self._active = True
        return self

    def _check_index(self, what: str, index: int) -> None:
        errors.check(
            0 <= index < self._n,
            errors.ErrorClass.ERR_REQUEST,
            f"{what} partition {index} out of range [0, {self._n})",
        )

    def pready(self, index: int, payload: Any) -> "DeferredFuture":
        """``MPI_Pready``: partition ``index``'s payload is produced; issues
        every partition of the ready prefix not issued yet, in index order,
        and returns a future over this partition's result."""

        errors.check(
            self._active,
            errors.ErrorClass.ERR_REQUEST,
            "pready before start() on a partitioned request",
        )
        self._check_index("pready", index)
        errors.check(
            not self._ready[index],
            errors.ErrorClass.ERR_REQUEST,
            f"pready: partition {index} already marked ready",
        )
        tool.pvar_count("partition_ready")
        self._payloads[index] = payload
        self._ready[index] = True
        while self._issued < self._n and self._ready[self._issued]:
            i = self._issued
            self._results[i] = self._fn(i, self._payloads[i])
            self._payloads[i] = None
            self._issued += 1
        results = self._results
        return DeferredFuture(lambda: self._result(index, results),
                              probe=lambda: _arrived(results[index]))

    def _result(self, index: int, results: list) -> Any:
        errors.check(
            results[index] is not _PENDING,
            errors.ErrorClass.ERR_PENDING,
            f"partition {index} is not issued: partitions "
            f"{[i for i in range(index) if not self._ready[i]]} before it are not ready",
        )
        return results[index]

    def parrived(self, index: int) -> bool:
        """``MPI_Parrived``: has partition ``index``'s operation been issued
        and completed?"""

        self._check_index("parrived", index)
        return _arrived(self._results[index])

    def wait(self) -> list:
        """Complete the operation and return the partitions' results in
        index order.  ``ERR_PENDING`` if some partition was never marked
        ready (the MPI program would deadlock)."""

        missing = [i for i, ready in enumerate(self._ready) if not ready]
        errors.check(
            not missing,
            errors.ErrorClass.ERR_PENDING,
            f"partitioned wait: partitions {missing} never marked ready",
        )
        results = self._results
        _sync(results)
        self._results = [_PENDING] * self._n
        self._active = False
        return results


#: A partition's result before its operation is issued.
_PENDING = object()


def _arrived(result: Any) -> bool:
    return result is not _PENDING and Future(result).test()
