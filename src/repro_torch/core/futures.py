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

* :class:`PersistentRequest` — ``MPI_Send_init`` + ``MPI_Start``.  Eager
  PyTorch has no trace to amortise, so init binds the argument list (tree
  structure and each leaf's shape and dtype) and every start validates
  against it: drift raises ``ERR_REQUEST``.  Capturing the bound step as a
  CUDA graph (init = capture, start = replay) is the next step of the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import errors, tool


def _leaves(tree: Any) -> list:
    return flatten(tree)[0]


def flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, treedef) of a nest of dicts (sorted keys, as JAX does),
    lists, tuples and dataclasses; ``None`` is an empty node, every other
    object a leaf.  The treedef is hashable."""

    leaves: list = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node), tuple(walk(x) for x in node))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            fields = tuple(f.name for f in dataclasses.fields(node))
            return (type(node), fields, tuple(walk(getattr(node, f)) for f in fields))
        leaves.append(node)
        return "*"

    treedef = walk(tree)
    return leaves, treedef


def unflatten(treedef: Any, leaves: Sequence) -> Any:
    """Inverse of :func:`flatten`: the nest ``treedef`` describes, with
    ``leaves`` in its leaf positions."""

    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == "*":
            return next(it)
        kind, names, children = node
        if kind == "dict":
            return {k: build(c) for k, c in zip(names, children)}
        if kind in ("list", "tuple"):
            items = [build(c) for c in children]
            return items if kind == "list" else tuple(items)
        return kind(**{f: build(c) for f, c in zip(names, children)})

    return build(treedef)


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
    request whose completion is that work's."""

    def __init__(self, value: Any, works: Sequence | None = None):
        self._value = value
        self._works = None if works is None else list(works)
        self._valid = True

    def _complete(self) -> None:
        if self._works is None:
            _sync(self._value)
            return
        for w in self._works:
            w.wait()
        self._works = []

    def valid(self) -> bool:
        return self._valid

    def get(self) -> Any:
        """``MPI_Wait`` + value retrieval (consumes the future)."""

        errors.check(self._valid, errors.ErrorClass.ERR_REQUEST, "future already consumed")
        self._valid = False
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
        if result is self:
            return Future(self._value, self._works)
        if isinstance(result, Future):
            return result
        return Future(result)


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
        return DeferredFuture(resolver)


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
    for f in futures:
        f._valid = False
    if any(isinstance(f, DeferredFuture) for f in futures):
        # a join over in-flight host I/O stays lazy: waiting the join waits
        # every input (in order) and surfaces the first failure (ERR_IO from
        # a background write propagates, MPI_Waitall-style)
        inputs = tuple(futures)
        return DeferredFuture(
            lambda: tuple(f._wait_value() for f in inputs),
            probe=lambda: all(f.test() for f in inputs),
        )
    values = tuple(f._value for f in futures)
    if any(f._works is None for f in futures):
        return Future(values)
    return Future(values, [w for f in futures for w in f._works])


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
    shape = tuple(getattr(leaf, "shape", ()))
    dtype = getattr(leaf, "dtype", None)
    return (shape, dtype if dtype is None else str(dtype))


def argument_signature(tree: Any) -> tuple:
    """Hashable (treedef, per-leaf shape/dtype) key for one argument list —
    the signature a :class:`PersistentRequest` is bound to; also the key of
    per-shape-bucket requests."""

    leaves, treedef = flatten(tree)
    return treedef, tuple(_leaf_signature(l) for l in leaves)


class PersistentRequest:
    """Persistent operation: a step function bound to its argument list.

    * **validation** — every start checks tree structure and leaf
      shapes/dtypes against the init-time argument list; any mismatch raises
      ``ERR_REQUEST`` (a persistent request is *bound* to its arguments).
    * **continuations** — ``then(fn)`` registers a continuation applied to
      every start's host future.
    """

    def __init__(self, fn: Callable, example_args: tuple):
        tool.pvar_count("persistent_init")
        self._fn = fn
        self._signature = argument_signature(example_args)
        self._continuations: list[Callable[[Future], Any]] = []
        self._started = 0

    @property
    def starts(self) -> int:
        return self._started

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
        out = self._fn(*args)
        tool.pvar_count("persistent_start")
        self._started += 1
        return out

    def start(self, *args: Any) -> Future:
        """``MPI_Start``: fire the persistent operation; returns a host
        future, chained through any registered ``then()`` continuations."""

        fut = Future(self(*args))
        for fn in self._continuations:
            fut = fut.then(fn)
        return fut

    def then(self, fn: Callable[[Future], Any]) -> "PersistentRequest":
        """Register a continuation applied to every start's future."""

        self._continuations.append(fn)
        return self
