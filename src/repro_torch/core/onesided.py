"""One-sided communication (paper §II, C1 — MPI 4.0 chapter 12, RMA):
:mod:`repro.core.onesided` over ``torch.distributed``.

A window (``MPI_Win``) exposes each rank's local buffer for remote ``put`` /
``get`` / ``accumulate``.  The reference lowers a window inside one SPMD
program: puts and gets to ``collective-permute``, accumulates to masked
reductions, and ``fence`` to a program-order barrier.  Here every rank is a
process and calls the same window operations with its own value, in the
same order:

* a :class:`Window` owns its memory (a copy of the local value, one packed
  buffer per dtype group for an aggregate); a ``put`` or ``rput`` with the
  static pattern ``perm`` sends from each origin and receives **into the
  target's window memory** (its page's span, for a paged transfer), one
  ``dist.batch_isend_irecv`` a call; a pair ``(r, r)`` is a local copy,
  since PyTorch refuses a send to one's own rank.  Ranks not targeted keep
  their buffer;
* ``get`` is the reverse flow (``send_recv`` of the window buffers; ranks
  not reading receive zeros); the accumulate family reduces every rank's
  contribution with the collectives (:func:`~repro_torch.core.collectives.
  combine` for the two-operand step) and writes the target's window in
  place;
* request-based operations (``rput``, ``rget``, ``raccumulate``) are issued
  at the call and return a :class:`~repro_torch.core.futures.Future` over
  their ``dist.Work``, which chains with ``then()`` (a continuation runs at
  once and may issue more RMA) and joins with ``when_all``.  :meth:`Window.
  fence` completes every request of the epoch in issue order.

Three MPI 4.0 capabilities beyond the plain put/get subset, as in the
reference: request-based RMA; windows over any :func:`repro_torch.core.
datatypes.is_compliant` aggregate, with ``page=(i, n)`` moving page ``i`` of
the packed extent (:meth:`~repro_torch.core.datatypes.DataType.page_bounds`);
and the atomics ``get_accumulate``, ``fetch_and_op`` and
``compare_and_swap`` with the full :class:`ReduceOp` set plus ``REPLACE``
and ``NO_OP``.  Dynamic windows (``WindowSpec(dynamic=True)``) attach and
detach pages, the free-list the paged KV block pool rides
(:mod:`repro_torch.runtime.kvpool`).

Every refusal raises the reference's class: ``ERR_WIN`` outside an epoch,
``ERR_RANK`` for a pair out of range, a duplicate target (or a target
written twice in one epoch), ``ERR_COUNT`` for a page out of range,
``ERR_TYPE`` for a bare ``None``, ``ERR_TRUNCATE`` for a shape mismatch,
``ERR_RMA_RANGE`` for a put to a detached page and
``ERR_UNSUPPORTED_OPERATION`` for ``no_locks=False``: passive-target
lock/unlock is refused, as the reference refuses it; what transfers is the
active-target (fence-epoch) subset.  The reference's ``fence_barrier`` is a
program-order barrier, not a cross-rank one; its counterpart here is that
a fence completes the epoch's works.  Under analysis recording a window
records its fences, puts and page traffic, as the reference's does; a put
is applied in the epoch it was issued in (the fence completes every request
of its epoch), and the fence consumes the epoch's request futures.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.analysis import events as analysis_events
from repro_torch.core import collectives, datatypes, errors, tool
from repro_torch.core._methods import _LEAF_OPERANDS
from repro_torch.core.communicator import Communicator
from repro_torch.core.descriptors import ReduceOp, WindowSpec
from repro_torch.core.futures import Future, flatten

#: Operators with no two-operand combine / cross-rank reduction — rejected
#: for accumulate with ERR_OP before any communication.
_LOC_OPS = (ReduceOp.MAXLOC, ReduceOp.MINLOC)


class Window:
    """An RMA window over a copy of this rank's local tensor or aggregate."""

    def __init__(self, comm: Communicator, local: Any, spec: WindowSpec | None = None):
        self.comm = comm
        self.spec = spec or WindowSpec()
        errors.check(
            self.spec.no_locks,
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            "passive-target lock/unlock has no counterpart; windows are "
            "active-target only (no_locks=True)",
        )
        if isinstance(local, _LEAF_OPERANDS):
            self._datatype = None
            self._buffers = [torch.as_tensor(local).clone(memory_format=torch.contiguous_format)]
        else:
            errors.check(
                datatypes.is_compliant(local),
                errors.ErrorClass.ERR_TYPE,
                f"window over a non-compliant aggregate of type "
                f"{type(local).__name__}",
            )
            self._datatype = datatypes.datatype_of(local)
            # a group of one leaf packs to a view of that leaf: copy it, so
            # that the window owns every buffer
            single = Counter(leaf.group for leaf in self._datatype.leaves)
            self._buffers = [b.clone() if single[g] == 1 else b
                             for g, b in enumerate(self._datatype.pack(local))]
        self._epoch_open = False
        # the epoch's requests in issue order, each with the tensors its
        # sends read (held until the fence completes it)
        self._pending: list[tuple[Future, list]] = []
        # monotonically increasing fence-epoch id; with the window token it
        # lets the analyzer prove a put was applied in its issue epoch
        self._epoch_id = 0
        self._win_token = analysis_events.next_token()
        # per-epoch write ledger: target rank -> page specs written (None =
        # the whole window); overlapping writes in one epoch are a data race
        self._writes: dict[int, list[tuple[int, int] | None]] = {}
        # dynamic windows (MPI_Win_create_dynamic): pages start detached and
        # must be registered with attach() before a put may target them; the
        # attached set doubles as the sub-allocation free-list
        self._attached: set[int] | None = set() if self.spec.dynamic else None
        if self.spec.dynamic:
            errors.check(
                self.spec.num_pages >= 1,
                errors.ErrorClass.ERR_COUNT,
                f"a dynamic window needs num_pages >= 1, got {self.spec.num_pages}",
            )

    # -- introspection ------------------------------------------------------

    @property
    def buffer(self) -> Any:
        """The window's local value (the aggregate view for datatype
        windows: views of the window's buffers)."""

        if self._datatype is None:
            return self._buffers[0]
        return self._datatype.unpack(self._buffers)

    @property
    def datatype(self) -> "datatypes.DataType | None":
        """The derived datatype (``None`` for plain-tensor windows)."""

        return self._datatype

    def extent(self) -> int:
        """Window size in bytes (``MPI_Win_get_attr(MPI_WIN_SIZE)``)."""

        if self._datatype is not None:
            return self._datatype.extent
        b = self._buffers[0]
        return b.numel() * b.element_size()

    # -- dynamic-window sub-allocation (MPI_Win_attach / MPI_Win_detach) ----

    def _check_dynamic(self, what: str) -> None:
        errors.check(
            self._attached is not None,
            errors.ErrorClass.ERR_RMA_ATTACH,
            f"{what} requires a dynamic window (WindowSpec(dynamic=True))",
        )

    def _check_page_ids(self, pages: Sequence[int]) -> list[int]:
        ids = [int(p) for p in pages]
        for p in ids:
            errors.check(
                0 <= p < self.spec.num_pages,
                errors.ErrorClass.ERR_RMA_RANGE,
                f"page {p} out of range for a window of {self.spec.num_pages} pages",
            )
        return ids

    def attach(self, pages: Sequence[int]) -> "Window":
        """``MPI_Win_attach``: register pages of the packed extent with the
        dynamic window, making them legal ``put`` targets.  Re-attaching an
        attached page is erroneous (``ERR_RMA_ATTACH``, as in the
        standard)."""

        self._check_dynamic("attach")
        ids = self._check_page_ids(pages)
        for p in ids:
            errors.check(
                p not in self._attached,
                errors.ErrorClass.ERR_RMA_ATTACH,
                f"page {p} is already attached",
            )
        self._attached.update(ids)
        tool.pvar_add("rma_attach", len(ids))
        if analysis_events.RECORDING:
            analysis_events.record_rma_pages("rma_attach", self._win_token, len(ids),
                                             rank=self.comm.rank())
        return self

    def detach(self, pages: Sequence[int]) -> "Window":
        """``MPI_Win_detach``: deregister pages; subsequent puts to them
        raise ``ERR_RMA_RANGE``."""

        self._check_dynamic("detach")
        ids = self._check_page_ids(pages)
        for p in ids:
            errors.check(
                p in self._attached,
                errors.ErrorClass.ERR_RMA_ATTACH,
                f"page {p} is not attached",
            )
        self._attached.difference_update(ids)
        tool.pvar_add("rma_detach", len(ids))
        if analysis_events.RECORDING:
            analysis_events.record_rma_pages("rma_detach", self._win_token, len(ids),
                                             rank=self.comm.rank())
        return self

    @property
    def attached_pages(self) -> frozenset[int]:
        """The currently attached page set (empty for static windows)."""

        return frozenset(self._attached or ())

    def free_pages(self) -> int:
        """Number of detached (allocatable) pages of a dynamic window."""

        self._check_dynamic("free_pages")
        return self.spec.num_pages - len(self._attached)

    def page_alloc(self, count: int) -> list[int]:
        """Sub-allocation hook: attach the ``count`` lowest detached pages
        and return their ids — the free-list pop a paged KV block pool rides
        (:mod:`repro_torch.runtime.kvpool`).  ``ERR_NO_MEM`` when the window
        has fewer detached pages than requested."""

        self._check_dynamic("page_alloc")
        free = sorted(set(range(self.spec.num_pages)) - self._attached)
        errors.check(
            count <= len(free),
            errors.ErrorClass.ERR_NO_MEM,
            f"window has {len(free)} free pages, {count} requested",
        )
        ids = free[:count]
        self.attach(ids)
        return ids

    def page_free(self, pages: Sequence[int]) -> "Window":
        """Sub-allocation hook: return pages to the free-list (detach)."""

        return self.detach(pages)

    def _check_attached(self, page: tuple[int, int] | None) -> None:
        """Dynamic windows only accept writes to attached memory, at the
        attach granularity (``spec.num_pages``)."""

        if self._attached is None:
            return
        if page is None:
            errors.check(
                len(self._attached) == self.spec.num_pages,
                errors.ErrorClass.ERR_RMA_RANGE,
                f"full-window put on a dynamic window with only "
                f"{len(self._attached)}/{self.spec.num_pages} pages attached",
            )
            return
        index, num_pages = page
        errors.check(
            num_pages == self.spec.num_pages,
            errors.ErrorClass.ERR_RMA_RANGE,
            f"dynamic windows are addressed at attach granularity: page "
            f"counts must equal spec.num_pages ({self.spec.num_pages}), "
            f"got {num_pages}",
        )
        errors.check(
            index in self._attached,
            errors.ErrorClass.ERR_RMA_RANGE,
            f"page {index} is not attached (attached: "
            f"{sorted(self._attached)})",
        )

    # -- epochs -------------------------------------------------------------

    def fence(self) -> "Window":
        """Open/close an access epoch (``MPI_Win_fence``).

        Completes the epoch's request-based operations in issue order
        (requests a ``then()`` continuation issued included: they joined the
        queue when the continuation ran).
        """

        tool.pvar_count("rma_fence")
        while self._pending:
            fut, _sends = self._pending.pop(0)
            fut._complete()
            fut._consume("fence")
        self._epoch_open = not self._epoch_open
        self._writes = {}
        self._epoch_id += 1
        if analysis_events.RECORDING:
            analysis_events.record_fence(self._win_token, self._epoch_id,
                                         rank=self.comm.rank())
        return self

    def _check_epoch(self):
        errors.check(
            self._epoch_open,
            errors.ErrorClass.ERR_WIN,
            "RMA access outside a fence epoch; call win.fence() first",
        )

    # -- validation ---------------------------------------------------------

    def _validate_perm(self, perm: Sequence[tuple[int, int]], *, writes: bool) -> None:
        n = self.comm.size()
        for s, d in perm:
            errors.check(
                0 <= s < n and 0 <= d < n,
                errors.ErrorClass.ERR_RANK,
                f"RMA pair ({s}, {d}) out of range for window over {n} ranks",
            )
        if writes:
            # two origins writing one target in the same epoch is a data
            # race, never last-writer-wins
            targets = [d for _, d in perm]
            errors.check(
                len(set(targets)) == len(targets),
                errors.ErrorClass.ERR_RANK,
                f"duplicate put targets in {list(perm)}: a window location "
                "may be written by at most one origin per epoch",
            )
        # one exchange carries one partner per rank and side: an origin
        # (for a get, a target read) sends at most once a call
        origins = [s for s, _ in perm]
        errors.check(
            len(set(origins)) == len(origins),
            errors.ErrorClass.ERR_RANK,
            "a rank may send to at most one destination per send_recv",
        )

    def _pages_overlap(
        self,
        a: tuple[int, int] | None,
        b: tuple[int, int] | None,
    ) -> bool:
        """Do two page specs cover a common span of the packed extent?"""

        if a is None or b is None:
            return True            # a full-window put covers every page
        (ia, na), (ib, nb) = a, b
        if na == nb:
            return ia == ib
        for ga, gb in zip(self._page_bounds(na), self._page_bounds(nb)):
            sa, la = ga[ia]
            sb, lb = gb[ib]
            if la and lb and sa < sb + lb and sb < sa + la:
                return True
        return False

    def _note_writes(
        self, perm: Sequence[tuple[int, int]], page: tuple[int, int] | None
    ) -> None:
        """Record this epoch's put targets; overlapping spans are the same
        data race the per-call duplicate check rejects, across calls."""

        for target in {d for _, d in perm}:
            for prior in self._writes.get(target, []):
                errors.check(
                    not self._pages_overlap(prior, page),
                    errors.ErrorClass.ERR_RANK,
                    f"target {target} already written this epoch "
                    f"(prior {prior}, new {page}): a window location may be "
                    "written by at most one origin per epoch",
                )
            self._writes.setdefault(target, []).append(page)

    def _check_target(self, target: int) -> None:
        errors.check(
            0 <= int(target) < self.comm.size(),
            errors.ErrorClass.ERR_RANK,
            f"target {target} out of range for window over {self.comm.size()} ranks",
        )

    def _plain_value(self, value: Any) -> torch.Tensor:
        w = self._buffers[0]
        v = torch.as_tensor(value, dtype=w.dtype, device=w.device)
        errors.check(
            tuple(v.shape) == tuple(w.shape),
            errors.ErrorClass.ERR_TRUNCATE,
            f"value shape {tuple(v.shape)} does not match window shape "
            f"{tuple(w.shape)}",
        )
        return v

    def _pack_value(self, value: Any) -> list[torch.Tensor]:
        """An origin-side value, packed to match the window layout."""

        if self._datatype is None:
            return [self._plain_value(value)]
        bufs = self._datatype.pack(value)
        return [b.to(dtype=w.dtype, device=w.device) for b, w in zip(bufs, self._buffers)]

    def _origin_spans(self, value: Any, page: tuple[int, int] | None) -> list:
        """Per window buffer, the span of ``value`` a put moves: the whole
        packed buffer, or page ``page`` of it (``None`` where the page is
        empty).  An aggregate's page is cut from its leaves, so a paged
        transfer copies no more than its page (a view, where the page lies
        in one leaf)."""

        bounds = None if page is None else [b[page[0]] for b in self._page_bounds(page[1])]
        if self._datatype is None:
            v = self._plain_value(value)
            if bounds is None:
                return [v]
            start, length = bounds[0]
            return [v[start:start + length] if length else None]
        if bounds is None:
            return self._pack_value(value)
        leaves = flatten(value)[0]
        errors.check(
            len(leaves) == len(self._datatype.leaves),
            errors.ErrorClass.ERR_COUNT,
            f"object has {len(leaves)} leaves, datatype describes "
            f"{len(self._datatype.leaves)}",
        )
        parts: list[list[torch.Tensor]] = [[] for _ in self._buffers]
        for leaf, layout in zip(leaves, self._datatype.leaves):
            buf = self._buffers[layout.group]
            arr = datatypes._as_array(leaf, buf.dtype, buf.device)
            errors.check(
                tuple(arr.shape) == layout.shape,
                errors.ErrorClass.ERR_TRUNCATE,
                f"leaf shape {tuple(arr.shape)} does not match datatype {layout.shape}",
            )
            start, length = bounds[layout.group]
            lo, hi = max(start, layout.offset), min(start + length, layout.offset + layout.size)
            if lo < hi:
                parts[layout.group].append(arr.reshape(-1)[lo - layout.offset:hi - layout.offset])
        return [None if not p else torch.cat(p) if len(p) > 1 else p[0] for p in parts]

    def _page_bounds(self, num_pages: int) -> list[list[tuple[int, int]]]:
        if self._datatype is not None:
            return self._datatype.page_bounds(num_pages)
        b = self._buffers[0]
        errors.check(
            b.dim() >= 1 or num_pages == 1,
            errors.ErrorClass.ERR_COUNT,
            "paged transfer needs a window with a leading axis",
        )
        size = b.shape[0] if b.dim() >= 1 else 1
        return [datatypes.even_page_bounds(size, num_pages)]

    # -- put / get ----------------------------------------------------------

    def _issue_put(
        self,
        value: Any,
        perm: Sequence[tuple[int, int]],
        page: tuple[int, int] | None,
    ) -> tuple[list, list]:
        """Post this rank's side of a put: send its page of ``value`` if it
        is an origin, receive into its window's page if it is a target.
        Returns (the works, the tensors the sends read)."""

        pieces = self._origin_spans(value, page)
        me = self.comm.rank()
        src = next((s for s, d in perm if d == me), None)
        dst = next((d for s, d in perm if s == me), None)
        ranks, group = self.comm.global_ranks(), self.comm.process_group()
        bounds = None if page is None else self._page_bounds(page[1])
        ops, sends = [], []
        for i, (piece, b) in enumerate(zip(pieces, self._buffers)):
            if piece is None:
                continue
            if bounds is None:
                target = b
            else:
                start, length = bounds[i][page[0]]
                target = b[start:start + length]
            if src is not None and src == me:
                target.copy_(piece)
                continue
            if dst is not None:
                piece = piece.contiguous()
                sends.append(piece)
                ops.append(dist.P2POp(dist.isend, piece, ranks[dst], group))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, target, ranks[src], group))
        works = dist.batch_isend_irecv(ops) if ops else []
        return works, sends

    def _resolve_page(
        self, page: int | tuple[int, int] | None
    ) -> tuple[int, int] | None:
        # a bare index is a page of the spec's configured count; validated
        # here, at issue, before the write ledger indexes the bounds
        if isinstance(page, int):
            page = (page, self.spec.num_pages)
        if page is not None:
            index, num_pages = page
            errors.check(
                num_pages >= 1 and 0 <= index < num_pages,
                errors.ErrorClass.ERR_COUNT,
                f"page {index} out of range for {num_pages} pages",
            )
        return page

    def _check_put(self, perm, page, *, requested: bool) -> tuple[int, int] | None:
        self._check_epoch()
        self._validate_perm(perm, writes=True)
        page = self._resolve_page(page)
        self._check_attached(page)
        self._note_writes(perm, page)
        if analysis_events.RECORDING:
            rank = self.comm.rank()
            analysis_events.record_rma_put(
                self._win_token, self._epoch_id,
                (d for _, d in perm), page, requested=requested, rank=rank)
            analysis_events.record_rma_apply(
                self._win_token, self._epoch_id, self._epoch_id, rank=rank)
        return page

    def put(
        self,
        value: Any,
        perm: Sequence[tuple[int, int]],
        *,
        page: int | tuple[int, int] | None = None,
    ) -> "Window":
        """``MPI_Put``: origin ``s`` overwrites target ``d``'s window, for the
        static pattern ``perm``.  Ranks not targeted keep their buffer.
        ``page=(i, n)`` moves only page ``i`` of ``n`` over the window's
        packed extent (leading axis for plain tensors); a bare ``page=i``
        divides by ``spec.num_pages``.  Returns once the put is complete."""

        page = self._check_put(perm, page, requested=False)
        tool.pvar_count("rma_put")
        works, _sends = self._issue_put(value, perm, page)
        for w in works:
            w.wait()
        return self

    def rput(
        self,
        value: Any,
        perm: Sequence[tuple[int, int]],
        *,
        page: int | tuple[int, int] | None = None,
    ) -> Future:
        """``MPI_Rput``: request-based put, issued now; the returned future
        completes when the data is in the target's window (``get()``, a
        ``then()`` chain, or the closing :meth:`fence`)."""

        page = self._check_put(perm, page, requested=True)
        tool.pvar_count("rma_rput")
        works, sends = self._issue_put(value, perm, page)
        fut = Future(self.buffer, works)._track("rput")
        self._pending.append((fut, sends))
        return fut

    def _issue_get(self, perm: Sequence[tuple[int, int]]) -> Future:
        self._check_epoch()
        self._validate_perm(perm, writes=False)
        fut = collectives.send_recv_start(self.comm, list(self._buffers), perm)
        out = fut._value  # the received buffers, allocated by the exchange
        value = out[0] if self._datatype is None else self._datatype.unpack(out)
        return Future(value, fut._works)

    def get(self, perm: Sequence[tuple[int, int]]) -> Any:
        """``MPI_Get``: origin ``d`` reads target ``s``'s window for each
        ``(s, d)`` — i.e. the *reverse* data flow of ``put``.  Ranks not
        reading receive zeros (the reference's convention)."""

        fut = self._issue_get(perm)
        tool.pvar_count("rma_get")
        return fut.get()

    def rget(self, perm: Sequence[tuple[int, int]]) -> Future:
        """``MPI_Rget``: request-based get; the future's value is the fetched
        tensor/aggregate."""

        fut = self._issue_get(perm)
        tool.pvar_count("rma_rget")
        self._pending.append((fut, []))
        return fut

    # -- accumulate family --------------------------------------------------

    def _resolve_op(self, op: ReduceOp | None, *, fetch: bool) -> ReduceOp:
        op = self.spec.accumulate_op if op is None else op
        errors.check(
            op not in _LOC_OPS,
            errors.ErrorClass.ERR_OP,
            f"accumulate does not support {op} (no two-operand combine)",
        )
        errors.check(
            fetch or op is not ReduceOp.NO_OP,
            errors.ErrorClass.ERR_OP,
            "NO_OP is only valid for get_accumulate / fetch_and_op",
        )
        return op

    def _apply_accumulate(self, value: Any, target: int, op: ReduceOp) -> None:
        """Reduce every origin's contribution into the target's window."""

        if op is ReduceOp.NO_OP:
            return
        me = self.comm.rank()
        for v, b in zip(self._pack_value(value), self._buffers):
            if op is ReduceOp.REPLACE:
                # MPI leaves the multi-origin order undefined; the reference
                # pins it: the lowest-ranked origin's contribution is the
                # one deposited
                new = collectives.broadcast(self.comm, v, root=0)
            else:
                total = collectives._reduce_array(self.comm, v, op)
                new = collectives.combine(op, b, total)
            if me == target:
                b.copy_(new.to(b.dtype))

    def accumulate(
        self,
        value: Any,
        target: int,
        op: ReduceOp | None = None,
    ) -> "Window":
        """``MPI_Accumulate``: every origin's contribution reduces into the
        target's window (all ranks contribute; pass the op's identity to
        opt out, the reference's convention).  ``op`` defaults to
        ``spec.accumulate_op``.  The RMA-only ``REPLACE`` (put semantics)
        deposits the **lowest-ranked** origin's contribution."""

        self._check_epoch()
        self._check_target(target)
        tool.pvar_count("rma_accumulate")
        self._apply_accumulate(value, target, self._resolve_op(op, fetch=False))
        return self

    def raccumulate(
        self,
        value: Any,
        target: int,
        op: ReduceOp | None = None,
    ) -> Future:
        """``MPI_Raccumulate``: request-based accumulate, applied at issue
        (its reductions are blocking collectives); the future's value is
        the window's."""

        self._check_epoch()
        self._check_target(target)
        op = self._resolve_op(op, fetch=False)
        tool.pvar_count("rma_accumulate")
        self._apply_accumulate(value, target, op)
        fut = Future(self.buffer, ())
        self._pending.append((fut, []))
        return fut

    def get_accumulate(
        self,
        value: Any,
        target: int,
        op: ReduceOp | None = None,
    ) -> Any:
        """``MPI_Get_accumulate``: fetch the target's *prior* window value
        (delivered to every origin) and reduce the contributions in.
        ``op=NO_OP`` is a pure fetch."""

        self._check_epoch()
        self._check_target(target)
        op = self._resolve_op(op, fetch=True)
        old = [collectives.broadcast(self.comm, b, root=target) for b in self._buffers]
        self._apply_accumulate(value, target, op)
        if self._datatype is None:
            return old[0]
        return self._datatype.unpack(old)

    def _element(self, what: str, index: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(the flat window, its element ``index`` as a copy of shape (1,))
        of a plain-tensor window."""

        errors.check(
            self._datatype is None,
            errors.ErrorClass.ERR_TYPE,
            f"{what} operates on a plain-tensor window (one element)",
        )
        flat = self._buffers[0].reshape(-1)
        errors.check(
            0 <= index < flat.shape[0],
            errors.ErrorClass.ERR_COUNT,
            f"element index {index} out of range for window of {flat.shape[0]}",
        )
        return flat, flat[index:index + 1].clone()

    def fetch_and_op(
        self,
        value: Any,
        target: int,
        op: ReduceOp | None = None,
        *,
        index: int = 0,
    ) -> torch.Tensor:
        """``MPI_Fetch_and_op``: the single-element ``get_accumulate`` —
        fetch element ``index`` of the target's window (flattened), combine
        ``value`` in.  Plain-tensor windows only (MPI restricts this call to
        one predefined-datatype element)."""

        self._check_epoch()
        self._check_target(target)
        op = self._resolve_op(op, fetch=True)
        flat, cur = self._element("fetch_and_op", index)
        old = collectives.broadcast(self.comm, cur, root=target)
        if op is not ReduceOp.NO_OP:
            v = torch.as_tensor(value, dtype=flat.dtype, device=flat.device).reshape(1)
            if op is ReduceOp.REPLACE:
                # lowest-ranked origin's value, as in _apply_accumulate
                new = collectives.broadcast(self.comm, v, root=0)
            else:
                new = collectives.combine(op, cur, collectives._reduce_array(self.comm, v, op))
            if self.comm.rank() == target:
                flat[index:index + 1] = new.to(flat.dtype)
        return old.reshape(())

    def compare_and_swap(
        self,
        compare: Any,
        value: Any,
        target: int,
        *,
        index: int = 0,
    ) -> torch.Tensor:
        """``MPI_Compare_and_swap``: fetch element ``index`` of the target's
        window; iff it equals ``compare``, replace it with ``value``.
        Returns the fetched (prior) element on every origin."""

        self._check_epoch()
        self._check_target(target)
        flat, cur = self._element("compare_and_swap", index)
        old = collectives.broadcast(self.comm, cur, root=target)
        if self.comm.rank() == target:
            c = torch.as_tensor(compare, dtype=flat.dtype, device=flat.device).reshape(1)
            v = torch.as_tensor(value, dtype=flat.dtype, device=flat.device).reshape(1)
            flat[index:index + 1] = torch.where(cur == c, v, cur)
        return old.reshape(())


def create_window(comm: Communicator, local: Any, spec: WindowSpec | None = None):
    """``MPI_Win_create`` analogue (tensors and compliant aggregates)."""

    return Window(comm, local, spec)
