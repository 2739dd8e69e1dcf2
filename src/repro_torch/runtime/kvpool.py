"""Paged KV block pool: sub-allocation accounting over a serving cache.

The continuous-batching engine (:mod:`repro_torch.runtime.engine`) stores
every request's KV in a fixed slot table — a cache of ``num_slots`` rows,
each ``slot_capacity`` tokens deep.  This module carves that storage into fixed
*blocks* of ``block_tokens`` tokens (the vLLM page) and accounts for them
like MPI sub-allocated window memory:

* block ``slot * blocks_per_slot + j`` backs tokens
  ``[j * block_tokens, (j + 1) * block_tokens)`` of ``slot`` — blocks are
  slot-affine because the cache layout is slot-major;
* a *budget* (``budget_blocks``) caps how many blocks may be live at once.
  The budget is what creates memory pressure: the engine admits and grows
  requests block-by-block and must preempt somebody when ``ensure`` raises
  ``ERR_NO_MEM``;
* bound to a *dynamic* RMA window (``WindowSpec(dynamic=True)``, the
  ``MPI_Win_create_dynamic`` analogue), every allocation attaches the
  matching window pages and every release detaches them — the attach set IS
  the free-list, and a ``put`` to an unallocated block fails with
  ``ERR_RMA_RANGE`` instead of silently landing in freed memory.

All accounting is host-side; the arrays never move.  The window is a
dynamic :class:`~repro_torch.core.onesided.Window` (``create_window(comm,
cache, WindowSpec(dynamic=True, num_pages=pool.total_blocks))``);
:meth:`KVBlockPool.bind_window` reads its ``spec`` and calls its
``attach`` and ``detach``.
"""

from __future__ import annotations

import math

from repro_torch.core import errors, tool

tool.pvar_register("kvpool_alloc", "KV blocks allocated (window pages attached)")
tool.pvar_register("kvpool_free", "KV blocks released (window pages detached)")


class KVBlockPool:
    """Free-list + per-slot block tables for a slot-major paged KV cache."""

    def __init__(
        self,
        *,
        num_slots: int,
        slot_capacity: int,
        block_tokens: int,
        budget_blocks: int | None = None,
    ):
        errors.check(
            num_slots >= 1 and slot_capacity >= 1 and block_tokens >= 1,
            errors.ErrorClass.ERR_ARG,
            f"pool needs positive num_slots/slot_capacity/block_tokens, got "
            f"{num_slots}/{slot_capacity}/{block_tokens}",
        )
        self.num_slots = int(num_slots)
        self.slot_capacity = int(slot_capacity)
        self.block_tokens = int(block_tokens)
        self.blocks_per_slot = math.ceil(slot_capacity / block_tokens)
        self.total_blocks = self.num_slots * self.blocks_per_slot
        self.budget_blocks = (
            self.total_blocks if budget_blocks is None else int(budget_blocks)
        )
        errors.check(
            self.blocks_per_slot <= self.budget_blocks <= self.total_blocks,
            errors.ErrorClass.ERR_NO_MEM,
            f"budget_blocks={self.budget_blocks} must cover at least one full "
            f"slot ({self.blocks_per_slot} blocks; a single request could "
            f"never run) and at most the pool ({self.total_blocks})",
        )
        self._held: dict[int, int] = {}   # slot -> blocks held (prefix count)
        self._live = 0
        self._window = None

    # -- geometry -----------------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cached tokens."""

        return math.ceil(int(tokens) / self.block_tokens)

    def block_ids(self, slot: int, count: int | None = None) -> list[int]:
        """The (slot-affine) block ids backing ``slot``'s first ``count``
        blocks (all held blocks when ``count`` is None)."""

        n = self._held.get(int(slot), 0) if count is None else int(count)
        base = int(slot) * self.blocks_per_slot
        return [base + j for j in range(n)]

    @property
    def live_blocks(self) -> int:
        return self._live

    @property
    def free_blocks(self) -> int:
        return self.budget_blocks - self._live

    def held(self, slot: int) -> int:
        return self._held.get(int(slot), 0)

    def fits(self, slot: int, tokens: int) -> bool:
        """Would :meth:`ensure` succeed without raising?"""

        grow = self.blocks_for(tokens) - self.held(slot)
        return grow <= 0 or self._live + grow <= self.budget_blocks

    # -- allocation ---------------------------------------------------------

    def ensure(self, slot: int, tokens: int) -> list[int]:
        """Grow ``slot``'s table to cover ``tokens`` cached tokens; returns
        the newly allocated block ids ([] when already covered).  Raises
        ``ERR_NO_MEM`` when the budget cannot absorb the growth — the signal
        the engine answers with preemption."""

        slot = int(slot)
        errors.check(
            0 <= slot < self.num_slots,
            errors.ErrorClass.ERR_ARG,
            f"slot {slot} outside pool of {self.num_slots}",
        )
        need = self.blocks_for(tokens)
        errors.check(
            need <= self.blocks_per_slot,
            errors.ErrorClass.ERR_RMA_RANGE,
            f"{tokens} tokens need {need} blocks, a slot holds only "
            f"{self.blocks_per_slot} ({self.slot_capacity} tokens)",
        )
        have = self.held(slot)
        if need <= have:
            return []
        grow = need - have
        if self._live + grow > self.budget_blocks:
            errors.fail(
                errors.ErrorClass.ERR_NO_MEM,
                f"slot {slot} needs {grow} more block(s); "
                f"{self.free_blocks} of {self.budget_blocks} free",
            )
        base = slot * self.blocks_per_slot
        ids = [base + j for j in range(have, need)]
        self._held[slot] = need
        self._live += grow
        tool.pvar_add("kvpool_alloc", grow)
        if self._window is not None:
            self._window.attach(ids)
        return ids

    def release(self, slot: int) -> list[int]:
        """Free every block ``slot`` holds (request retired or preempted);
        returns the freed ids.  Freed ids are reused verbatim by the next
        occupant of the slot — the block-table reuse the engine tests pin."""

        slot = int(slot)
        have = self._held.pop(slot, 0)
        if not have:
            return []
        base = slot * self.blocks_per_slot
        ids = [base + j for j in range(have)]
        self._live -= have
        tool.pvar_add("kvpool_free", have)
        if self._window is not None:
            self._window.detach(ids)
        return ids

    # -- RMA window binding --------------------------------------------------

    def bind_window(self, window) -> None:
        """Mirror the pool into a dynamic RMA window: one window page per
        block.  From here on ``ensure``/``release`` attach/detach the
        matching pages, so remote KV writes (prefill ``rput``\\ s into the
        decode ranks' window) can only target live blocks."""

        errors.check(
            getattr(window.spec, "dynamic", False),
            errors.ErrorClass.ERR_WIN,
            "pool binding needs a dynamic window (WindowSpec(dynamic=True))",
        )
        errors.check(
            window.spec.num_pages == self.total_blocks,
            errors.ErrorClass.ERR_RMA_RANGE,
            f"window has {window.spec.num_pages} pages, pool has "
            f"{self.total_blocks} blocks — one page per block required",
        )
        self._window = window
        live = [b for s in self._held for b in self.block_ids(s)]
        if live:
            window.attach(live)
