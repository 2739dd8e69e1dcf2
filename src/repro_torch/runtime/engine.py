"""Continuous-batching serving engine on the paged-KV slot table, the
:mod:`repro.runtime.engine` of the reference in eager PyTorch.

The :class:`~repro_torch.runtime.server.Server` decodes fixed batches: every
request in a batch prefills together, decodes together, and the batch holds
its slots until the *slowest* member finishes.  This engine removes that
head-of-line blocking while reusing the Server's substrate unchanged:

* **slot table** — one cache of ``max_batch`` rows, each
  ``prompt_bucket + max_new_tokens`` tokens deep, with a *per-row* position
  vector (the model's decode path accepts ``pos`` as ``(B,)`` — see
  :func:`repro_torch.models.attention.cache_layer_update`).  Rows decode at
  ragged depths inside one persistent decode request;
* **paged block pool** — the slot table is carved into fixed KV blocks
  (:class:`~repro_torch.runtime.kvpool.KVBlockPool`); requests allocate
  blocks as they deepen and a budget cap forces *preemption* (``ERR_NO_MEM``
  answered by evicting the latest-admitted row) under memory pressure;
* **in-flight admission** — new requests prefill in a side batch (the
  Server's persistent prefill request, bucketed by padded length) and are
  spliced into free slots of the *running* cache, joining the next decode
  iteration;
* **retirement** — a row leaves its slot the moment it emits the stop token
  or exhausts its own ``max_new`` budget; the freed blocks are reused
  verbatim by the next admission.

**Parity contract** (the reference's): at ``temperature=0`` every request's
generated tokens are identical, token for token, to what
:meth:`Server.generate` produces for the same prompt left-padded to
``prompt_bucket`` — including requests admitted mid-flight and requests
preempted and resumed (resume re-prefills ``prompt + generated[:-1]`` at the
same cache positions, so the recomputed KV is the evicted KV).  The
capacity-bounded MoE dispatch breaks it in both packages: which tokens a
full expert drops depends on the other rows of the batch (ROADMAP C15).

**CUDA graphs**: the decode step is the Server's donating decode request on
the slot table, so on the card its start 1 runs eagerly, start 2 captures
and later starts replay.  The graph reads the slot table in place, and
:meth:`Engine.run` releases it at its end, as ``Server.generate`` does: one
capture a run.  The insert of an admitted row is **eager and in place**
(a copy of the row's cache slices into the slot table's own buffers, and
of its position and pending token), where the reference compiles a
donating insert request: as a graph, the insert would copy the side
batch's cache, which it does not donate, into buffers of its own at every
start (up to a whole prefill cache), and each side-batch signature (every
resume depth) would pin a graph pool of its own.  In place, an admission
or a preemption neither copies the slot table nor recaptures the decode
step.  ``trace:insert_row`` still counts one per signature.

**Placed server** (a communicator whose model axis has more than one
rank, or parameters the caller placed): the slot table is the placed
prefill's cache under ``cache_specs``, with a per-row position vector
every rank holds whole (replicated); the decode graph is captured over the
placed step, and an admitted row is copied between local shards where the
batch axis is not split, through a redistribution of the side batch's
rows where it is (:func:`_insert_placed`).  The reference's engine raises
on a grid whose data axis splits the slot table (ROADMAP C19); the port's
serves it.

Sampling above temperature 0 draws from one ``torch.Generator`` seeded
from ``scfg.seed`` and advanced by every draw; the reference folds the step
into a JAX key, so the two packages agree on determinism, not on samples.
The engine reads the sampled tokens once a step (the reference's design),
outside the graph.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import errors, tool
from repro_torch.core.futures import PersistentRequest, argument_signature, flatten
from repro_torch.runtime.kvpool import KVBlockPool
from repro_torch.runtime.server import Request, Server, _synchronize
from repro_torch.sharding.local import is_dtensor, shard_range

tool.pvar_register("engine:admit", "requests admitted into a running decode batch")
tool.pvar_register("engine:retire", "requests retired from the continuous batch")
tool.pvar_register("engine:preempt", "requests preempted under block-pool pressure")
tool.pvar_register("trace:insert_row", "decode-row insert kernels traced (want 1 per shape)")


@dataclasses.dataclass
class EngineConfig:
    """Engine knobs on top of the Server's :class:`ServerConfig` (which
    contributes ``max_batch`` slots, the ``max_new_tokens`` ceiling,
    ``temperature``, ``seed`` and ``stop_token``)."""

    prompt_bucket: int = 8        # every prompt is left-padded to this length
    block_tokens: int = 4         # KV block (page) granularity in tokens
    pool_blocks: int | None = None  # live-block budget; None = uncapped pool


#: request lifecycle states (the admission/preemption state machine)
WAITING, RUNNING, PREEMPTED, FINISHED = "waiting", "running", "preempted", "finished"


@dataclasses.dataclass
class ServingRequest:
    """One request's ticket through the engine."""

    tokens: np.ndarray                 # (prompt_len,) int32, prompt_len <= bucket
    max_new: int                       # this request's own generation budget
    rid: int = -1
    state: str = WAITING
    slot: int | None = None
    generated: list = dataclasses.field(default_factory=list)
    cached_tokens: int = 0             # tokens currently materialised in KV
    admit_seq: int = -1                # admission order (preemption victims
                                       # are picked newest-first)
    preemptions: int = 0
    block_ids: list = dataclasses.field(default_factory=list)
    arrival_s: float = 0.0
    first_token_s: float | None = None
    finish_s: float | None = None


class Engine:
    """Continuous-batching scheduler over a Server's persistent requests."""

    @torch.inference_mode()
    def __init__(self, server: Server, ecfg: EngineConfig):
        cfg, scfg = server.cfg, server.scfg
        errors.check(
            cfg.family in ("dense", "moe"),
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            f"the continuous-batching engine serves dense/moe LMs; "
            f"family {cfg.family!r} keeps the fixed-batch Server",
        )
        errors.check(
            cfg.sliding_window is None and cfg.layer_pattern == "uniform",
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            "sliding-window / local_global caches are ring buffers; the "
            "paged slot table requires linear (uniform) cache layout",
        )
        errors.check(
            ecfg.prompt_bucket >= 1 and scfg.max_new_tokens >= 1,
            errors.ErrorClass.ERR_ARG,
            f"need prompt_bucket >= 1 and max_new_tokens >= 1, got "
            f"{ecfg.prompt_bucket}/{scfg.max_new_tokens}",
        )
        self.server = server
        self.ecfg = ecfg
        self.scfg = scfg
        self.num_slots = scfg.max_batch
        self.capacity = ecfg.prompt_bucket + scfg.max_new_tokens
        self.pool = KVBlockPool(
            num_slots=self.num_slots,
            slot_capacity=self.capacity,
            block_tokens=ecfg.block_tokens,
            budget_blocks=ecfg.pool_blocks,
        )
        self.waiting: collections.deque[ServingRequest] = collections.deque()
        self.active: list[ServingRequest | None] = [None] * self.num_slots
        self.finished: list[ServingRequest] = []
        self._decode_req: PersistentRequest | None = None
        self._rid = 0
        self._admit_seq = 0
        # the sampler's generator, advanced by every draw (argmax ignores it)
        self._gen = torch.Generator(device=server.device).manual_seed(scfg.seed)
        self._steps = 0
        self._preempt_count = 0
        self._generated_total = 0

        # the slot-table cache: a throwaway prefill at the bucket shape gives
        # the exact tree/dtypes (and, on a placed server, the placements
        # under cache_specs) the decode loop will carry, then the scalar
        # position becomes the per-row (all-empty) position vector
        batch = {"tokens": torch.zeros((self.num_slots, ecfg.prompt_bucket), dtype=torch.int32,
                                       device=server.device)}
        _, cache = server._prefill_request(batch)(server.params, batch)
        self.cache = {k: dataclasses.replace(v, pos=_positions(flatten(v)[0][0], self.num_slots))
                      for k, v in cache.items()}
        self.tok = torch.zeros((self.num_slots, 1), dtype=torch.int32, device=server.device)

    # -- submission -----------------------------------------------------------

    def submit(self, request, max_new: int | None = None) -> ServingRequest:
        """Queue a request (a server :class:`Request` or a raw token array).
        ``max_new`` caps this request's generation below the engine ceiling."""

        if isinstance(request, Request):
            errors.check(
                not request.extra,
                errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
                "the engine buckets prompts by length; per-request extras "
                "are a fixed-batch Server feature",
            )
            tokens = np.asarray(request.tokens, np.int32)
        else:
            tokens = np.asarray(request, np.int32)
        errors.check(
            1 <= len(tokens) <= self.ecfg.prompt_bucket,
            errors.ErrorClass.ERR_TRUNCATE,
            f"prompt of {len(tokens)} tokens does not fit the "
            f"{self.ecfg.prompt_bucket}-token bucket",
        )
        budget = self.scfg.max_new_tokens if max_new is None else int(max_new)
        errors.check(
            1 <= budget <= self.scfg.max_new_tokens,
            errors.ErrorClass.ERR_ARG,
            f"max_new={budget} outside [1, {self.scfg.max_new_tokens}]",
        )
        r = ServingRequest(
            tokens=tokens, max_new=budget, rid=self._rid,
            arrival_s=time.perf_counter(),
        )
        self._rid += 1
        self.waiting.append(r)
        return r

    # -- admission ------------------------------------------------------------

    def _padded_content(self, r: ServingRequest) -> np.ndarray:
        """What a (re-)prefill must materialise: the prompt left-padded to
        the bucket, plus all generated tokens *except* the pending one (the
        last sampled token's KV is written by its own decode step)."""

        bucket = self.ecfg.prompt_bucket
        out = np.zeros((bucket + max(0, len(r.generated) - 1),), np.int32)
        out[bucket - len(r.tokens):bucket] = r.tokens
        if len(r.generated) > 1:
            out[bucket:] = np.asarray(r.generated[:-1], np.int32)
        return out

    def _insert(self, pcache, dst: int, src: int, t: int) -> None:
        """Row ``src`` of the side batch's cache into slot ``dst`` of the
        slot table, in place (see the module docstring): every cache leaf
        along its batch axis (1 of the stacked (L, B, S, ...) layout), the
        slot's position from the side batch's scalar one, and the slot's
        pending token."""

        key = (argument_signature((self.cache, self.tok)), argument_signature(pcache))
        if key not in self.server.engine_insert_sigs:
            self.server.engine_insert_sigs.add(key)
            tool.pvar_count("trace:insert_row")
        for cd, cs in zip(flatten(self.cache)[0], flatten(pcache)[0]):
            if cd.dim() == 1:   # the position vector vs the scalar pos
                (cd.to_local() if is_dtensor(cd) else cd)[dst] = (
                    cs.to_local() if is_dtensor(cs) else cs)
            elif is_dtensor(cd):
                _insert_placed(cd, cs, dst, src)
            else:
                cd[:, dst].copy_(cs[:, src])
        # a fill from a host int, eager: the decode graph, captured apart,
        # reads the pending-token buffer in place and never records this
        self.tok[dst, 0] = t

    def _admit(self, now: float) -> None:
        free = [s for s in range(self.num_slots) if self.active[s] is None]
        admitted: list[tuple[ServingRequest, int, int]] = []
        while free and self.waiting:
            r = self.waiting[0]
            plen = self.ecfg.prompt_bucket + max(0, len(r.generated) - 1)
            slot = free[0]
            if not self.pool.fits(slot, plen):
                break   # head-of-line under memory pressure: no skip-ahead
            self.waiting.popleft()
            free.pop(0)
            self.pool.ensure(slot, plen)
            admitted.append((r, slot, plen))
        if not admitted:
            return

        # prefill one side batch per padded length (resumed requests carry
        # their regenerated prefix, so their bucket is deeper); rows are
        # padded to the next power of two — a handful of shape buckets,
        # without paying a full max_batch prefill for a single admission
        by_len: dict[int, list[tuple[ServingRequest, int]]] = {}
        for r, slot, plen in admitted:
            by_len.setdefault(plen, []).append((r, slot))
        server = self.server
        for plen, group in sorted(by_len.items()):
            nrows = min(self.num_slots, 1 << (len(group) - 1).bit_length())
            toks = np.zeros((nrows, plen), np.int32)
            for row, (r, _slot) in enumerate(group):
                toks[row] = self._padded_content(r)
            batch = {"tokens": torch.as_tensor(toks, device=server.device)}
            extra = self.capacity - plen
            logits, pcache = server._prefill_request(batch, extra_capacity=extra)(
                server.params, batch)
            first_host = server._sample(logits, self._gen).cpu().numpy()
            for row, (r, slot) in enumerate(group):
                if r.generated:
                    t = int(r.generated[-1])   # resumed: pending token
                else:
                    t = int(first_host[row])   # fresh: sample prefill logits
                    r.generated.append(t)
                    r.first_token_s = now
                    self._generated_total += 1
                    stopped = (
                        self.scfg.stop_token is not None
                        and t == self.scfg.stop_token
                    )
                    if stopped or r.max_new <= 1:
                        # done before ever occupying a decode slot
                        self.pool.release(slot)
                        r.state, r.finish_s = FINISHED, time.perf_counter()
                        self.finished.append(r)
                        tool.pvar_count("engine:retire")
                        continue
                self._insert(pcache, slot, row, t)
                r.state, r.slot = RUNNING, slot
                r.cached_tokens = plen
                r.admit_seq = self._admit_seq
                self._admit_seq += 1
                r.block_ids = self.pool.block_ids(slot)
                self.active[slot] = r
                tool.pvar_count("engine:admit")

    # -- preemption -----------------------------------------------------------

    def _preempt(self, slot: int) -> None:
        r = self.active[slot]
        self.pool.release(slot)
        r.state, r.slot = PREEMPTED, None
        r.preemptions += 1
        self.active[slot] = None
        # front of the queue: a preempted request outranks fresh arrivals,
        # so eviction cannot starve it
        self.waiting.appendleft(r)
        self._preempt_count += 1
        tool.pvar_count("engine:preempt")

    def _grow_or_preempt(self) -> None:
        """Before firing the decode step, every running row must own a block
        for the token it is about to write; ``ERR_NO_MEM`` on growth evicts
        the latest-admitted row (possibly the grower itself)."""

        bt = self.ecfg.block_tokens
        if not any(
            r is not None and r.cached_tokens % bt == 0 for r in self.active
        ):
            return   # nobody crosses a block boundary this step
        order = sorted(
            (s for s in range(self.num_slots) if self.active[s] is not None),
            key=lambda s: self.active[s].admit_seq,
        )
        for s in order:
            r = self.active[s]
            if r is None:
                continue   # evicted earlier in this pass
            if r.cached_tokens % bt != 0:
                continue   # current block still has room for the next token
            while True:
                try:
                    self.pool.ensure(s, r.cached_tokens + 1)
                    r.block_ids = self.pool.block_ids(s)
                    break
                except errors.NoMemError:
                    victim = max(
                        (v for v in range(self.num_slots) if self.active[v] is not None),
                        key=lambda v: self.active[v].admit_seq,
                    )
                    self._preempt(victim)
                    if victim == s:
                        break   # the grower lost its own slot

    # -- the scheduler loop ---------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[ServingRequest]:
        """One scheduler iteration: admit, grow (preempting under pressure),
        fire the persistent decode step, append/retire.  Returns the
        requests that finished this step."""

        now = time.perf_counter()
        self._admit(now)
        self._grow_or_preempt()
        if not any(r is not None for r in self.active):
            return []

        server = self.server
        # the slot table's signature never changes, so the persistent
        # request is resolved once and re-fired ever after
        if self._decode_req is None:
            self._decode_req = server._decode_request(self.cache, self.tok)
        logits, self.cache = self._decode_req(server.params, self.cache, self.tok)
        tok = server._sample(logits, self._gen)
        self.tok = tok[:, None]
        tok_host = tok.cpu().numpy()
        self._steps += 1

        done: list[ServingRequest] = []
        now = time.perf_counter()
        for s in range(self.num_slots):
            r = self.active[s]
            if r is None:
                continue
            t = int(tok_host[s])
            r.generated.append(t)
            r.cached_tokens += 1
            self._generated_total += 1
            stopped = self.scfg.stop_token is not None and t == self.scfg.stop_token
            if stopped or len(r.generated) >= r.max_new:
                self.pool.release(s)
                r.state, r.slot = FINISHED, None
                r.finish_s = now
                self.active[s] = None
                self.finished.append(r)
                done.append(r)
                tool.pvar_count("engine:retire")
        return done

    def run(self) -> list[ServingRequest]:
        """Drain the queue: step until nothing is waiting or running.  The
        decode step's graph, which reads the slot table, is released at the
        end (the next run captures again)."""

        while self.waiting or any(r is not None for r in self.active):
            self.step()
        if self._decode_req is not None:
            _synchronize(self.server.device)
            self._decode_req.release()
        return self.finished

    # -- bookkeeping ----------------------------------------------------------

    def stats(self) -> dict:
        # generated_tokens counts every sampled token exactly once: the
        # prefill-sampled first token at admission, one per row per decode step
        return {
            "steps": self._steps,
            "preemptions": self._preempt_count,
            "generated_tokens": self._generated_total,
            "finished": len(self.finished),
            "waiting": len(self.waiting),
            "running": sum(1 for r in self.active if r is not None),
            "pool_live_blocks": self.pool.live_blocks,
            "pool_budget_blocks": self.pool.budget_blocks,
        }


def _positions(like, slots: int):
    """The slot table's all-empty per-row position vector: a DTensor every
    rank holds whole where the cache is placed (``like`` a DTensor), so the
    decode step takes and returns it in one layout."""

    pos = torch.zeros((slots,), dtype=torch.int32, device=like.device)
    if not is_dtensor(like):
        return pos
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _insert_placed(cd, cs, dst: int, src: int) -> None:
    """Row ``src`` of the side batch's placed cache leaf ``cs`` into slot
    ``dst`` of the slot table's leaf ``cd`` (both (L, B, ...) DTensors
    under ``cache_specs``), in place in ``cd``'s local shard: ``cs`` is
    brought to ``cd``'s placements with its rows whole (nothing moves
    where neither batch axis is split: the copy is between local shards),
    and the rank whose rows of ``cd`` hold ``dst`` copies the row."""

    from torch.distributed.tensor import Replicate

    mesh = cd.device_mesh
    rows = [Replicate() if p.is_shard(1) else p for p in cd.placements]
    if list(cs.placements) != rows:
        cs = cs.redistribute(mesh, rows)
    off, count = shard_range(cd.placements, mesh, 1, cd.shape[1])
    if off <= dst < off + count:
        cd.to_local()[:, dst - off].copy_(cs.to_local()[:, src])


def make_engine(server: Server, ecfg: EngineConfig | None = None) -> Engine:
    """Factory: a continuous-batching engine over an existing Server."""

    return Engine(server, ecfg if ecfg is not None else EngineConfig())
