"""The Server: batched prefill + decode serving loop, the single-group
:class:`repro.runtime.server.Server` in eager PyTorch.

Requests are grouped into one batch (left-padded so the last prompt tokens
align), prefilled once, then decoded step by step over the model's cache:
the KV cache of the dense and MoE families, deepseek's latent
``MLACache``, the ``SSMCache`` of Mamba-2, the ``HybridCache`` of zamba2,
the ``EncDecCache`` of the encoder-decoder.

**Persistent steps**: prefill and the single-token decode step are each
bound once per argument signature as a
:class:`~repro_torch.core.futures.PersistentRequest` and re-fired
``MPI_Start``-style; ``trace:prefill_step`` / ``trace:decode_step`` count
one per signature, when the request is built — the reference's "one trace
per shape bucket" invariant (the reference counts while tracing; the port
counts the builds).  The decode step donates its cache, as the reference's
does, so on the card it is a CUDA graph: the first decode step of a
server's first ``generate`` runs eagerly, the second captures the step and
every later step replays it.  The prefill donates nothing and stays eager:
it keeps the card busy nearly all its wall time already (``PERF.md`` §5),
and a graph per prompt-length bucket would pin a whole prefill's working
memory.

**One decode graph a generate**: the graph reads the cache it was captured
on in place.  At the end of each ``generate`` the server releases it, and
the next ``generate`` captures again on its own prefill's cache (one
capture, with no eager warm-up, a call).  Keeping the graph would instead
copy each new cache into the captured one, and keep the old cache alive
through the next prefill beside the new one.

**Placement** (:mod:`repro_torch.sharding.rules`): on a communicator
whose ``model`` axis has more than one rank the server places its
parameters under ``param_specs`` as DTensors on the communicator's
``device_mesh`` (every rank builds the same weights from the same seed and
keeps its shard), and the prefill's cache under ``cache_specs`` (batch over
the data axes, heads or, with ``seq_shard_cache``, the sequence over
``model``).  DTensor's sharding propagation computes what the unsharded
model computes, and the kernels see local shards
(:mod:`repro_torch.sharding.local`).  With ``seq_shard_cache`` and
``flash_decode_merge`` the decode step gets the communicator, and each
model shard attends over its slice of the cache.  Every rank runs
``generate`` on the same requests and returns the same tokens.  A placed
batch whose rows the data axes do not split is replicated over them, as
the reference replicates it: each step then runs off the data axes
(:func:`~repro_torch.sharding.local.replicating`).

The mesh selects the layout, and no option does.  **A communicator whose
model axis is one rank keeps plain tensors**, a communicator of one rank
included: the server draws the whole model on every rank before it places
it, so a model it serves fits one rank, and placing it over the data axes
alone would only add a gather of the whole model's data shards to every
step, and DTensor's per-op host dispatch, for no memory at the step's
peak.  Each rank then runs the whole model on the whole batch, as the
data-parallel server did before placement was ported.  Parameters the
caller placed (``rules.distribute``, as the chip phase does on its mesh of
one) are served as placed ones.

**Ring attention**: with ``pcfg.ring_attention`` the prefill gets the
communicator, as the reference's gets its mesh, and shards each eligible
layer's sequence over the ring (``models/attention.py``).  The parameters
are placed as without the ring: on placed weights the projections come
sharded by heads, and each eligible layer redistributes them to this
rank's sequence block of every head for the ring kernel, then back for
``wo``.  The prefill's cache is placed under ``cache_specs`` and the decode
runs on it as on any placed cache.

The continuous-batching engine (:mod:`repro_torch.runtime.engine`) runs
over a server's persistent prefill and decode requests.

**Disaggregated prefill/decode** (:class:`DisaggregatedServer`): the
serving process set is split into a *prefill* group and a *decode* group;
prefill ranks compute the KV cache and ``rput`` it page by page into an RMA
window on the decode ranks (:mod:`repro_torch.core.onesided`), and the
decode group rides its persistent decode request.  At ``temperature=0``
the generated tokens equal the single-group :meth:`Server.generate`'s.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import collectives, errors, futures, onesided, tool, topology
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import PersistentRequest, argument_signature, flatten, unflatten
from repro_torch.core.session import UNDEFINED, Session, default_session
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.models import api as model_api
from repro_torch.sharding import local as sharding_local
from repro_torch.sharding import rules

tool.pvar_register("trace:prefill_step", "prefill requests built (want 1 per shape bucket)")
tool.pvar_register("trace:decode_step", "decode requests built (want 1 per shape bucket)")
tool.pvar_register("trace:kv_transfer", "KV-transfer requests built (want 1 per shape)")


@dataclasses.dataclass
class ServerConfig:
    max_batch: int = 8
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0
    # generation stops for a row once it emits this token; ``None`` decodes
    # the full ``max_new_tokens`` budget for every row
    stop_token: int | None = None


@dataclasses.dataclass
class Request:
    tokens: np.ndarray             # (prompt_len,) int32
    extra: dict = dataclasses.field(default_factory=dict)


def generation_lengths(tokens: np.ndarray, stop_token: int | None) -> np.ndarray:
    """Per-request generated length: tokens up to and including the first
    stop token; the full row when it never stops (or no stop is configured)."""

    b, n = tokens.shape
    if stop_token is None:
        return np.full((b,), n, np.int64)
    hit = tokens == stop_token
    return np.where(hit.any(axis=1), hit.argmax(axis=1) + 1, n).astype(np.int64)


def _mesh_of(tree):
    """The device mesh of a placed tree (its first leaf a DTensor), else
    ``None``."""

    leaves, _ = flatten(tree)
    first = leaves[0] if leaves else None
    return first.device_mesh if sharding_local.is_dtensor(first) else None


def _whole(tree):
    """Every DTensor leaf of ``tree`` as the whole tensor."""

    leaves, treedef = flatten(tree)
    return unflatten(treedef, [t.full_tensor() if sharding_local.is_dtensor(t) else t
                               for t in leaves])


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """``comm`` picks the device (this rank's); without one, a host
    communicator over ``device`` (``"cuda"`` unless ``"cpu"`` is asked).

    On the card each ``generate`` decodes through a CUDA graph of the decode
    step captured on that call's cache and released at its end (see the
    module docstring): it costs one capture a call.  Copying every new cache
    into one kept graph's instead would hold two caches at the next
    prefill, which qwen1.5-32b's peak beside its weights does not leave
    room for (``PERF.md`` §5)."""

    def __init__(
        self,
        cfg: ModelConfig,
        pcfg: ParallelConfig,
        scfg: ServerConfig,
        comm: Communicator | None = None,
        *,
        device: str | None = None,
    ):
        self.cfg, self.pcfg, self.scfg = cfg, pcfg, scfg
        self.comm = comm if comm is not None else make_host_communicator(device=device)
        self.device = self.comm.device
        self.bundle = model_api.build(cfg)
        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        with torch.inference_mode():
            self.params = self.bundle.init(gen)
            model = dict(zip(self.comm.axis_names, self.comm.shape)).get(pcfg.model_axis, 1)
            if model > 1:
                mesh = self.comm.device_mesh
                self.params = rules.distribute(
                    self.params, rules.param_specs(self.params, rules.mesh_shape(mesh), pcfg),
                    mesh)
        # persistent steps, keyed by argument signature (shape bucket)
        self._prefill_reqs: dict[tuple, PersistentRequest] = {}
        self._decode_reqs: dict[tuple, PersistentRequest] = {}
        # the continuous-batching engine's insert signatures (one
        # trace:insert_row each), shared by the engines over this server as
        # the reference shares its compiled inserts
        self.engine_insert_sigs: set[tuple] = set()
        # per-call sampling counter: each generate() seeds a fresh generator
        self._generate_calls = 0

    # -- persistent step construction -------------------------------------------

    def _prefill_request(self, batch, extra_capacity: int | None = None) -> PersistentRequest:
        extra = self.scfg.max_new_tokens if extra_capacity is None else int(extra_capacity)
        key = (argument_signature(batch), extra)
        req = self._prefill_reqs.get(key)
        if req is None:
            tool.pvar_count("trace:prefill_step")
            # the steps capture the bundle, not the server: a server that
            # referenced itself through its requests would hold its weights
            # after ``del`` until the cyclic garbage collector ran
            bundle, pcfg = self.bundle, self.pcfg
            # ring attention shards the prompt sequence over the model axis;
            # the prefill needs the communicator to fold the cart ring onto
            comm = self.comm if pcfg.ring_attention else None

            cfg = self.cfg

            def prefill_step(p, b):
                logits, cache = bundle.prefill(p, b, pcfg, comm, extra_capacity=extra)
                mesh = _mesh_of(p)
                if mesh is not None:
                    # the decode loop's layout: donation keeps it fixed
                    specs = rules.cache_specs(cache, rules.mesh_shape(mesh), pcfg, cfg)
                    cache = rules.distribute(cache, specs, mesh)
                return logits, cache

            req = PersistentRequest(prefill_step, (self.params, batch))
            self._prefill_reqs[key] = req
        return req

    def _decode_request(self, cache, tok) -> PersistentRequest:
        key = argument_signature((cache, tok))
        req = self._decode_reqs.get(key)
        if req is None:
            tool.pvar_count("trace:decode_step")
            bundle, pcfg = self.bundle, self.pcfg
            # the sequence-sharded decode merges over the model axis
            comm = (self.comm if pcfg.seq_shard_cache and pcfg.flash_decode_merge
                    and _mesh_of(self.params) is not None else None)

            def decode_step(p, c, t):
                return bundle.decode(p, c, t, pcfg, comm)

            # the cache is updated in place and handed on: donated, as in
            # the reference, so on the card the step replays a CUDA graph
            req = PersistentRequest(decode_step, (self.params, cache, tok), donate_argnums=(1,))
            self._decode_reqs[key] = req
        return req

    @property
    def prefill_calls(self) -> int:
        """Prefill steps fired so far, over every shape bucket."""

        return sum(r.starts for r in self._prefill_reqs.values())

    # -- batching ---------------------------------------------------------------

    def _pad_batch(self, requests: list[Request]) -> tuple[dict, np.ndarray]:
        b = len(requests)
        pl = max(len(r.tokens) for r in requests)
        toks = np.zeros((b, pl), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, r in enumerate(requests):
            toks[i, pl - len(r.tokens):] = r.tokens  # left-pad: last token aligned
            lens[i] = len(r.tokens)
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        # the key set is the UNION over the batch, and every request must
        # supply every key — a ragged batch is an argument error
        extra_keys = sorted({k for r in requests for k in r.extra})
        for k in extra_keys:
            vals = []
            for i, r in enumerate(requests):
                errors.check(
                    k in r.extra,
                    errors.ErrorClass.ERR_ARG,
                    f"request {i} is missing extra {k!r} present elsewhere in "
                    f"the batch (keys: {extra_keys})",
                )
                vals.append(torch.as_tensor(r.extra[k], device=self.device))
            batch[k] = torch.stack(vals)
        return batch, lens

    # -- serving ------------------------------------------------------------------

    @property
    def placed(self) -> bool:
        """The parameters are DTensors (placed on a device mesh)."""

        return _mesh_of(self.params) is not None

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if sharding_local.is_dtensor(logits):
            logits = logits.full_tensor()   # every rank samples the same token
        logits = logits[:, -1, : self.cfg.vocab_size]
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    def _next_generator(self) -> torch.Generator:
        """Per-call sampling generator: seeded from (seed, call counter), so
        successive batches at ``temperature > 0`` draw fresh samples and a
        server rebuilt with the same seed replays the same sequence."""

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.scfg.seed * 1_000_003 + self._generate_calls)
        self._generate_calls += 1
        return gen

    def _decode_loop(self, cache, tok, gen) -> list[torch.Tensor]:
        """``max_new_tokens - 1`` re-fires of the persistent decode step;
        its graph, which reads this call's cache, is released after."""

        outs = [tok]
        decode = self._decode_request(cache, tok[:, None])
        for _ in range(self.scfg.max_new_tokens - 1):
            logits, cache = decode(self.params, cache, tok[:, None])
            tok = self._sample(logits, gen)
            outs.append(tok)
        _synchronize(self.device)
        decode.release()
        return outs

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> tuple[np.ndarray, dict]:
        """Prefill + greedy/temperature decode.  Returns (tokens
        (B, max_new), stats).  ``prefill_s`` ends once the device finished
        the prefill (the reference reads its clock at dispatch)."""

        t0 = time.perf_counter()
        batch, _lens = self._pad_batch(requests)
        gen = self._next_generator()
        logits, cache = self._prefill_request(batch)(self.params, batch)
        _synchronize(self.device)
        t_prefill = time.perf_counter() - t0

        tok = self._sample(logits, gen)
        t1 = time.perf_counter()
        outs = self._decode_loop(cache, tok, gen)
        t_decode = time.perf_counter() - t1
        tokens = torch.stack(outs, dim=1).cpu().numpy()
        gen_lens = generation_lengths(tokens, self.scfg.stop_token)
        stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "gen_lens": gen_lens.tolist(),
            "generated_tokens": int(gen_lens.sum()),
            "tokens_per_s": int(gen_lens.sum()) / max(t_decode, 1e-9),
            "batch": len(requests),
        }
        return tokens, stats


# ---------------------------------------------------------------------------
# disaggregated prefill/decode serving (the RMA transport)
# ---------------------------------------------------------------------------


def _structure(tree) -> tuple:
    """(treedef, per-leaf (shape, dtype)) of a cache: what a rank that did
    not run the prefill needs to open its window."""

    leaves, treedef = flatten(tree)
    return treedef, tuple((tuple(t.shape), t.dtype) for t in leaves)


class DisaggregatedServer:
    """Prefill and decode on *disjoint* groups of one serving process set,
    with the KV cache crossing between them through an RMA window.

    The session pset is split with the group algebra: the leading
    ``prefill_fraction`` of the set becomes ``<pset>/prefill``, the rest
    ``<pset>/decode`` (both registered on the session), or ``fanout=(P,
    D)`` takes the first ``P`` ranks for prefill and the next ``D`` for
    decode.  Three communicators are carved out of it, by every rank of
    the process world in the same order (each creates process groups):

    * ``prefill_comm`` — a ``(k, 1)`` data×model grid; its members hold
      :attr:`prefill`, a :class:`Server` that runs the persistent prefill
      request and samples the first token;
    * ``decode_comm`` — a ``(m, 1)`` grid; its members hold :attr:`decode`,
      whose persistent decode request produces every later token;
    * ``bridge`` — one axis over the union, ordered prefill-then-decode;
      carries the KV handoff, the first token and the generated tokens.

    A rank holds weights only for a group it belongs to: on a rank outside
    the prefill group :attr:`prefill` is ``None``, and likewise
    :attr:`decode`.  Each member runs its group's work on the whole batch
    (each group is a ``(n, 1)`` grid, so its server keeps whole weights),
    and every rank of the set returns the same tokens: the decode root's,
    broadcast over the bridge.  The window carries whole cache leaves; on a
    decode server whose parameters the caller placed, the handoff lands the
    cache under ``cache_specs``, as the reference's does.

    The handoff is a persistent request over the bridge (one per cache
    structure) whose body is chapter-12 RMA: every rank opens a
    zero-initialised window over the cache's datatype, prefill rank ``i``
    ``rput``\\ s the packed cache page by page into its decode partner's
    window (paired: ``(i, k+i)``; fan-out: the rounds of
    :func:`~repro_torch.core.topology.fanout_rounds`), each page's
    requests joined with ``when_all`` and chained onto the previous page's
    with ``then()``, the closing fence completes the epoch, and the decode
    root's window is broadcast over the bridge.  A decode rank that ran no
    prefill learns the cache's structure once a batch shape, broadcast from
    the prefill root.  The handoff donates nothing and runs eagerly; the
    broadcast leaves the cache in fresh buffers that the decode request
    donates (a CUDA graph on the card).  Its pvars count at the request's
    first start only, as the reference counts them at its one trace.

    With a single-device process set the groups degenerate to the same
    device (prefill == decode == the set; two servers on the same seed);
    the transport still runs, over a one-rank bridge.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        pcfg: ParallelConfig,
        scfg: ServerConfig,
        session: Session | None = None,
        *,
        pset: str = "repro://world",
        prefill_fraction: float = 0.5,
        kv_pages: int = 4,
        fanout: tuple[int, int] | None = None,
        device: str | None = None,
    ):
        sess = session if session is not None else default_session(device_type=device or "cuda")
        g = sess.group(pset)
        n = g.size()
        if fanout is not None:
            # explicit heterogeneous P:D split (2:6, 3:5, ...) — the KV
            # routing follows the dist-graph adjacency rather than the
            # paired i -> k+i bridge permutation
            pf, df = int(fanout[0]), int(fanout[1])
            errors.check(
                pf + df == n and n > 1,
                errors.ErrorClass.ERR_TOPOLOGY,
                f"fan-out {pf}:{df} needs a {pf + df}-rank process set, "
                f"pset {pset!r} has {n}",
            )
            k, prefill_g, decode_g = pf, g.incl(range(pf)), g.excl(range(pf))
        else:
            errors.check(
                0.0 < prefill_fraction < 1.0,
                errors.ErrorClass.ERR_ARG,
                f"prefill_fraction must be in (0, 1), got {prefill_fraction}",
            )
            if n > 1:
                k = min(n - 1, max(1, round(n * prefill_fraction)))
                prefill_g, decode_g = g.incl(range(k)), g.excl(range(k))
            else:
                k, prefill_g, decode_g = 1, g, g  # degenerate single-device set
        sess.register_pset(f"{pset}/prefill", prefill_g)
        sess.register_pset(f"{pset}/decode", decode_g)
        self.prefill_comm = Communicator.from_group(
            prefill_g, tag=f"{pset}/prefill",
            shape=(prefill_g.size(), 1), axis_names=("data", "model"),
        )
        self.decode_comm = Communicator.from_group(
            decode_g, tag=f"{pset}/decode",
            shape=(decode_g.size(), 1), axis_names=("data", "model"),
        )
        self.bridge = Communicator.from_group(prefill_g | decode_g, tag=f"{pset}/bridge")
        self.prefill = (Server(cfg, pcfg, scfg, self.prefill_comm)
                        if self.prefill_comm.rank() != UNDEFINED else None)
        self.decode = (Server(cfg, pcfg, scfg, self.decode_comm)
                       if self.decode_comm.rank() != UNDEFINED else None)
        # bridge ranks: prefill devices first, then decode's (group union
        # order); pair prefill i -> decode i (distinct targets: ERR_RANK
        # guards duplicates)
        if fanout is not None:
            # the routing IS the graph: every dist-graph edge becomes a
            # window rput pair, so decode rank P+j pulls from prefill j % P
            self.graph = topology.serving_fanout_graph(self.bridge, pf, df)
            self._perm = topology.fanout_routes(
                *topology.serving_fanout_adjacency(pf, df)
            )
            self._decode_root = pf
        else:
            self.graph = None
            pairs = min(prefill_g.size(), decode_g.size())
            if n > 1:
                self._perm = [(i, k + i) for i in range(pairs)]
                self._decode_root = k
            else:
                self._perm = [(0, 0)]
                self._decode_root = 0
        self.fanout = fanout
        self.kv_pages = int(kv_pages)
        self.scfg = scfg
        # a rank outside the set builds the communicators with the others
        # and serves nothing
        self.device = self.bridge.device if self.bridge.rank() != UNDEFINED else None
        self._transfer_reqs: dict[tuple, PersistentRequest] = {}
        self._structures: dict[tuple, tuple] = {}

    # -- the RMA transport --------------------------------------------------

    def _transfer_request(self, staged_cache) -> PersistentRequest:
        key = argument_signature(staged_cache)
        req = self._transfer_reqs.get(key)
        if req is None:
            tool.pvar_count("trace:kv_transfer")
            bridge, pages, root = self.bridge, self.kv_pages, self._decode_root
            # a heterogeneous fan-out gives one prefill origin several decode
            # targets; an rput carries at most one target per origin, so
            # each page goes out as one rput per round (targets are disjoint
            # across rounds — decode ranks have exactly one source)
            rounds = topology.fanout_rounds(self._perm)
            started = [False]

            def move(cache):
                # the reference counts the body's pvars at its one trace
                with tool.pvars_paused(started[0]):
                    started[0] = True
                    leaves, treedef = flatten(cache)
                    win = onesided.Window(
                        bridge, unflatten(treedef, [torch.zeros_like(t) for t in leaves]))
                    win.fence()

                    def page_puts(p):
                        return futures.when_all(
                            [win.rput(cache, rnd, page=(p, pages)) for rnd in rounds])

                    fut = page_puts(0)
                    for p in range(1, pages):
                        # the continuation completes the previous page's
                        # transfer, then issues the next page's rputs
                        fut = fut.then(lambda f, _p=p: (f.get(), page_puts(_p))[1])
                    futures.when_all([fut]).get()   # MPI_Waitall before the close
                    win.fence()                     # epoch close completes the epoch
                    # the decode root's window, on every rank: the buffers
                    # started as zeros, so a value here proves the window
                    # carried it
                    return collectives.broadcast(bridge, win.buffer, root=root)

            req = self.bridge.persistent(move, staged_cache)
            self._transfer_reqs[key] = req
        return req

    def _cache_structure(self, batch_key: tuple, cache) -> tuple:
        """The prefill cache's structure for this batch shape: local on a
        prefill rank, broadcast from the prefill root (bridge rank 0) to the
        other ranks the first time the shape is served."""

        struct = self._structures.get(batch_key)
        if struct is None:
            struct = _structure(cache) if cache is not None else None
            pg = self.bridge.process_group()
            if self.bridge.size() > 1 and pg is not None:
                box = [struct]
                dist.broadcast_object_list(box, src=self.bridge.global_ranks()[0], group=pg)
                struct = box[0]
            self._structures[batch_key] = struct
        return struct

    def _transfer(self, cache, batch_key: tuple) -> tuple[Any, dict]:
        """Move the prefill-side cache into the decode group via the window;
        returns (decode-side cache, transfer stats).  A rank that ran no
        prefill passes zeros of the cache's structure."""

        t0 = time.perf_counter()
        treedef, leaves = self._cache_structure(batch_key, cache)
        if cache is None:
            cache = unflatten(treedef, [torch.zeros(shape, dtype=dtype, device=self.device)
                                        for shape, dtype in leaves])
        out = self._transfer_request(cache).start(cache).get()
        if self.decode is not None and self.decode.placed:
            # land on the decode mesh under the serving cache rules, as
            # the reference does: the decode loop's layout
            srv = self.decode
            mesh = srv.comm.device_mesh
            with torch.no_grad():
                out = rules.distribute(
                    out, rules.cache_specs(out, rules.mesh_shape(mesh), srv.pcfg, srv.cfg), mesh)
        _synchronize(self.device)
        kv_bytes = int(sum(np.prod(shape, dtype=np.int64) * dtype.itemsize
                           for shape, dtype in leaves))
        return out, {
            "transfer_s": time.perf_counter() - t0,
            "kv_bytes": kv_bytes,
            "kv_pages": self.kv_pages,
        }

    # -- serving ------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> tuple[np.ndarray, dict]:
        """Disaggregated prefill + decode; token-for-token equal to
        :meth:`Server.generate` at ``temperature=0``.  Every rank of the
        set calls it with the same requests and returns the same tokens."""

        self.bridge._member_rank()   # ERR_COMM outside the serving set
        t0 = time.perf_counter()
        b, new = len(requests), self.scfg.max_new_tokens
        # every rank pads the batch: its shape keys the handoff
        batch, _lens = (self.prefill or self.decode)._pad_batch(requests)
        batch_key = argument_signature(batch)
        cache = tok = gen = None
        if self.prefill is not None:
            gen = self.prefill._next_generator()
            logits, cache = self.prefill._prefill_request(batch)(self.prefill.params, batch)
            cache = _whole(cache)   # the window carries whole leaves
            tok = self.prefill._sample(logits, gen)
            del logits
            _synchronize(self.device)
        t_prefill = time.perf_counter() - t0

        # the first token: the prefill root's, on every rank (a collective
        # over the whole bridge before its first point-to-point transfer,
        # which NCCL asks of a communicator's first call)
        if tok is None:
            tok = torch.zeros((b,), dtype=torch.int32, device=self.device)
        tok = collectives.broadcast(self.bridge, tok, root=0)
        # a decode rank waits here for the prefill group, so that its
        # transfer_s times the handoff alone
        _synchronize(self.device)
        cache, transfer_stats = self._transfer(cache, batch_key)

        t1 = time.perf_counter()
        if self.decode is not None:
            if gen is None:
                gen = self.decode._next_generator()
            tokens = torch.stack(self.decode._decode_loop(cache, tok, gen), dim=1)
        else:
            tokens = torch.zeros((b, new), dtype=torch.int32, device=self.device)
        del cache
        tokens = collectives.broadcast(self.bridge, tokens, root=self._decode_root)
        tokens = tokens.cpu().numpy()
        t_decode = time.perf_counter() - t1
        gen_lens = generation_lengths(tokens, self.scfg.stop_token)
        stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "gen_lens": gen_lens.tolist(),
            "generated_tokens": int(gen_lens.sum()),
            "tokens_per_s": int(gen_lens.sum()) / max(t_decode, 1e-9),
            "batch": len(requests),
            "prefill_devices": self.prefill_comm.size(),
            "decode_devices": self.decode_comm.size(),
            **transfer_stats,
        }
        return tokens, stats
