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

**Ring attention**: with ``pcfg.ring_attention`` the prefill gets the
communicator, as the reference's gets its mesh, and shards each eligible
layer's sequence over the ring (``models/attention.py``).  Every rank builds
the same weights from the same seed and runs ``generate`` on the same
requests; decode runs replicated, with no communicator, and every rank
returns the same tokens.

The continuous-batching engine (:mod:`repro_torch.runtime.engine`) runs
over a server's persistent prefill and decode requests.  The disaggregated
server is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import errors, tool
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import PersistentRequest, argument_signature
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.models import api as model_api

tool.pvar_register("trace:prefill_step", "prefill requests built (want 1 per shape bucket)")
tool.pvar_register("trace:decode_step", "decode requests built (want 1 per shape bucket)")


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

            def prefill_step(p, b):
                return bundle.prefill(p, b, pcfg, comm, extra_capacity=extra)

            req = PersistentRequest(prefill_step, (self.params, batch))
            self._prefill_reqs[key] = req
        return req

    def _decode_request(self, cache, tok) -> PersistentRequest:
        key = argument_signature((cache, tok))
        req = self._decode_reqs.get(key)
        if req is None:
            tool.pvar_count("trace:decode_step")
            bundle, pcfg = self.bundle, self.pcfg

            def decode_step(p, c, t):
                return bundle.decode(p, c, t, pcfg, None)

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

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
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
