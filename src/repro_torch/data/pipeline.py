"""Deterministic, shard-aware synthetic token pipeline — :mod:`repro.data.
pipeline` in PyTorch.

Every batch is a pure function of ``(seed, step)``, built on the host with
numpy: :meth:`TokenPipeline.host_batch` is the reference's, copied, and
``tests/port/test_torch_data.py`` pins the two equal.  The synthetic stream
is an order-1 Markov chain over the vocab with a fixed transition
structure, so training-loss curves are meaningful.

:meth:`TokenPipeline.device_batch` places the batch on the trainer's device
as tensors: a data-parallel rank takes its block of the batch dimension when
the ranks divide it, else the whole batch (the reference's
``make_batch_specs`` rule, which has no counterpart here: ROADMAP A16).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic synthetic LM data.

    Every batch is ``f(seed, step)``: host-built with numpy (cheap, no RNG
    state carried), then copied to the device.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    modality: str = "lm"          # lm | audio | vlm
    frame_dim: int = 0            # encdec frontend stub dim
    frame_len: int = 0
    image_tokens: int = 0
    image_dim: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        """The global batch for ``step`` (host numpy)."""

        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # order-1 Markov stream: token_{t+1} = (a * token_t + noise) % v
        start = rng.integers(0, v, size=(b, 1))
        steps_noise = rng.integers(0, 7, size=(b, s - 1))
        toks = [start]
        for t in range(s - 1):
            toks.append((toks[-1] * 31 + 17 + steps_noise[:, t : t + 1]) % v)
        tokens = np.concatenate(toks, axis=1).astype(np.int32)
        batch: dict[str, np.ndarray] = {"tokens": tokens}
        if self.modality == "audio":
            batch["frames"] = rng.standard_normal(
                (b, self.frame_len, self.frame_dim), dtype=np.float32
            ).astype(np.float32)
        if self.modality == "vlm":
            batch["image_embeds"] = rng.standard_normal(
                (b, self.image_tokens, self.image_dim), dtype=np.float32
            ).astype(np.float32)
        return batch

    def device_batch(self, step: int, device, rank: int = 0, size: int = 1
                     ) -> dict[str, torch.Tensor]:
        """The batch for ``step`` on ``device``: rank ``rank`` of ``size``
        data-parallel ranks takes its block of the batch dimension when
        ``size`` divides it, else the whole batch.  Fields other than the
        tokens are bf16, as in the reference."""

        out = {}
        for k, v in self.host_batch(step).items():
            if v.shape[0] % size == 0:
                n = v.shape[0] // size
                v = v[rank * n:(rank + 1) * n]
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k != "tokens":
                t = t.to(torch.bfloat16)
            out[k] = t.to(device)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.host_batch(step)
            step += 1
