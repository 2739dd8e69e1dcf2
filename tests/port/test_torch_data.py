"""The port's token pipeline against the reference: ``host_batch`` is the
reference's numpy code, copied, and gives the same batch bit for bit for
the same ``(seed, step)``; ``device_batch`` hands each data-parallel rank
its block of it as tensors."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JPipeline
from repro_torch.data import TokenPipeline as TPipeline

torch.set_num_threads(1)

_KW = {
    "lm": dict(vocab_size=1000, seq_len=33, global_batch=4),
    "audio": dict(vocab_size=500, seq_len=16, global_batch=2, modality="audio",
                  frame_dim=8, frame_len=6),
    "vlm": dict(vocab_size=300, seq_len=12, global_batch=3, modality="vlm",
                image_tokens=5, image_dim=7),
}


@pytest.mark.parametrize("modality", sorted(_KW))
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 0), (12345, 99)])
def test_host_batch_bit_identical(modality, seed, step):
    j = JPipeline(seed=seed, **_KW[modality]).host_batch(step)
    t = TPipeline(seed=seed, **_KW[modality]).host_batch(step)
    assert sorted(j) == sorted(t)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
        assert t[k].tobytes() == j[k].tobytes(), k


def test_iteration_is_host_batch_by_step():
    pipe = TPipeline(seed=5, **_KW["lm"])
    for step, batch in zip(range(3), pipe):
        np.testing.assert_array_equal(batch["tokens"], pipe.host_batch(step)["tokens"])


@pytest.mark.parametrize("size", [1, 2, 4])
def test_device_batch_blocks_of_the_global_batch(size):
    """Each rank's block, in rank order, is the global batch; a batch the
    ranks do not divide goes whole to every rank; non-token fields are
    bf16."""

    pipe = TPipeline(seed=1, **_KW["lm"])
    host = pipe.host_batch(3)["tokens"]
    blocks = [pipe.device_batch(3, "cpu", r, size)["tokens"] for r in range(size)]
    assert all(b.dtype == torch.int32 and b.device.type == "cpu" for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), host)
    vlm = TPipeline(seed=1, **_KW["vlm"])
    whole = vlm.device_batch(0, "cpu", 1, 2)
    np.testing.assert_array_equal(whole["tokens"].numpy(), vlm.host_batch(0)["tokens"])
    assert whole["image_embeds"].dtype == torch.bfloat16
