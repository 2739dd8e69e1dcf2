#!/usr/bin/env python3
"""The bf16 attention kernels' times across shapes, on one card.

    python3 tools/attention_shapes.py

Needs one CUDA device and ``nvcc``; run on demand, apart from
``chip_smoke.py``, whose pass or fail reads no result here.  It builds the
kernels from this checkout and times (median of 10 CUDA-event timings after
a warm call, causal unless a row says otherwise, random bf16 inputs):

- the flash kernel and the ring step (a ring of one from the initial carry)
  at the same shapes, phi4-mini's (b 2, S 8192, h 24, hk 8, d 128) and
  zamba2's (b 2, S 4096, h = hk = 32, d 112): the two share one tile body,
  so a gap between them is the callers' code, not the body's;
- the flash kernel at zamba2's shape with K and V stored head-major (the
  ring's layout) and at d 128, at S 4096 with phi4-mini's GQA, at S 8192
  with 32 heads, and without the causal mask;
- gemma2's global layer (b 2, S 4608, h 16, hk 8, d 256) with and without
  the softcap of 50, which costs a tanh per logit.

Each row holds its TFLOP/s at 4·d FLOPs per admitted pair.  Prints each
row and writes them, with the card's name and power limit, to
``artifacts/attention_shapes.json``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the device, build and timing helpers)


def _rnd(gen, *shape):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _flops(b, s, h, d, causal):
    return 4 * d * b * h * (s * (s + 1) // 2 if causal else s * s)


def _flash(gen, b, s, h, hk, d, head_major_kv=False, causal=True, **kw):
    from repro_torch.kernels.flash_attention import kernel as fk

    q, k, v = _rnd(gen, b, s, h, d), _rnd(gen, b, s, hk, d), _rnd(gen, b, s, hk, d)
    if head_major_kv:
        k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
    ms = chip_smoke.time_ms(lambda: fk.flash_attention_fwd(q, k, v, causal=causal, **kw), 10)
    return ms, _flops(b, s, h, d, causal)


def _ring(gen, b, s, h, hk, d):
    import torch

    from repro_torch.kernels.ring_attention import kernel as rk

    q = _rnd(gen, b, s, h, d).transpose(1, 2)
    kv = _rnd(gen, 2, b, hk, s, d)
    info = torch.tensor([0, 0, s], dtype=torch.int32, device="cuda")
    carry = chip_smoke._fresh_carry(b, h, s, d)
    ms = chip_smoke.time_ms(
        lambda: rk.ring_step_fwd(q, kv[0], kv[1], *carry, info=info, causal=True), 10)
    return ms, _flops(b, s, h, d, True)


def main() -> int:
    import torch

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(70)
    phi4 = dict(b=2, s=8192, h=24, hk=8, d=128)
    zamba2 = dict(b=2, s=4096, h=32, hk=32, d=112)
    gemma2 = dict(b=2, s=4608, h=16, hk=8, d=256)
    cases = {
        "flash phi4-mini": lambda: _flash(gen, **phi4),
        "ring phi4-mini": lambda: _ring(gen, **phi4),
        "flash zamba2": lambda: _flash(gen, **zamba2),
        "ring zamba2": lambda: _ring(gen, **zamba2),
        "flash zamba2, K/V head-major": lambda: _flash(gen, head_major_kv=True, **zamba2),
        "flash zamba2 at d 128": lambda: _flash(gen, **{**zamba2, "d": 128}),
        "flash S 4096, h 24/8, d 128": lambda: _flash(gen, **{**phi4, "s": 4096}),
        "flash S 8192, h 32/32, d 128": lambda: _flash(gen, **{**zamba2, "s": 8192, "d": 128}),
        "flash zamba2 at d 128, not causal": lambda: _flash(gen, causal=False,
                                                            **{**zamba2, "d": 128}),
        "flash gemma2 global, softcap 50": lambda: _flash(gen, logit_softcap=50.0, **gemma2),
        "flash gemma2 global, no softcap": lambda: _flash(gen, **gemma2),
    }
    rows = []
    for name, fn in cases.items():
        ms, flops = fn()
        rows.append({"case": name, "ms": ms, "tflops": flops / ms / 1e9})
        chip_smoke.log_row(rows[-1])
    out = ROOT / "artifacts"
    out.mkdir(exist_ok=True)
    (out / "attention_shapes.json").write_text(json.dumps(
        {"device": chip_smoke.RESULTS["device"], "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
