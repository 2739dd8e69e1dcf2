#!/usr/bin/env python3
"""The bf16 SSD scan kernel's time against how many chains of tiles run at
once, on one card.

    python3 tools/ssd_chains.py

Needs one CUDA device and ``nvcc``; run on demand, apart from
``chip_smoke.py``, whose pass or fail reads no result here.  A block of the
kernel's bf16 body walks the 64-row tiles of one (p tile of 16 state rows,
head, batch) in order, carrying the state: a chain, whose steps cannot
overlap one another.  What the kernel can do is set by how long one step
takes and how many chains the card holds at once.  This builds the kernels
from this checkout and times (median of 10 CUDA-event timings after a warm
call; x, B and C views of one random bf16 tensor and dt, A as
``chip_smoke.py`` draws them):

- mamba2-2.7b's and zamba2-7b's prefill calls (b 2, l 4096, h 80 and 112,
  p 64, n 128 and 64): 640 and 896 chains;
- calls of one batch, l 4096 and p 16, so one chain a head: one chain
  alone, then 1 to 5 chains per SM, at n 128 and at n 64.  Each row holds
  the microseconds a step takes, the call's time over its 64 steps.

Each row also holds the launch shape (blocks resident per SM).  Prints each
row and writes them, with the card's name and power limit, to
``artifacts/ssd_chains.json``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the device, build and timing helpers)

L = 4096


def _inputs(gen, b, h, p, n):
    import torch
    import torch.nn.functional as F

    di = h * p
    xbc = torch.randn((b, L, di + 2 * n), generator=gen, device="cuda").to(torch.bfloat16)
    x = xbc[..., :di].unflatten(-1, (h, p))
    B = xbc[..., di:di + n].unflatten(-1, (1, n))
    C = xbc[..., di + n:].unflatten(-1, (1, n))
    dt = 0.1 * F.softplus(torch.randn((b, L, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    return x, dt, A, B, C


def _row(name, gen, b, h, p, n):
    import torch

    from repro_torch.kernels.ssd_scan import kernel as sk

    args = _inputs(gen, b, h, p, n)
    ms = chip_smoke.time_ms(lambda: sk.ssd_scan_fwd(*args, chunk=128, return_state=True), 10)
    shape = sk.launch_shape(torch.bfloat16, n)
    chains = b * h * -(-p // shape["p_tile"])
    row = {"case": name, "b": b, "h": h, "p": p, "n": n, "chains": chains, "ms": ms,
           "us_per_step": ms * 1e3 / (L // 64), **shape}
    chip_smoke.log_row(row)
    return row


def main() -> int:
    import torch

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(80)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [_row("mamba2 prefill", gen, 2, 80, 64, 128),
            _row("zamba2 prefill", gen, 2, 112, 64, 64)]
    for n in (128, 64):
        rows.append(_row(f"one chain, n {n}", gen, 1, 1, 16, n))
        for per_sm in range(1, 6):
            rows.append(_row(f"{per_sm} chains per SM, n {n}", gen, 1, per_sm * sms, 16, n))
    out = ROOT / "artifacts"
    out.mkdir(exist_ok=True)
    (out / "ssd_chains.json").write_text(json.dumps(
        {"device": chip_smoke.RESULTS["device"], "sms": sms, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
