#!/usr/bin/env python3
"""What the int8 KV cache costs a decode step on one card, and why.

    python3 tools/int8_decode_costs.py

Needs one CUDA device and ``nvcc``; run on demand, apart from
``chip_smoke.py``, whose pass or fail reads neither result.  It builds the
kernels from this checkout, then:

1. host cost per call: the wall time per call of each quant wrapper at a
   decode step's shape (gemma2-9b's new k, b 2 x 8 KV heads = 16 rows of
   256), 2,000 calls back to back and one synchronise, beside
   ``torch.add`` on the same tensor as the yardstick of one PyTorch launch;
2. decode in turns: for the full gemma2-9b (42 layers, 2 x 4608-token
   prompts) and zamba2-7b (81 layers, 2 x 4096), random weights from the
   launcher's seed, one prefill with a bf16 cache and one with an int8
   cache, then eight decode steps a turn in turns bf16, int8, int8, bf16,
   synchronised at each turn's ends: the wall time a step, host included,
   of both caches on the same weights at one moment.

Prints each result and writes them all to
``artifacts/int8_decode_costs.json``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the device, build and prompt helpers)

MODELS = (("gemma2_9b", 4608), ("zamba2_7b", 4096))


def host_us_per_call(calls: int = 2000) -> dict:
    import torch

    from repro_torch.kernels.quant import kernel as qk

    x = torch.randn((16, 256), device="cuda").to(torch.bfloat16)
    q, s = qk.quantize_int8_rows(x)
    out = {}
    for name, fn in (("quantize", lambda: qk.quantize_int8_rows(x)),
                     ("dequantize", lambda: qk.dequantize_int8_rows(q, s, torch.bfloat16)),
                     ("torch_add", lambda: torch.add(x, x))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    chip_smoke.log("host us per call at (16, 256): " + json.dumps(out))
    return out


def decode_in_turns(arch: str, prompt_len: int, steps: int = 8) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = base.get_config(arch)
    server = Server(cfg, base.get_parallel(arch),
                    ServerConfig(max_batch=2, max_new_tokens=chip_smoke.NEW_TOKENS))
    reqs = serve.requests(cfg, 2, prompt_len)
    batch = {"tokens": torch.as_tensor(np.stack([r.tokens for r in reqs]), device="cuda")}
    times: dict = {"bfloat16": [], "int8": []}
    with torch.inference_mode():
        caches = {}
        for kv in times:
            pcfg = dataclasses.replace(server.pcfg, kv_cache_dtype=kv)
            logits, cache = server.bundle.prefill(server.params, batch, pcfg,
                                                  extra_capacity=chip_smoke.NEW_TOKENS)
            caches[kv] = (pcfg, cache)
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
        for kv in ("bfloat16", "int8", "int8", "bfloat16"):
            pcfg, cache = caches[kv]
            server.bundle.decode(server.params, cache, tok, pcfg)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                server.bundle.decode(server.params, cache, tok, pcfg)
            torch.cuda.synchronize()
            times[kv].append((time.perf_counter() - t0) / steps * 1e3)
    chip_smoke.log(f"{arch} decode step ms in turns (bf16, int8, int8, bf16): "
                   + json.dumps(times))
    del server, caches, cache, logits
    torch.cuda.empty_cache()
    return times


def main() -> int:
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    results = {"device": chip_smoke.RESULTS["device"], "host_us_per_call": host_us_per_call(),
               "decode_step_ms_in_turns": {arch: decode_in_turns(arch, n) for arch, n in MODELS}}
    out = ROOT / "artifacts"
    out.mkdir(exist_ok=True)
    (out / "int8_decode_costs.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
