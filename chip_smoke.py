#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero, printing no result, on
any failure.  In order:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles every kernel of the serving path from the sources in
   this checkout;
3. kernels against their plain versions on the card, at gemma2-9b width
   (b 2, h 16, hk 8, d 256, softcap 50, bf16; one fp32 case): max abs
   error, the kernel's median time, the plain version's, the bound, and
   ``library_ms`` — ``F.scaled_dot_product_attention`` at the same shapes
   without the softcap and window, a yardstick the port never calls;
4. serve: ``repro_torch.launch.serve`` on the full gemma2-9b config
   (42 layers, random weights from a seed), 2 requests of 4608 tokens (over
   the 4096 window, so the window mask and ring-buffer cache run on the
   card), 16 new tokens.  Launch counts are zeroed just before and read just
   after; every kernel of the path must have launched, the flash kernel 42
   times per prefill.  A second, warm ``generate`` must repeat the tokens;
5. a small input: the gemma2 smoke model in fp32 generates the same tokens
   on the card as on the CPU path (held against the JAX reference by the
   CPU tests);
6. the ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Also writes everything it prints as JSON to ``artifacts/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): the bound's rates
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BF16_TOL, FP32_TOL = 2e-2, 1e-4
SERVE_ARGV = ["--arch", "gemma2_9b", "--requests", "2", "--prompt-len", "4608",
              "--new-tokens", "16"]

RESULTS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm call."""

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    RESULTS["device"] = {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}
    # fp32 products in full fp32: the fp32 tolerance assumes no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels.flash_attention import kernel as fk

    t0 = time.perf_counter()
    fk.build()
    RESULTS["build_s"] = time.perf_counter() - t0
    usage = [l.split("info    : ")[-1] for l in fk.BUILD_LOG.splitlines()
             if "registers" in l or "spill" in l]
    log(f"built flash_attention_fwd in {RESULTS['build_s']:.1f}s; ptxas: " + " | ".join(usage))


def _attention_case(name, seed, *, b, s, h, hk, d, dtype, reps, **kw):
    """Kernel vs plain on one shape: error, times and bound."""

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(dt)
    out = fk.flash_attention_fwd(q, k, v, **kw)
    plain = ref.mha(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
    check(math.isfinite(err) and err <= tol, f"{name}: max abs err {err} > {tol}")
    row = {"case": name, "shape": [b, s, h, hk, d], "dtype": dtype, "max_abs_err": err,
           "tol": tol, **{k_: v_ for k_, v_ in kw.items() if k_ != "scale"}}
    if reps:
        mask = ref.attention_mask(
            s, s, causal=kw.get("causal", True), sliding_window=kw.get("sliding_window"),
            prefix_len=kw.get("prefix_len"), device="cuda")
        pairs = int(mask.sum().item()) * b * h
        flops = 4 * d * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row.update(
            ms=time_ms(lambda: fk.flash_attention_fwd(q, k, v, **kw), reps),
            plain_ms=time_ms(lambda: ref.mha(q, k, v, **kw), max(2, reps // 4)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=kw.get("scale"), enable_gqa=True), reps),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
        )
    log(json.dumps({k_: (round(v_, 6) if isinstance(v_, float) else v_)
                    for k_, v_ in row.items()}))
    del q, k, v, out, plain
    torch.cuda.empty_cache()
    return row


def phase_kernels():
    gemma = dict(b=2, h=16, hk=8, d=256, causal=True, logit_softcap=50.0, scale=256.0 ** -0.5)
    rows = [
        _attention_case("global_4608", 0, s=4608, dtype="bfloat16", reps=10, **gemma),
        _attention_case("local_4608_w4096", 1, s=4608, dtype="bfloat16", reps=10,
                        sliding_window=4096, **gemma),
        _attention_case("ragged_4601_w4096", 2, s=4601, dtype="bfloat16", reps=0,
                        sliding_window=4096, **gemma),
        _attention_case("prefix300_1000", 3, s=1000, dtype="bfloat16", reps=0, prefix_len=300,
                        sliding_window=512, **gemma),
        _attention_case("fp32_1000", 4, s=1000, dtype="float32", reps=0, **gemma),
    ]
    RESULTS["kernel_cases"] = rows


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import serve
    from repro_torch.runtime.server import Request

    fk.reset_launches()
    t0 = time.perf_counter()
    server, tokens, stats = serve.run(SERVE_ARGV)
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fk.LAUNCHES}
    cfg = server.cfg
    prefills = server.prefill_calls
    log(f"served {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params; wall {wall:.1f}s (init included)")
    log("cold stats " + json.dumps(stats))
    check(cfg.num_layers == 42 and cfg.d_model == 3584, "not the full gemma2-9b config")
    check(prefills >= 1 and launches["flash_attention_fwd"] == cfg.num_layers * prefills,
          f"flash launches {launches['flash_attention_fwd']} != "
          f"{cfg.num_layers} x {prefills} prefill calls")
    check(tokens.shape == (2, 16), f"tokens shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token outside the vocab")

    rng = np.random.default_rng(0)  # the launcher's prompts, drawn again
    reqs = [Request(tokens=rng.integers(1, cfg.vocab_size, size=(4608,), dtype=np.int32))
            for _ in range(2)]
    warm_tokens, warm = server.generate(reqs)
    log("warm stats " + json.dumps(warm))
    check(np.array_equal(warm_tokens, tokens), "warm generate changed the greedy tokens")
    batch = {"tokens": torch.as_tensor(np.stack([r.tokens for r in reqs]), device="cuda")}
    with torch.inference_mode():
        logits, cache = server.bundle.prefill(server.params, batch, server.pcfg,
                                              extra_capacity=16)
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
        profiles = {
            "prefill": _profile(lambda: server.bundle.prefill(
                server.params, batch, server.pcfg, extra_capacity=16)),
            "decode_x4": _profile(lambda: [server.bundle.decode(
                server.params, cache, tok, server.pcfg) for _ in range(4)]),
        }
    RESULTS["serve"] = {"argv": SERVE_ARGV, "cold": stats, "warm": warm,
                        "prefill_calls": prefills, "launches": launches,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "profiles": profiles}
    del server, logits, cache
    torch.cuda.empty_cache()
    return launches


def _profile(fn, top: int = 6) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler,
    device-side events only), and the device's busy share of the call's
    wall time, timed once more without the profiler."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        {"kernel": evt.key[:90], "ms": evt.self_device_time_total / 1e3, "count": evt.count}
        for evt in prof.key_averages()
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["ms"])
    busy_ms = sum(r["ms"] for r in rows)
    result = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "busy_share": busy_ms / wall_ms if busy_ms else None, "top": rows[:top]}
    log("profile " + json.dumps(result))
    return result


def phase_small_model():
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.runtime.server import Request, Server, ServerConfig

    cfg = dataclasses.replace(base.get_smoke_config("gemma2_9b"), dtype="float32")
    pcfg = base.get_parallel("gemma2_9b")
    scfg = ServerConfig(max_batch=2, max_new_tokens=8)
    gpu = Server(cfg, pcfg, scfg, device="cuda")
    cpu = Server(cfg, pcfg, scfg, device="cpu")
    cpu.params = _to_cpu(gpu.params)
    rng = np.random.default_rng(1)
    reqs = [Request(tokens=rng.integers(1, cfg.vocab_size, size=(24,), dtype=np.int32))
            for _ in range(2)]
    t_gpu, _ = gpu.generate(reqs)
    t_cpu, _ = cpu.generate(reqs)
    log(f"smoke model fp32, card vs CPU path: tokens {t_gpu.tolist()} vs {t_cpu.tolist()}")
    check(np.array_equal(t_gpu, t_cpu), "card and CPU path generate different tokens")
    RESULTS["small_model"] = {"tokens_equal": True, "tokens": t_gpu.tolist()}
    del gpu
    torch.cuda.empty_cache()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def main() -> int:
    import torch

    import repro_torch.kernels.flash_attention.kernel  # noqa: F401  (the port is here)

    phase_device()
    phase_build()
    phase_kernels()
    launches = phase_serve()
    phase_small_model()

    main_case = RESULTS["kernel_cases"][0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:37",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in RESULTS["kernel_cases"]),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    RESULTS["kernels"] = kernels
    out = ROOT / "artifacts"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
