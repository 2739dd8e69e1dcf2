#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero, printing no result, on
any failure.  In order:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles every kernel of the serving paths from the sources in
   this checkout, one ``nvcc`` per source, all started together, and
   prints each one's ptxas usage;
3. flash attention against its plain version on the card, at gemma2-9b
   width (b 2, h 16, hk 8, d 256, softcap 50, bf16; one fp32 case) and at
   zamba2-7b's (b 2, s 4096, h = hk = 32, d 112, bf16; one fp32 case):
   error, the kernel's median time, the plain version's, the bound, and
   ``library_ms`` — ``F.scaled_dot_product_attention`` at the same shapes
   without the softcap and window, a yardstick the port never calls;
4. the SSD scan against ``ref.ssd_chunked`` on the card, y and the final
   state, at mamba2-2.7b width (b 2, l 4096, h 80, p 64, n 128, bf16, and
   the same in fp32) and zamba2-7b's (h 112, n 64), grouped, a 48-token
   chunk, and fp32 with a 64-token chunk; x, B and C are views of one
   tensor, as the model passes them.  The two bf16 full-width cases are
   timed.  No single PyTorch call computes the scan, so its ``library_ms``
   is null.  Every output element of both kernels is held within the
   limits stated at ``BF16_RTOL``;
5. serve: ``repro_torch.launch.serve`` on the full gemma2-9b config (42
   layers, 2 requests of 4608 tokens, over the 4096 window), the full
   mamba2-2.7b (64 layers, 2 x 4096) and the full zamba2-7b (81 layers,
   2 x 4096), random weights from a seed, 16 new tokens each.  Launch
   counts are zeroed just before each serve and read just after; every
   kernel of the path must have launched its expected number of times per
   prefill.  A second, warm ``generate`` must repeat the tokens; one
   prefill and four decode steps are profiled;
6. small inputs: the gemma2, mamba2 and zamba2 smoke models in fp32
   generate the same tokens on the card as on the CPU path (held against
   the JAX reference by the CPU tests);
7. the ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

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
# Each element is held as |kernel - plain| <= atol + rtol * |plain|, where
# plain is the plain version in fp32 on the same values (it upcasts its
# inputs in any case).  Both compute in fp32; a bf16 output is the kernel's
# value rounded once, within half a bf16 ulp of it (2^-8 relative), so its
# rtol adds 2^-8 to the fp32 limits.
BF16_RTOL = 2.0 ** -8
FLASH_FP32_TOL = 1e-4  # flash: atol, rtol 0
SSD_FP32_TOL = 5e-5    # SSD: atol and rtol, as tests/test_kernels.py
NEW_TOKENS = 16
# arch, layers, d_model, prompt length, kernel launches per prefill
SERVES = [
    ("gemma2_9b", 42, 3584, 4608, {"flash_attention_fwd": 42, "ssd_scan_fwd": 0}),
    ("mamba2_2_7b", 64, 2560, 4096, {"flash_attention_fwd": 0, "ssd_scan_fwd": 64}),
    ("zamba2_7b", 81, 3584, 4096, {"flash_attention_fwd": 13, "ssd_scan_fwd": 81}),
]

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


def _kernel_modules() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk

    return {"flash_attention_fwd": fk, "ssd_scan_fwd": sk}


def phase_build():
    from repro_torch.kernels import nvcc

    mods = _kernel_modules()
    t0 = time.perf_counter()
    nvcc.build_all(m.LIBRARY for m in mods.values())
    RESULTS["build_s"] = time.perf_counter() - t0
    log(f"built {', '.join(mods)} in {RESULTS['build_s']:.1f}s")
    for name, m in mods.items():
        usage = [l.split("info    : ")[-1] for l in m.LIBRARY.log.splitlines()
                 if "registers" in l or "spill" in l]
        log(f"{name} ptxas: " + " | ".join(usage))


def _held(name, out, plain, atol, rtol) -> dict:
    """Hold ``out`` elementwise within ``atol + rtol * |plain|`` of the fp32
    ``plain``; the worst element's share of its limit, and mean |plain|, are
    logged so the limit can be read against the values."""

    diff = (out.float() - plain).abs()
    ratio = (diff / (atol + rtol * plain.abs())).max().item()
    err = diff.max().item()
    check(math.isfinite(err) and ratio <= 1.0,
          f"{name}: max abs err {err}, worst element at {ratio} of atol {atol} + rtol {rtol}")
    return {"max_abs_err": err, "atol": atol, "rtol": rtol, "worst_err_over_limit": ratio,
            "mean_abs_plain": plain.abs().mean().item()}


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
    plain = ref.mha(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    held = _held(f"flash {name}", out, plain, FLASH_FP32_TOL,
                 BF16_RTOL if dtype == "bfloat16" else 0.0)
    row = {"case": name, "shape": [b, s, h, hk, d], "dtype": dtype, **held,
           **{k_: v_ for k_, v_ in kw.items() if k_ != "scale"}}
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
        _attention_case("zamba2_4096_d112", 5, b=2, s=4096, h=32, hk=32, d=112,
                        dtype="bfloat16", reps=10, causal=True),
        _attention_case("zamba2_fp32_1000_d112", 6, b=1, s=1000, h=32, hk=32, d=112,
                        dtype="float32", reps=0, causal=True),
    ]
    RESULTS["kernel_cases"] = rows


def _ssd_case(name, seed, *, b, l, h, p, n, g, dtype, chunk=128, reps=0):
    """SSD kernel vs ``ref.ssd_chunked`` on one shape, y and the final
    state: errors and, with ``reps``, times and bound."""

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)
    di, gn = h * p, g * n
    # x, B and C as views of one conv output, as mamba2_full hands them over
    xbc = torch.randn((b, l, di + 2 * gn), generator=gen, device="cuda").to(dt_)
    x = xbc[..., :di].unflatten(-1, (h, p))
    B = xbc[..., di:di + gn].unflatten(-1, (g, n))
    C = xbc[..., di + gn:].unflatten(-1, (g, n))
    dts = 0.1 * F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    y, state = sk.ssd_scan_fwd(x, dts, A, B, C, chunk=chunk, return_state=True)
    py, pstate = ref.ssd_chunked(x.float(), dts, A, B.float(), C.float(), chunk=chunk)
    torch.cuda.synchronize()
    row = {"case": name, "shape": [b, l, h, p, n, g], "chunk": chunk, "dtype": dtype}
    # the fp32 state is held at the fp32 limits in every case
    y_rtol = SSD_FP32_TOL + (BF16_RTOL if dtype == "bfloat16" else 0.0)
    for part, out, plain, rtol in (("y", y, py, y_rtol), ("state", state, pstate, SSD_FP32_TOL)):
        held = _held(f"ssd {name} {part}", out, plain, SSD_FP32_TOL, rtol)
        row.update({f"{k_}_{part}": v_ for k_, v_ in held.items()})
    row["max_abs_err"] = max(row["max_abs_err_y"], row["max_abs_err_state"])
    if reps:
        q, nc = chunk, l // chunk
        flops = b * h * nc * (q * (q + 1) // 2 * (2 * n + 2 * p) + 4 * q * p * n)
        es = x.element_size()
        nbytes = (2 * x.numel() + B.numel() + C.numel()) * es \
            + dts.numel() * 4 + state.numel() * 4
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        row.update(
            ms=time_ms(lambda: sk.ssd_scan_fwd(x, dts, A, B, C, chunk=chunk,
                                               return_state=True), reps),
            plain_ms=time_ms(lambda: ref.ssd_chunked(x, dts, A, B, C, chunk=chunk),
                             max(2, reps // 4)),
            library_ms=None,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            flops=flops, bytes=nbytes,
        )
    log(json.dumps({k_: (round(v_, 6) if isinstance(v_, float) else v_)
                    for k_, v_ in row.items()}))
    del xbc, x, B, C, y, state, py, pstate
    torch.cuda.empty_cache()
    return row


def phase_ssd():
    mamba2 = dict(b=2, l=4096, h=80, p=64, n=128)
    RESULTS["ssd_cases"] = [
        _ssd_case("mamba2_4096", 10, g=1, dtype="bfloat16", reps=10, **mamba2),
        _ssd_case("zamba2_4096", 11, b=2, l=4096, h=112, p=64, n=64, g=1,
                  dtype="bfloat16", reps=10),
        _ssd_case("grouped_g2", 12, g=2, dtype="bfloat16", **mamba2),
        _ssd_case("chunk48_fp32", 13, b=2, l=48, h=8, p=64, n=128, g=1, dtype="float32",
                  chunk=48),
        _ssd_case("fp32_1024", 14, b=1, l=1024, h=8, p=64, n=128, g=2, dtype="float32",
                  chunk=64),
        _ssd_case("mamba2_fp32_4096", 15, g=1, dtype="float32", **mamba2),
    ]


def phase_serve(arch, layers, d_model, prompt_len, per_prefill):
    """Serve ``arch`` at its full config through the launcher; the kernels'
    counts are zeroed just before and read just after."""

    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.runtime.server import Request

    argv = ["--arch", arch, "--requests", "2", "--prompt-len", str(prompt_len),
            "--new-tokens", str(NEW_TOKENS)]
    mods = _kernel_modules()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.reset_launches()
    t0 = time.perf_counter()
    server, tokens, stats = serve.run(argv)
    wall = time.perf_counter() - t0
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = server.cfg
    prefills = server.prefill_calls
    log(f"served {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params; wall {wall:.1f}s (init included); "
        f"launches {launches}; peak {peak_gb:.2f} GB from {start_gb:.2f} GB allocated "
        f"before the serve")
    log("cold stats " + json.dumps(stats))
    check(cfg.num_layers == layers and cfg.d_model == d_model, f"not the full {arch} config")
    check(prefills >= 1, f"{arch}: no prefill ran")
    for name, per in per_prefill.items():
        check(launches[name] == per * prefills,
              f"{arch}: {name} launches {launches[name]} != {per} x {prefills} prefill calls")
    check(tokens.shape == (2, NEW_TOKENS), f"tokens shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token outside the vocab")

    rng = np.random.default_rng(0)  # the launcher's prompts, drawn again
    reqs = [Request(tokens=rng.integers(1, cfg.vocab_size, size=(prompt_len,), dtype=np.int32))
            for _ in range(2)]
    params_gb = sum(t.numel() * t.element_size() for t in _tensors(server.params)) / 1e9
    torch.cuda.reset_peak_memory_stats()
    warm_tokens, warm = server.generate(reqs)
    warm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("warm stats " + json.dumps(warm) + f"; params {params_gb:.2f} GB, "
        f"peak of the warm generate {warm_peak_gb:.2f} GB")
    check(np.array_equal(warm_tokens, tokens), f"{arch}: warm generate changed the greedy tokens")
    batch = {"tokens": torch.as_tensor(np.stack([r.tokens for r in reqs]), device="cuda")}
    with torch.inference_mode():
        logits, cache = server.bundle.prefill(server.params, batch, server.pcfg,
                                              extra_capacity=NEW_TOKENS)
        check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite prefill logits")
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1).to(torch.int32)[:, None]
        profiles = {
            "prefill": _profile(lambda: server.bundle.prefill(
                server.params, batch, server.pcfg, extra_capacity=NEW_TOKENS)),
            "decode_x4": _profile(lambda: [server.bundle.decode(
                server.params, cache, tok, server.pcfg) for _ in range(4)]),
        }
    RESULTS.setdefault("serve", {})[arch] = {
        "argv": argv, "cold": stats, "warm": warm, "prefill_calls": prefills,
        "launches": launches, "params_gb": params_gb, "mem_gb_at_start": start_gb,
        "peak_mem_gb_serve": peak_gb, "peak_mem_gb_warm_generate": warm_peak_gb,
        "profiles": profiles,
    }
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


def phase_small_model(arch):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.runtime.server import Request, Server, ServerConfig

    cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="float32")
    pcfg = base.get_parallel(arch)
    scfg = ServerConfig(max_batch=2, max_new_tokens=8)
    gpu = Server(cfg, pcfg, scfg, device="cuda")
    cpu = Server(cfg, pcfg, scfg, device="cpu")
    cpu.params = _to_cpu(gpu.params)
    rng = np.random.default_rng(1)
    reqs = [Request(tokens=rng.integers(1, cfg.vocab_size, size=(24,), dtype=np.int32))
            for _ in range(2)]
    t_gpu, _ = gpu.generate(reqs)
    t_cpu, _ = cpu.generate(reqs)
    log(f"{arch} smoke model fp32, card vs CPU path: tokens {t_gpu.tolist()} vs {t_cpu.tolist()}")
    check(np.array_equal(t_gpu, t_cpu), f"{arch}: card and CPU path generate different tokens")
    RESULTS.setdefault("small_model", {})[arch] = {"tokens_equal": True, "tokens": t_gpu.tolist()}
    del gpu
    torch.cuda.empty_cache()


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _kernel_line(name, source, replaces, cases, main_case, launches):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(by_path[name] for by_path in launches.values()),
        "launches_by_path": {arch: by_path[name] for arch, by_path in launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }


def main() -> int:
    import torch

    import repro_torch.kernels.flash_attention.kernel  # noqa: F401  (the port is here)

    phase_device()
    phase_build()
    phase_kernels()
    phase_ssd()
    launches = {arch: phase_serve(arch, *spec) for arch, *spec in SERVES}
    for arch, *_ in SERVES:
        phase_small_model(arch)

    kernels = [
        _kernel_line("flash_attention_fwd",
                     "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:37",
                     RESULTS["kernel_cases"], RESULTS["kernel_cases"][0], launches),
        _kernel_line("ssd_scan_fwd", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:29",
                     RESULTS["ssd_cases"], RESULTS["ssd_cases"][0], launches),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} never launched on the main paths")
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
