#!/usr/bin/env python3
"""Host time of one call of each kernel wrapper of the port, at the shape of
its first case in ``chip_smoke.py``'s kernel table, beside the host time of
a direct call of the launch beneath its op, and the device time of the
launch.

    python3 tools/wrapper_host_us.py [--src DIR] [--reps N] [--calls N] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two trees can be compared: run it once with each
tree's ``src``, alternating, in one call on the card.  Host time: ``--reps``
rounds, each timing ``--calls`` back-to-back calls of the wrapper and then
as many of the direct launch (the function the op dispatches to, where the
tree has one: ``direct_us`` is null in a tree whose wrapper launches
directly), the queue drained between rounds; the least mean a call over the
rounds is kept (``host_us``, ``direct_us``).  Device time: ``ms``, the
median of ``chip_smoke.time_device`` over ``--reps`` (the stream held, L2
flushed), with its median host time of a single call (``time_device_host_us``,
the ``host_us`` of ``chip_smoke.py``'s kernel line, taken one call at a
time between waits).  Prints one JSON object.  Needs one CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _direct(module, *names):
    """The launch beneath a kernel's op: the first of ``names`` the module
    has, unwrapped from ``torch.library.custom_op`` where it is one; None
    when the module has none (its wrapper launches directly)."""

    for name in names:
        fn = getattr(module, name, None)
        if fn is not None:
            return getattr(fn, "_init_fn", fn)
    return None


def cases(torch):
    """name → (wrapper call, direct call or None, the library it builds)."""

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.ring_attention import kernel as rk
    from repro_torch.kernels.ssd_scan import kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {}
    # flash: gemma2-9b's global layer at serve (b 2, S 4608, 16/8 heads of
    # 256, softcap 50)
    q, k, v = randn(2, 4608, 16, 256), randn(2, 4608, 8, 256), randn(2, 4608, 8, 256)
    flash = _direct(fk, "_launch", "_flash_op")
    out["flash_attention_fwd"] = (
        lambda: fk.flash_attention_fwd(q, k, v, causal=True, logit_softcap=50.0),
        flash and (lambda: flash(q, k, v, True, None, None, 50.0, None)), fk.LIBRARY)
    # SSD: mamba2-2.7b (b 2, l 4096, h 80, p 64, n 128), chunk 128
    x = randn(2, 4096, 80, 64)
    dts = 0.1 * torch.nn.functional.softplus(randn(2, 4096, 80, dtype=torch.float32))
    A = -torch.exp(randn(80, dtype=torch.float32))
    B, C = randn(2, 4096, 1, 128), randn(2, 4096, 1, 128)
    ssd = _direct(sk, "_launch", "_ssd_op")
    out["ssd_scan_fwd"] = (
        lambda: sk.ssd_scan_fwd(x, dts, A, B, C, chunk=128, return_state=True),
        ssd and (lambda: ssd(x, dts, A, B, C, 128, True)), sk.LIBRARY)
    # quantize: gemma2-9b's global prefill call (1,553,664 x 256 bf16);
    # dequantize: its decode layer (73,984 x 256 → bf16)
    xq = randn(1_553_664, 256)
    quant = _direct(qk, "_quantize", "_quantize_op")
    out["quantize_int8_rows"] = (lambda: qk.quantize_int8_rows(xq),
                                 quant and (lambda: quant(xq)), qk.LIBRARY)
    qq, qs = qk.quantize_int8_rows(randn(73_984, 256))
    dequant = _direct(qk, "_dequantize", "_dequantize_op")
    out["dequantize_int8_rows"] = (
        lambda: qk.dequantize_int8_rows(qq, qs, torch.bfloat16),
        dequant and (lambda: dequant(qq, qs, torch.bfloat16)), qk.LIBRARY)
    # the ring step: phi4-mini's ring of one at 8192 (b 2, 24/8 heads of 128)
    qr = randn(2, 8192, 24, 128).transpose(1, 2)
    kv = torch.stack([randn(2, 8192, 8, 128), randn(2, 8192, 8, 128)])
    kv = kv.transpose(2, 3).contiguous()
    m = torch.full((2, 24, 8192, 1), -float("inf"), device="cuda")
    l_ = torch.zeros((2, 24, 8192, 1), device="cuda")
    acc = torch.zeros((2, 24, 8192, 128), device="cuda")
    info = torch.tensor([0, 0, 8192], dtype=torch.int32, device="cuda")
    # the parent's ``_launch`` is the launch itself, as is this tree's
    ring = _direct(rk, "_launch")
    out["ring_step_fwd"] = (
        lambda: rk.ring_step_fwd(qr, kv[0], kv[1], m, l_, acc, info=info, scale=128 ** -0.5,
                                 causal=True),
        ring and (lambda: ring(qr, kv[0], kv[1], m, l_, acc, info, 128 ** -0.5, True)),
        rk.LIBRARY)
    return out


def host_us(torch, fns: list, reps: int, calls: int) -> list:
    """The least mean host time of a call (µs) of each of ``fns`` over
    ``reps`` rounds of ``calls`` back-to-back calls each, the functions
    interleaved round by round."""

    best = [float("inf")] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best[i] = min(best[i], (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))

    import torch

    # the package first: chip_smoke puts this checkout's src on the path
    import repro_torch

    import chip_smoke
    from repro_torch.kernels import nvcc

    if Path(repro_torch.__file__).parent != src / "repro_torch":
        raise SystemExit(f"repro_torch from {repro_torch.__file__}, not {src}")

    calls = cases(torch)
    nvcc.build_all({id(lib): lib for *_, lib in calls.values()}.values())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    rows = {}
    for name, (wrapper, direct, _) in calls.items():
        t = chip_smoke.time_device(wrapper, args.reps)
        fns = [wrapper] + ([direct] if direct is not None else [])
        us = host_us(torch, fns, args.reps, args.calls)
        rows[name] = {"host_us": us[0], "direct_us": us[1] if direct is not None else None,
                      "time_device_host_us": t["host_us"], "ms": t["ms"], "held": t["held"]}
    print(json.dumps({"label": args.label, "src": str(Path(repro_torch.__file__).parent),
                      "card": card.strip(), "torch": torch.__version__, "reps": args.reps,
                      "calls": args.calls, "wrappers": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
