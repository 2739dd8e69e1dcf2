#!/usr/bin/env python3
"""The int8 quantize's launch choices on one card: rows in flight a lane
group and block size of the vector body, from a decode step's row count to
a prefill's, beside the warp body.

    python3 tools/quant_variants.py

Needs one CUDA device and ``nvcc``; run on demand, apart from
``chip_smoke.py``, whose pass or fail reads no result here.  Each variant is
a copy of ``src/repro_torch/kernels/quant/csrc/quant_int8.cu`` with one of
its ``constexpr`` lines rewritten (``ROWS_IN_FLIGHT``, ``VEC_THREADS``), built
under ``build/quant_variants/``, one ``nvcc`` each, all at once.  At each
shape every variant's payload and scales must equal the plain version's;
then each is timed (``chip_smoke.time_device``: the device's time alone,
L2 flushed, the median of 10 reps) at zamba2-7b's and gemma2-9b's prefill
calls (3,421,184 x 112 and 1,553,664 x 256 bf16), their decode-step calls
(64 x 112, 16 x 256) and 256 to 65,536 rows of each width, the variants in
turns, forward then backward, beside the warp body.  Prints each row and
writes them, with the card's name and power limit and each build's
registers, to ``artifacts/quant_variants.json``.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the device, build, launch and timing helpers)

# name → the source's constexpr values it sets; the empty set is the source as it is
VARIANTS = {
    "as built": {},
    "R1": {"ROWS_IN_FLIGHT": 1},
    "R4": {"ROWS_IN_FLIGHT": 4},
    "R8": {"ROWS_IN_FLIGHT": 8},
    "128 threads": {"VEC_THREADS": 128},
    "512 threads": {"VEC_THREADS": 512},
}
SHAPES = {
    "zamba2_prefill": (13 * 2 * (4096 + chip_smoke.NEW_TOKENS) * 32, 112),
    "gemma2_global_prefill": (21 * 2 * (4608 + chip_smoke.NEW_TOKENS) * 8, 256),
    "zamba2_decode_k_new": (2 * 32, 112),
    "gemma2_decode_k_new": (2 * 8, 256),
    **{f"rows_{rows}_w{width}": (rows, width)
       for width in (112, 256) for rows in (256, 1024, 4096, 16384, 65536)},
}
REPS = 10


def build_variants() -> dict:
    """Each variant's library, built from a copy of the source with its
    constexpr lines rewritten."""

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.quant import kernel as qk

    libs = {}
    for name, values in VARIANTS.items():
        if not values:
            libs[name] = qk.LIBRARY
            continue
        text = qk.SOURCE.read_text()
        for const, value in values.items():
            text, n = re.subn(rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", text)
            chip_smoke.check(n == 1, f"{qk.SOURCE.name}: no single constexpr {const}")
        tag = "_".join(f"{k.lower()}{v}" for k, v in values.items())
        src = nvcc.BUILD_ROOT / "quant_variants" / tag / qk.SOURCE.name
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        libs[name] = nvcc.Library(src, f"quant_{tag}", qk.ARGTYPES)
    nvcc.build_all(libs.values(), force=True)
    return libs


def main() -> int:
    import torch

    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.quant import ref

    chip_smoke.phase_device()
    libs = build_variants()
    registers = {name: chip_smoke._ptxas_usage(lib.log) for name, lib in libs.items()}
    # (name, library, body): every variant's vector body, and the warp body
    runs = [(name, lib, qk.VECTOR_BODY) for name, lib in libs.items()]
    runs.append(("warp body", qk.LIBRARY, qk.WARP_BODY))
    gen = torch.Generator(device="cuda").manual_seed(30)
    rows_out = []
    for shape, (rows, width) in SHAPES.items():
        x = (3.0 * torch.randn((rows, width), generator=gen, device="cuda")).to(torch.bfloat16)
        pq, ps = ref.quantize_int8_rows(x)

        def call(lib, body, x=x):
            return chip_smoke._quantize_with(x, body, lib)

        for name, lib, body in runs:
            rc, q, s = call(lib, body)
            torch.cuda.synchronize()
            chip_smoke.check(rc == 0 and torch.equal(q, pq) and torch.equal(s, ps),
                             f"{name} at {shape}: cudaError {rc}, or differs from the plain "
                             f"version")
        times: dict = {name: [] for name, _, _ in runs}
        for order in (runs, runs[::-1]):
            for name, lib, body in order:
                times[name].append(chip_smoke.time_ms(lambda lib=lib, body=body: call(lib, body),
                                                      REPS))
        bound = chip_smoke._quant_bound(rows, width, 2, 1, 6)
        for name, _, _ in runs:
            row = {"shape": shape, "rows": rows, "width": width, "variant": name,
                   "constexpr": VARIANTS.get(name, {}), "ms": statistics.median(times[name]),
                   "ms_turns": times[name], "bound_ms": bound["bound_ms"],
                   "share_of_bound": bound["bound_ms"] / statistics.median(times[name])}
            chip_smoke.log_row(row)
            rows_out.append(row)
        del x, q, s, pq, ps
        torch.cuda.empty_cache()
    out = ROOT / "artifacts"
    out.mkdir(exist_ok=True)
    (out / "quant_variants.json").write_text(json.dumps(
        {"device": chip_smoke.RESULTS["device"], "registers": registers, "rows": rows_out},
        indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
