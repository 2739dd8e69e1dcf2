"""Public wrappers for int8 block quantization: the reference's flat-payload
API (:func:`quantize_int8` / :func:`dequantize_int8`, matching
:mod:`repro_torch.core.compress`) and the row API the int8 KV cache uses.

Each dispatches on where the tensor lies, not on ``impl``: a CUDA tensor
always launches the hand-written kernel (``kernel.py``), a CPU tensor takes
the plain version (``ref``).  There is no fallback: a build or launch
failure raises.  There is no autograd, as the reference kernel has no VJP.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant import kernel as _kernel
from repro_torch.kernels.quant import ref as _ref


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (rows, width), any width → (int8 (rows, width), fp32 scales
    (rows, 1))."""

    if x.is_cuda:
        return _kernel.quantize_int8_rows(x)
    return _ref.quantize_int8_rows(x)


def dequantize_int8_rows(q: torch.Tensor, s: torch.Tensor, out_dtype=torch.float32):
    """(int8 (rows, width), fp32 (rows, 1)) → ``q·s`` in ``out_dtype``."""

    if q.is_cuda:
        return _kernel.dequantize_int8_rows(q, s, out_dtype)
    return _ref.dequantize_int8_rows(q, s, out_dtype)


def quantize_int8(x: torch.Tensor, *, impl: str = "ref"):
    """Flat tensor → (q int8 flat, scales fp32 per block, pad), the payload
    laid out by :func:`repro_torch.core.compress.quantize_int8`.
    ``impl`` names the reference's implementation; the port picks by device
    and ignores it."""

    return _ref.quantize_int8(x, quantize_rows=quantize_int8_rows)


def dequantize_int8(q, scale, pad: int, shape, dtype, *, impl: str = "ref"):
    return _ref.dequantize_int8(q, scale, pad, shape, dtype,
                                dequantize_rows=dequantize_int8_rows)
