"""Int8 compression with per-block scales, the plain PyTorch copy of
:mod:`repro.core.compress` (the flat-payload oracle) and of its row form,
the per-(token, head) quantization of the int8 KV cache
(``repro.models.attention._quantize_kv``).

Symmetric per row: ``scale = absmax / 127`` (1.0 for an all-zero row),
``q = clip(round(x / scale), -127, 127)`` rounded half to even, and
``x ≈ q · scale``.  Both divisions are IEEE ones, as the reference's are
when it runs eagerly; under ``jax.jit`` XLA multiplies by the reciprocal
of 127 instead, which moves some scales by one ulp (ROADMAP C5).  The
divisor is a tensor, never the Python scalar 127: PyTorch's CUDA division
by a host scalar also multiplies by its reciprocal, and this module must
mean the same on the CPU and on the card, where the CUDA kernel of
:mod:`repro_torch.kernels.quant` is held to it bit for bit.
"""

from __future__ import annotations

import torch

BLOCK = 256  # elements per scale block


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (rows, width) float → (int8 (rows, width), fp32 scales (rows, 1))."""

    xf = x.float()
    absmax = xf.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / absmax.new_tensor(127.0), 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor, out_dtype=torch.float32):
    """(int8 (rows, width), fp32 (rows, 1)) → ``q·scale`` in ``out_dtype``."""

    return (q.float() * scale).to(out_dtype)


def _pad_to_block(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, pad


def quantize_int8(
    x: torch.Tensor, block: int = BLOCK, quantize_rows=quantize_int8_rows
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Flat tensor → (int8 payload, fp32 per-block scales, pad).
    ``quantize_rows`` quantizes the padded ``(blocks, block)`` payload: the
    plain row function here, the device-dispatching one in
    :mod:`repro_torch.kernels.quant.ops`."""

    flat, pad = _pad_to_block(x.reshape(-1).float(), block)
    q, scale = quantize_rows(flat.reshape(-1, block))
    return q.reshape(-1), scale[:, 0], pad


def dequantize_int8(
    q, scale, pad: int, shape, dtype, block: int = BLOCK, dequantize_rows=dequantize_int8_rows
) -> torch.Tensor:
    flat = dequantize_rows(q.reshape(-1, block), scale[:, None], dtype).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compression_error(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Residual ``x - dequant(quant(x))`` for error feedback."""

    q, s, pad = quantize_int8(x, block)
    return x - dequantize_int8(q, s, pad, x.shape, x.dtype, block)
