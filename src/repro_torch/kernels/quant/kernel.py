"""Loader and wrappers of the CUDA int8 row quantize / dequantize kernels
(``csrc/quant_int8.cu``), the Hopper port of the TPU kernels
``repro/kernels/quant/kernel.py:_quant_kernel`` and ``_dequant_kernel``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use, under
``build/quant/<hash>`` at the repository root, and loaded with ``ctypes``
(:mod:`repro_torch.kernels.nvcc`).  Nothing is built when this module is
imported.

The wrappers take CUDA tensors only, any row count and any row width (the
Pallas kernel takes width 256 only, and row counts that are a multiple of
its 64-row tile: ROADMAP C2).  They launch on the current stream, read
nothing back to the host and count their launches in :data:`LAUNCHES`, by
entry point, whichever body ran; a build or launch failure raises.

The quantize has three bodies, and :func:`quant_body` picks one from the
input's shape, stride and address.  Rows of up to :data:`MAX_WIDTH`
elements (the int8 KV cache's heads, the flat API's blocks) take the vector
or the warp body; wider rows (the optimizer's int8 moments, quantized along
each parameter's last axis) the **wide body**: one block of 256 threads a
row, a pass for the absmax (16-byte loads where the row's start allows)
and a second pass, over the row again, for the payload.  The dequantize
takes any width too: a warp a row up to :data:`MAX_WIDTH`, a block a row
above it.  All are bound by bytes on the card
(reading x, writing the int8 payload), with the conversion pipes near: an
element takes a division and a float-to-int conversion, and nvcc's
division alone is a MUFU.RCP, five FFMAs and a range check.  The **vector
body** takes rows made of whole 16-byte chunks (width · itemsize and the
row stride in bytes multiples of 16, the data 16-byte aligned), at any row
count: a group of lanes a row, one 16-byte load a lane, two rows in flight
a group, the division's reciprocal once a row, one rounding an element,
one 8- or 4-byte store a lane (``csrc/quant_int8.cu`` gives its SASS count
and its launch's reasons).  The **warp body** takes every other shape
(200-byte rows, views offset by an element): one warp a row, one element a
lane per load.  The entry point checks the choice and refuses a vector body
the shape does not allow, and a wide body on rows the other two take (or
theirs on wider rows).  All three are bit for bit the plain version.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import errors, tool
from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_int8.cu"
#: The widest row the warp and vector bodies take; wider rows take the wide body.
MAX_WIDTH = 256
#: The widest row the wrappers take (the C entry's width is an int).
MAX_WIDE_WIDTH = 2 ** 31 - 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: The quantize's bodies, as its C entry point numbers them.
WARP_BODY, VECTOR_BODY, WIDE_BODY = 0, 1, 2
#: Bytes a lane of the vector body loads at once.
CHUNK_BYTES = 16
#: ctypes declarations of the two C entry points: the three tensors; dtype,
#: rows, width, the input's row stride; the quantize's body; stream.
_ROW_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
ARGTYPES = {"quantize_int8_rows": _ROW_ARGTYPES + [ctypes.c_int, ctypes.c_void_p],
            "dequantize_int8_rows": _ROW_ARGTYPES + [ctypes.c_void_p]}

#: The shared library and its two C entry points, built at first use.
LIBRARY = nvcc.Library(SOURCE, "quant", ARGTYPES)
#: Kernel launches by entry point since the last :func:`reset_launches`, a
#: CUDA graph's replays included (``core.tool.launch_counter``).
LAUNCHES = dict.fromkeys(ARGTYPES, 0)


def reset_launches() -> None:
    for symbol in LAUNCHES:
        LAUNCHES[symbol] = 0


def _launch_adder(symbol: str):
    def add(n: int) -> None:
        LAUNCHES[symbol] += n

    return add


_COUNT_LAUNCH = {symbol: tool.launch_counter(symbol, _launch_adder(symbol))
                 for symbol in ARGTYPES}


def quant_body(width: int, itemsize: int, row_stride: int, data_ptr: int) -> int:
    """The quantize body for rows of ``width`` elements of ``itemsize``
    bytes, ``row_stride`` elements apart, from address ``data_ptr``:
    :data:`WIDE_BODY` for rows over :data:`MAX_WIDTH` elements (by width
    alone); else :data:`VECTOR_BODY` where every 16-byte chunk lies in one
    row (the row's bytes, the stride's bytes and the address multiples of
    16), else :data:`WARP_BODY`.  The C entry refuses any other choice."""

    if width > MAX_WIDTH:
        return WIDE_BODY
    aligned = (width * itemsize, row_stride * itemsize, data_ptr)
    return VECTOR_BODY if all(n % CHUNK_BYTES == 0 for n in aligned) else WARP_BODY


def _check_rows(what: str, t: torch.Tensor, dtypes) -> None:
    errors.check(
        t.is_cuda,
        errors.ErrorClass.ERR_ARG,
        f"quant kernel: {what} must be a CUDA tensor, got {t.device}",
    )
    errors.check(
        t.dtype in dtypes,
        errors.ErrorClass.ERR_TYPE,
        f"quant kernel: {what} must be one of {list(dtypes)}, got {t.dtype}",
    )
    errors.check(
        t.dim() == 2 and t.shape[0] >= 1 and 1 <= t.shape[1] <= MAX_WIDE_WIDTH
        and (t.stride(1) == 1 or t.shape[1] == 1) and t.stride(0) >= t.shape[1],
        errors.ErrorClass.ERR_DIMS,
        f"quant kernel: {what} must be a non-empty (rows, width) tensor "
        f"with unit column stride, got shape {tuple(t.shape)} strides {t.stride()}",
    )


def _launch(symbol: str, args: tuple, device: torch.device, what: str) -> None:
    entry = LIBRARY.entry(symbol)
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        errors.fail(errors.ErrorClass.ERR_OTHER,
                    f"{symbol} launch failed: cudaError {rc} ({what})")
    _COUNT_LAUNCH[symbol]()


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (rows, width) fp32 or bf16 → (int8 (rows, width), fp32 scales
    (rows, 1)), one launch of :func:`quant_body`'s choice."""

    _check_rows("x", x, _DTYPE_CODES)
    rows, width = x.shape
    q = torch.empty((rows, width), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    body = quant_body(width, x.element_size(), x.stride(0), x.data_ptr())
    _launch("quantize_int8_rows",
            (x.data_ptr(), q.data_ptr(), s.data_ptr(), _DTYPE_CODES[x.dtype],
             rows, width, x.stride(0), body),
            x.device, f"x {tuple(x.shape)} {x.dtype} body {body}")
    return q, s


def dequantize_int8_rows(
    q: torch.Tensor, s: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """(int8 (rows, width), fp32 (rows, 1)) → ``q·s`` in ``out_dtype`` (fp32
    or bf16), one launch."""

    _check_rows("q", q, (torch.int8,))
    errors.check(
        s.is_cuda and s.device == q.device and s.dtype == torch.float32
        and tuple(s.shape) == (q.shape[0], 1) and s.is_contiguous(),
        errors.ErrorClass.ERR_ARG,
        f"quant kernel: scales must be a contiguous float32 ({q.shape[0]}, 1) tensor on "
        f"{q.device}, got {tuple(s.shape)} {s.dtype} on {s.device}",
    )
    errors.check(
        out_dtype in _DTYPE_CODES,
        errors.ErrorClass.ERR_TYPE,
        f"quant kernel: out_dtype must be one of {list(_DTYPE_CODES)}, got {out_dtype}",
    )
    rows, width = q.shape
    out = torch.empty((rows, width), dtype=out_dtype, device=q.device)
    _launch("dequantize_int8_rows",
            (q.data_ptr(), s.data_ptr(), out.data_ptr(), _DTYPE_CODES[out_dtype],
             rows, width, q.stride(0)),
            q.device, f"q {tuple(q.shape)} → {out_dtype}")
    return out
