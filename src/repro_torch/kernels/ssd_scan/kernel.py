"""Loader and wrapper of the CUDA SSD-scan forward kernel
(``csrc/ssd_scan_fwd.cu``), the Hopper port of the TPU kernel
``repro/kernels/ssd_scan/kernel.py:_ssd_kernel``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use, under
``build/ssd_scan/<hash>`` at the repository root, and loaded with ``ctypes``
(:mod:`repro_torch.kernels.nvcc`).  Nothing is built when this module is
imported.

:func:`ssd_scan_fwd` takes CUDA tensors only, launches on the current
stream and counts its launches in :data:`LAUNCHES`; a build or launch
failure raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import errors, tool
from repro_torch.kernels import nvcc, registry

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan_fwd.cu"
MAX_HEAD_DIM = 64  # the kernel's PMAX: mamba2 and zamba2 have p 64
MAX_STATE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: ctypes declaration of the C entry point: x, dt, A, B, C, y, state;
#: dtype, b, l, h, g, p, n; the 15 strides of x, dt, B, C; stream.
ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 15
    + [ctypes.c_void_p]
)

#: ctypes declaration of the launch-shape query: dtype code, n, int[4] out.
SHAPE_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: The shared library and its C entry points, built at first use.
LIBRARY = nvcc.Library(SOURCE, "ssd_scan",
                       {"ssd_scan_fwd": ARGTYPES, "ssd_scan_occupancy": SHAPE_ARGTYPES})
#: Kernel launches since the last :func:`reset_launches`, a CUDA graph's
#: replays included (``core.tool.launch_counter``).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _add_launches(n: int) -> None:
    global LAUNCHES
    LAUNCHES += n


_count_launch = tool.launch_counter("ssd_scan_fwd", _add_launches)


def _check_inputs(x, dt, A, B, C) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C))
    for name, t in named:
        errors.check(
            t.is_cuda and t.device == x.device,
            errors.ErrorClass.ERR_ARG,
            f"ssd kernel: {name} must be a CUDA tensor on {x.device}, got {t.device}",
        )
    errors.check(
        x.dtype in _DTYPE_CODES and B.dtype == x.dtype and C.dtype == x.dtype,
        errors.ErrorClass.ERR_TYPE,
        f"ssd kernel: x/B/C must share one of {list(_DTYPE_CODES)}, "
        f"got {x.dtype}/{B.dtype}/{C.dtype}",
    )
    errors.check(
        dt.dtype == torch.float32 and A.dtype == torch.float32,
        errors.ErrorClass.ERR_TYPE,
        f"ssd kernel: dt and A must be float32, got {dt.dtype}/{A.dtype}",
    )
    errors.check(
        x.dim() == 4 and x.numel() > 0 and B.dim() == 4 and C.shape == B.shape,
        errors.ErrorClass.ERR_DIMS,
        f"ssd kernel: x must be a non-empty (b, l, h, p) tensor and B/C equal "
        f"(b, l, g, n) tensors, got {tuple(x.shape)}, {tuple(B.shape)}, {tuple(C.shape)}",
    )
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    errors.check(
        tuple(dt.shape) == (b, l, h) and tuple(A.shape) == (h,)
        and B.shape[:2] == x.shape[:2] and g >= 1 and h % g == 0,
        errors.ErrorClass.ERR_DIMS,
        f"ssd kernel: dt {tuple(dt.shape)}, A {tuple(A.shape)} and B/C "
        f"{tuple(B.shape)} do not match x {tuple(x.shape)} (h divisible by g)",
    )
    errors.check(
        p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE,
        errors.ErrorClass.ERR_DIMS,
        f"ssd kernel: head_dim {p} must be at most {MAX_HEAD_DIM} and the state "
        f"size {n} at most {MAX_STATE}",
    )


def ssd_scan_fwd(
    x: torch.Tensor,    # (b, l, h, p)
    dt: torch.Tensor,   # (b, l, h) float32
    A: torch.Tensor,    # (h,) float32
    B: torch.Tensor,    # (b, l, g, n)
    C: torch.Tensor,    # (b, l, g, n)
    *,
    chunk: int = 128,
    return_state: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state, any strides.  → contiguous y
    (b, l, h, p) in x's dtype, and with ``return_state`` also the fp32
    final state (b, h, p, n) from the same launch.  ``chunk`` is held to
    the reference's contract (``l % chunk == 0``); the kernel's own tile is
    64 rows, which gives the same result.  The launch is the CUDA
    implementation of the op ``torch.ops.repro_torch.ssd_scan_fwd``
    (:mod:`repro_torch.kernels.registry`)."""

    y, state = _SSD_OP(x, dt, A, B, C, chunk, return_state)
    return (y, state) if return_state else y


def _launch(x, dt, A, B, C, chunk, return_state):
    # (y, state); without return_state the state is empty (an op returns a
    # fixed structure)
    _check_inputs(x, dt, A, B, C)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    errors.check(
        chunk >= 1 and l % chunk == 0,
        errors.ErrorClass.ERR_DIMS,
        f"ssd kernel: sequence length {l} is not a multiple of chunk {chunk}",
    )
    A = A.contiguous()
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n) if return_state else (0,), dtype=torch.float32,
                        device=x.device)
    entry = LIBRARY.entry("ssd_scan_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr() if return_state else None,
            _DTYPE_CODES[x.dtype], b, l, h, g, p, n,
            *x.stride(), *dt.stride(), *B.stride(), *C.stride(),
            stream,
        )
    if rc != 0:
        errors.fail(
            errors.ErrorClass.ERR_OTHER,
            f"ssd kernel launch failed: cudaError {rc} "
            f"(x {tuple(x.shape)} {x.dtype}, B {tuple(B.shape)})",
        )
    _count_launch()
    return y, state


def _fake(x, dt, A, B, C, chunk, return_state):
    b, l, h, p = x.shape
    n = B.shape[3]
    return (x.new_empty((b, l, h, p)),
            x.new_empty((b, h, p, n) if return_state else (0,), dtype=torch.float32))


_SSD_OP = registry.define(
    "ssd_scan_fwd",
    "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, int chunk, bool return_state) "
    "-> (Tensor, Tensor)", _launch, _fake)


@register_flop_formula(_SSD_OP)
def _ssd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *args,
               out_shape=None, **kwargs) -> int:
    """The reference kernel's four matmuls a (batch, head, chunk) step:
    ``C Bᵀ``, ``(C Bᵀ ⊙ L) X``, the carried state into the chunk
    (``C H``) and the chunk into the state (``Bᵀ X``)."""

    b, l, h, p = x_shape
    n = B_shape[3]
    c = chunk
    return b * h * (l // c) * (2 * c * c * n + 2 * c * c * p + 4 * c * n * p)


registry.register_bytes_formula(_SSD_OP)(registry.read_once_write_once)


def launch_shape(dtype: torch.dtype, n: int) -> dict:
    """How the kernel runs a call of ``dtype`` and state size ``n`` on the
    current card: state rows per block (``p_tile``; the bf16 body splits
    the state over p), threads and dynamic shared bytes per block, and the
    blocks resident on one SM (the CUDA occupancy calculator)."""

    errors.check(dtype in _DTYPE_CODES and 1 <= n <= MAX_STATE, errors.ErrorClass.ERR_ARG,
                 f"ssd kernel: no instantiation for {dtype} and state size {n}")
    out = (ctypes.c_int * 4)()
    rc = LIBRARY.entry("ssd_scan_occupancy")(_DTYPE_CODES[dtype], n, ctypes.addressof(out))
    if rc != 0:
        errors.fail(errors.ErrorClass.ERR_OTHER,
                    f"ssd kernel occupancy query failed: cudaError {rc}")
    return dict(zip(("p_tile", "threads", "smem_bytes", "blocks_per_sm"), out))
