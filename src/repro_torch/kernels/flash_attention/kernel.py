"""Loader and wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attention_fwd.cu``), the Hopper port of the TPU kernel
``repro/kernels/flash_attention/kernel.py:_fwd_kernel``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use, under
``build/flash_attention/<hash>`` at the repository root (keyed by a hash of
the source), and loaded with ``ctypes`` (:mod:`repro_torch.kernels.nvcc`).
Nothing is built when this module is imported.

:func:`flash_attention_fwd` takes CUDA tensors only, launches on the current
stream and counts its launches in :data:`LAUNCHES`; a build or launch
failure raises.  The launch is the CUDA implementation of the custom op
``torch.ops.repro_torch.flash_attention_fwd`` (:mod:`repro_torch.kernels.
registry`): on fake tensors it gives the output's shape, the reference
kernel's flops (its 512 x 512 tiles, the causal skip included) and bytes,
and launches nothing.  The values may be narrower than the queries and keys
(``dv <= d``, MLA's).  bf16 inputs run on the tensor cores, their tiles copied by
TMA and 16-byte cp.async copies, so each of q, k and v must have contiguous
rows on 16-byte boundaries (:func:`check_copyable`); fp32 inputs run on the
CUDA cores in any strides.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import errors, tool
from repro_torch.kernels import nvcc, registry
from repro_torch.kernels.flash_attention.ref import NEG_INF  # noqa: F401
from repro_torch.kernels.registry import attention_tiles

# the reference's Pallas blocks, over which the op's flop formula counts the
# tiles the reference kernel computes; the CUDA kernel tiles by 64 itself
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: ctypes declaration of the C entry point: q, k, v, o; dtype, b, sq, sk, h,
#: hk, d, dv; the 12 strides of q, k, v; scale, softcap; causal, window,
#: prefix; stream.
ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 12
    + [ctypes.c_float] * 2
    + [ctypes.c_int] * 3
    + [ctypes.c_void_p]
)

#: The shared library and its C entry point, built at first use.
LIBRARY = nvcc.Library(SOURCE, "flash_attention", {"flash_attention_fwd": ARGTYPES})
#: Kernel launches since the last :func:`reset_launches`, a CUDA graph's
#: replays included (``core.tool.launch_counter``).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _add_launches(n: int) -> None:
    global LAUNCHES
    LAUNCHES += n


_count_launch = tool.launch_counter("flash_attention_fwd", _add_launches)


def check_copyable(kernel: str, name: str, t: torch.Tensor) -> None:
    """A bf16 tensor whose tiles the tensor-core body copies by TMA and
    16-byte cp.async copies: innermost stride 1, a 16-byte-aligned base, and
    every other stride (of a dimension longer than 1) a multiple of 8
    elements; else ERR_ARG."""

    errors.check(
        t.stride(-1) == 1 and t.data_ptr() % 16 == 0
        and all(st % 8 == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1),
        errors.ErrorClass.ERR_ARG,
        f"{kernel}: bf16 {name} needs innermost stride 1, a 16-byte-aligned base and "
        f"other strides in multiples of 8 elements, got strides {t.stride()} at "
        f"{t.data_ptr() % 16} bytes past a 16-byte boundary",
    )


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        errors.check(
            t.is_cuda and t.device == q.device,
            errors.ErrorClass.ERR_ARG,
            f"flash kernel: {name} must be a CUDA tensor on {q.device}, got {t.device}",
        )
        errors.check(
            t.dtype == q.dtype and t.dtype in _DTYPE_CODES,
            errors.ErrorClass.ERR_TYPE,
            f"flash kernel: q/k/v must share one of {list(_DTYPE_CODES)}, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}",
        )
        errors.check(
            t.dim() == 4 and t.numel() > 0,
            errors.ErrorClass.ERR_DIMS,
            f"flash kernel: {name} must be a non-empty (b, s, heads, d) tensor, "
            f"got shape {tuple(t.shape)}",
        )
    b, _, h, d = q.shape
    errors.check(
        k.shape[:3] == v.shape[:3] and k.shape[0] == b and k.shape[3] == d,
        errors.ErrorClass.ERR_DIMS,
        f"flash kernel: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
        f"{tuple(q.shape)}",
    )
    errors.check(
        h % k.shape[2] == 0,
        errors.ErrorClass.ERR_DIMS,
        f"flash kernel: {h} query heads do not group over {k.shape[2]} KV heads",
    )
    errors.check(
        d % 8 == 0 and d <= MAX_HEAD_DIM,
        errors.ErrorClass.ERR_DIMS,
        f"flash kernel: head_dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {d}",
    )
    errors.check(
        v.shape[3] % 8 == 0 and v.shape[3] <= d,
        errors.ErrorClass.ERR_DIMS,
        f"flash kernel: v's width must be a multiple of 8 up to q's {d}, got {v.shape[3]}",
    )
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_copyable("flash kernel", name, t)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    prefix_len: int | None = None,
    logit_softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """q: (b, sq, h, d); k: (b, sk, hk, d); v: (b, sk, hk, dv) with dv <= d;
    h % hk == 0, any strides.  → contiguous (b, sq, h, dv) in q's dtype
    (bf16 or fp32)."""

    return _FLASH_OP(q, k, v, causal, sliding_window, prefix_len, logit_softcap, scale)


def _launch(q, k, v, causal, sliding_window, prefix_len, logit_softcap, scale):
    _check_inputs(q, k, v)
    errors.check(
        sliding_window is None or sliding_window >= 1,
        errors.ErrorClass.ERR_ARG,
        f"flash kernel: sliding_window must be >= 1, got {sliding_window}",
    )
    errors.check(
        prefix_len is None or prefix_len >= 0,
        errors.ErrorClass.ERR_ARG,
        f"flash kernel: prefix_len must be >= 0, got {prefix_len}",
    )
    errors.check(
        logit_softcap is None or logit_softcap > 0,
        errors.ErrorClass.ERR_ARG,
        f"flash kernel: logit_softcap must be > 0, got {logit_softcap}",
    )
    b, sq, h, d = q.shape
    sk, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    entry = LIBRARY.entry("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, sq, sk, h, hk, d, dv,
            *q.stride(), *k.stride(), *v.stride(),
            float(scale),
            float(logit_softcap) if logit_softcap is not None else 0.0,
            int(causal),
            int(sliding_window) if sliding_window is not None else 0,
            int(prefix_len) if prefix_len is not None else -1,
            stream,
        )
    if rc != 0:
        errors.fail(
            errors.ErrorClass.ERR_OTHER,
            f"flash kernel launch failed: cudaError {rc} "
            f"(q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, v {tuple(v.shape)})",
        )
    _count_launch()
    return out


def _fake(q, k, v, causal, sliding_window, prefix_len, logit_softcap, scale):
    b, sq, h, _ = q.shape
    return q.new_empty((b, sq, h, v.shape[3]))


_FLASH_OP = registry.define(
    "flash_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, bool causal, int? sliding_window, int? prefix_len, "
    "float? logit_softcap, float? scale) -> Tensor", _launch, _fake)


@register_flop_formula(_FLASH_OP)
def _flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None, **kwargs) -> int:
    """The reference kernel's two matmuls over the tiles it computes."""

    b, sq, h, d = q_shape
    sk, dv = k_shape[1], v_shape[3]
    bq, bk = min(DEFAULT_BLOCK_Q, sq), min(DEFAULT_BLOCK_K, sk)
    return attention_tiles(sq, sk, causal, block_q=DEFAULT_BLOCK_Q,
                           block_k=DEFAULT_BLOCK_K) * b * h * 2 * bq * bk * (d + dv)


registry.register_bytes_formula(_FLASH_OP)(registry.read_once_write_once)
