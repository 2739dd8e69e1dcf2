"""Loader and wrapper of the CUDA ring-step kernel
(``csrc/ring_step_fwd.cu``), the Hopper port of the TPU kernel
``repro/kernels/ring_attention/kernel.py:_step_kernel``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use, under
``build/ring_attention/<hash>`` at the repository root, and loaded with
``ctypes`` (:mod:`repro_torch.kernels.nvcc`).  Nothing is built when this
module is imported.

:func:`ring_step_fwd` dispatches on where the tensors lie: a CPU tensor
runs the plain twin (``ref.ring_step_ref``), a CUDA tensor launches the
kernel — on the current stream, counted in :data:`LAUNCHES` — or raises.
On the card the carry is updated in place and returned; the launch is
the CUDA implementation of the op ``torch.ops.repro_torch.
ring_step_fwd``, which mutates the carry (:mod:`repro_torch.kernels.
registry`).  The kernel shares
the flash kernel's tile body: bf16 q, k and v run on the tensor cores and
must have contiguous rows on 16-byte boundaries
(``flash_attention.kernel.check_copyable``); fp32 ones run on the CUDA
cores in any strides.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import errors, tool
from repro_torch.kernels import nvcc, registry
from repro_torch.kernels.flash_attention.kernel import check_copyable
from repro_torch.kernels.ring_attention import ref as _ref
from repro_torch.kernels.ring_attention.ref import ring_step_ref  # noqa: F401 (the plain twin)

NEG_INF = _ref.NEG_INF
# the reference's Pallas blocks: the ops layer pads shards to their
# multiples, as the reference does; the CUDA kernel tiles by 64 itself
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512

SOURCE = Path(__file__).resolve().parent / "csrc" / "ring_step_fwd.cu"
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: ctypes declaration of the C entry point: q, k, v, m, l, acc, info;
#: dtype, b, sq, sk, h, hk, d; the 12 strides of q, k, v; scale; causal;
#: stream.
ARGTYPES = (
    [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 12
    + [ctypes.c_float]
    + [ctypes.c_int]
    + [ctypes.c_void_p]
)

#: The shared library and its C entry point, built at first use.
LIBRARY = nvcc.Library(SOURCE, "ring_attention", {"ring_step_fwd": ARGTYPES})
#: Kernel launches since the last :func:`reset_launches`, a CUDA graph's
#: replays included (``core.tool.launch_counter``).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _add_launches(n: int) -> None:
    global LAUNCHES
    LAUNCHES += n


_count_launch = tool.launch_counter("ring_step_fwd", _add_launches)


def _check_inputs(q, k, v, m, l, acc, info) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("m", m), ("l", l), ("acc", acc),
                    ("info", info)):
        errors.check(
            t.is_cuda and t.device == q.device,
            errors.ErrorClass.ERR_ARG,
            f"ring step kernel: {name} must be a CUDA tensor on {q.device}, got {t.device}",
        )
    errors.check(
        q.dtype in _DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype,
        errors.ErrorClass.ERR_TYPE,
        f"ring step kernel: q/k/v must share one of {list(_DTYPE_CODES)}, "
        f"got {q.dtype}/{k.dtype}/{v.dtype}",
    )
    errors.check(
        q.dim() == 4 and k.dim() == 4 and q.numel() > 0 and k.numel() > 0,
        errors.ErrorClass.ERR_DIMS,
        f"ring step kernel: q and k/v must be non-empty (b, heads, s, d) tensors, got "
        f"{tuple(q.shape)} and {tuple(k.shape)}",
    )
    b, h, sq, d = q.shape
    errors.check(
        k.shape == v.shape and k.shape[0] == b and k.shape[3] == d and h % k.shape[1] == 0,
        errors.ErrorClass.ERR_DIMS,
        f"ring step kernel: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
        f"{tuple(q.shape)}",
    )
    errors.check(
        d <= MAX_HEAD_DIM,
        errors.ErrorClass.ERR_DIMS,
        f"ring step kernel: head_dim must be at most {MAX_HEAD_DIM}, got {d}",
    )
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_copyable("ring step kernel", name, t)
    for name, t, shape in (("m", m, (b, h, sq, 1)), ("l", l, (b, h, sq, 1)),
                           ("acc", acc, (b, h, sq, d))):
        errors.check(
            t.dtype == torch.float32 and tuple(t.shape) == shape and t.is_contiguous(),
            errors.ErrorClass.ERR_ARG,
            f"ring step kernel: the carry {name} must be a contiguous fp32 {shape} tensor, "
            f"got {t.dtype} {tuple(t.shape)}",
        )
    errors.check(
        info.dtype == torch.int32 and tuple(info.shape) == (3,) and info.is_contiguous(),
        errors.ErrorClass.ERR_ARG,
        f"ring step kernel: info must be a contiguous int32 (3,) tensor "
        f"(q_offset, k_offset, kv_len), got {info.dtype} {tuple(info.shape)}",
    )


def _launch(q, k, v, m, l, acc, info, scale, causal) -> None:
    _check_inputs(q, k, v, m, l, acc, info)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    entry = LIBRARY.entry("ring_step_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc.data_ptr(), info.data_ptr(),
            _DTYPE_CODES[q.dtype], b, sq, sk, h, hk, d,
            *q.stride(), *k.stride(), *v.stride(),
            float(scale), int(causal), stream,
        )
    if rc != 0:
        errors.fail(
            errors.ErrorClass.ERR_OTHER,
            f"ring step kernel launch failed: cudaError {rc} "
            f"(q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)})",
        )
    _count_launch()


def ring_step_fwd(
    q: torch.Tensor,        # (b, h, sq, d) — local Q shard, head-major layout
    k: torch.Tensor,        # (b, hk, sk, d) — KV shard in flight
    v: torch.Tensor,        # (b, hk, sk, d)
    m: torch.Tensor,        # (b, h, sq, 1) fp32 carry
    l: torch.Tensor,        # (b, h, sq, 1) fp32 carry
    acc: torch.Tensor,      # (b, h, sq, d) fp32 carry (unnormalised)
    *,
    q_offset=None,          # global start of the Q shard
    k_offset=None,          # global start of the KV shard
    kv_len=None,            # valid rows of the KV shard
    info: torch.Tensor | None = None,
    scale: float | None = None,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring step: fold ``softmax(q @ k.T) @ v`` of this KV shard into
    the carry; returns the updated ``(m, l, acc)``.

    The three scalars come as ints (or 0-d tensors), or together as
    ``info``, an int32 ``(q_offset, k_offset, kv_len)`` tensor on q's device
    — the form that copies no host scalar per step.  Any sequence lengths;
    q/k/v in any strides.  On the card the kernel updates the carry in
    place (it must be contiguous fp32); on the CPU the plain twin returns a
    new one.
    """

    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if info is None:
        info = torch.tensor([int(q_offset), int(k_offset), int(kv_len)], dtype=torch.int32,
                            device=q.device)
    if not q.is_cuda:
        q_off, k_off, n_valid = (int(x) for x in info.tolist())
        return _ref.ring_step_ref(q, k, v, m, l, acc, q_offset=q_off, k_offset=k_off,
                                  kv_len=n_valid, scale=scale, causal=causal)
    _RING_STEP_OP(q, k, v, m, l, acc, info, float(scale), causal)
    return m, l, acc


def _fake(q, k, v, m, l, acc, info, scale, causal):
    return None


_RING_STEP_OP = registry.define(
    "ring_step_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor(a!) m, Tensor(b!) l, Tensor(c!) acc, Tensor info, "
    "float scale, bool causal) -> ()", _launch, _fake)


@register_flop_formula(_RING_STEP_OP, get_raw=True)
def _ring_step_flops(q, k, v, m, l, acc, info, scale, causal, *args, out_val=None,
                     **kwargs) -> int:
    """The reference kernel's two matmuls over the tiles it computes.  Its
    causal skip depends on the offsets in ``info``: read when ``info`` holds
    values the host may read, every tile counted when it is a fake tensor
    (no values) or lies on a card whose stream captures a CUDA graph (a
    read would sync)."""

    from torch._subclasses.fake_tensor import is_fake

    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal and not is_fake(info) and not (info.is_cuda
                                             and torch.cuda.is_current_stream_capturing()):
        q_off, k_off, _ = (int(x) for x in info.tolist())
        tiles = registry.attention_tiles(sq, sk, True, q_offset=q_off, k_offset=k_off)
    else:
        tiles = registry.attention_tiles(sq, sk, False)
    bq, bk = min(512, sq), min(512, sk)
    return tiles * b * h * 2 * bq * bk * (d + v.shape[3])


@registry.register_bytes_formula(_RING_STEP_OP)
def _ring_step_bytes(args, kwargs, out) -> int:
    """q, k and v read; the carry (m, l, acc) read and written in place."""

    q, k, v, m, l, acc = args[:6]
    return registry.tensor_bytes((q, k, v)) + 2 * registry.tensor_bytes((m, l, acc))
