"""The port's int8 quantization on CPU tensors against the reference: the
flat-payload oracle ``repro.core.compress``, the JAX Pallas kernel in
interpret mode, and the int8 KV cache's row functions
``repro.models.attention._quantize_kv`` / ``_dequantize_kv``.  Inputs are
numpy arrays from a seed, handed to both frameworks.

Against the eager reference the port is held **equal**, bit for bit: both
divide ``absmax / 127`` and ``x / scale`` as IEEE divisions.  The Pallas
kernel (interpret mode) multiplies by the reciprocal of 127 instead, as
XLA does under ``jit``, so its scales are held within one fp32 ulp
(rtol 2.4e-7 > 2^-23) and its int8 payload equal (ROADMAP C5)."""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcompress
from repro.kernels.quant import ops as jqo
from repro.models import attention as jattn
from repro_torch.core import compress as tcompress
from repro_torch.core import errors
from repro_torch.kernels import nvcc
from repro_torch.kernels.quant import kernel as tqk
from repro_torch.kernels.quant import ops as tqo
from repro_torch.kernels.quant import ref as tqr
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    jd, td = _DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _equal(t: torch.Tensor, j) -> None:
    """Bit-exact: same dtype (by name), same shape, same values."""

    j = np.asarray(j)
    assert str(t.dtype).removeprefix("torch.") == str(j.dtype), (t.dtype, j.dtype)
    np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                                  j.astype(np.float32) if t.dtype == torch.bfloat16 else j)


def _payload(seed: int, n: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 3.0).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 255, 256, 25_600, 65_536])
def test_compress_equals_reference(n, dtype):
    jx, tx = _both(_payload(n, n), dtype)
    tq, ts, tpad = tcompress.quantize_int8(tx)
    jq, js, jpad = jcompress.quantize_int8(jx)
    assert tpad == jpad
    _equal(tq, jq)
    _equal(ts, js)
    jd, td = _DTYPES[dtype]
    _equal(tcompress.dequantize_int8(tq, ts, tpad, tx.shape, td),
           jcompress.dequantize_int8(jq, js, jpad, jx.shape, jd))
    _equal(tcompress.compression_error(tx), jcompress.compression_error(jx))


@pytest.mark.parametrize("n", [2048, 16_384, 65_536])
def test_ops_match_pallas_interpret(n):
    """Row counts the Pallas kernel accepts (8, 64 and 256 rows): equal
    payload; scales within one ulp, since the kernel multiplies by the
    reciprocal of 127 where the port divides."""

    x = _payload(100 + n, n)
    tq, ts, tpad = tqo.quantize_int8(torch.from_numpy(x), impl="pallas")
    jq, js, jpad = jqo.quantize_int8(jnp.asarray(x), impl="pallas")
    assert tpad == jpad == 0
    _equal(tq, jq)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.4e-7, atol=0)
    # dequantize the same payload and scales through both
    out = tqo.dequantize_int8(tq, torch.from_numpy(np.array(js)), 0, (n,), torch.float32)
    _equal(out, jqo.dequantize_int8(jq, js, 0, (n,), jnp.float32, impl="pallas"))


@pytest.mark.parametrize("n", [25_600, 16_640, 1_000_000])
def test_ops_take_ragged_row_counts(n):
    """100, 65 and 3907 rows: the Pallas kernel rejects each (ROADMAP C2);
    the port takes any count and equals ``compress``."""

    x = _payload(200 + n, n)
    with pytest.raises(AssertionError):
        jqo.quantize_int8(jnp.asarray(x), impl="pallas")
    tq, ts, tpad = tqo.quantize_int8(torch.from_numpy(x))
    jq, js, jpad = jcompress.quantize_int8(jnp.asarray(x))
    assert tpad == jpad
    _equal(tq, jq)
    _equal(ts, js)
    _equal(tqo.dequantize_int8(tq, ts, tpad, (n,), torch.float32),
           jcompress.dequantize_int8(jq, js, jpad, (n,), jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [256, 128, 112, 16])
def test_row_api_equals_the_kv_cache_quantization(width, dtype):
    """The cache's row functions at each model's head_dim (gemma2 256;
    phi4-mini, granite and qwen 128; zamba2 112) and a narrow one, on a
    (B, S, Hk, Dh) entry, into bf16 and fp32."""

    x = (np.random.default_rng(width).standard_normal((2, 9, 3, width)) * 2.0).astype(np.float32)
    jx, tx = _both(x, dtype)
    tq, ts = tattn._quantize_kv(tx)
    jq, js = jattn._quantize_kv(jx)
    _equal(tq, jq)
    _equal(ts, js)
    assert tuple(ts.shape) == (2, 9, 3, 1)
    for name in ("float32", "bfloat16"):
        jd, td = _DTYPES[name]
        _equal(tattn._dequantize_kv(tq, ts, td), jattn._dequantize_kv(jq, js, jd))


def _edge_rows() -> tuple[np.ndarray, np.ndarray]:
    """Rows of 256: zeros (scale 1.0); exact halves at scale 1 and 2 (x /
    scale = k + 0.5, rounded to even); ±absmax (±127).  → (x, expected q)."""

    halves = np.arange(-63, 64, dtype=np.float32) + 0.5            # 127 values
    rows = np.zeros((5, 256), np.float32)
    rows[1, :127], rows[1, 127] = halves, 127.0                     # scale 1
    rows[2, :127], rows[2, 127] = 2 * halves, 254.0                 # scale 2
    rows[3, ::2], rows[3, 1::2] = 5.5, -5.5                         # ±absmax
    rows[4, 0], rows[4, 1:] = -3.0e-3, 1.0e-3                       # tiny values
    want = np.zeros((5, 256), np.int8)
    want[1, :127] = want[2, :127] = np.rint(halves)
    want[1, 127] = want[2, 127] = 127
    want[3, ::2], want[3, 1::2] = 127, -127
    want[4, 0], want[4, 1:] = -127, 42                             # 1/3 of 127
    return rows, want


def test_edge_rows():
    x, want = _edge_rows()
    tq, ts = tqr.quantize_int8_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), want)
    assert ts[0, 0] == 1.0 and ts[1, 0] == 1.0 and ts[2, 0] == 2.0
    np.testing.assert_array_equal(np.rint(np.float32([0.5, 1.5, 2.5, -0.5, -2.5])),
                                  [0.0, 2.0, 2.0, -0.0, -2.0])  # half to even
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    _equal(tq, jq)
    _equal(ts, js)
    _equal(tqr.dequantize_int8_rows(tq, ts), jattn._dequantize_kv(jq, js, jnp.float32))


def _edge_rows_at_end(width: int) -> tuple[np.ndarray, np.ndarray]:
    """``_edge_rows`` at a width under 256 with the special elements in the
    row's last 16-byte chunk (its last 4 columns lie in it in fp32 and
    bf16), as ``chip_smoke.py`` builds them for the vector body: zeros;
    width - 1 halves and the absmax at scale 1 and 2; ±absmax; tiny values
    with the largest last; a NaN, an inf, and a NaN with -inf (-127) in the
    last 4 columns, and that last row again.  → (x, expected q)."""

    n = width - 1
    halves = (np.arange(-63, 64, dtype=np.float32) + 0.5)[-n:]
    x = np.zeros((9, width), np.float32)
    x[1, :n], x[1, n] = halves, 127.0
    x[2, :n], x[2, n] = 2 * halves, 254.0
    x[3, ::2], x[3, 1::2] = 5.5, -5.5
    x[4, :n], x[4, n] = 1.0e-3, -3.0e-3
    x[5, :-4], x[5, -4:] = 0.25, [1.0, np.nan, -3.0, 0.5]
    x[6, :-4], x[6, -4:] = 1.0, [2.0, np.inf, -1.0, 0.0]
    x[7, :-4], x[7, -4:] = 0.25, [np.nan, -np.inf, 4.0, 1.0]
    x[8] = x[7]
    want = np.zeros((9, width), np.int8)
    want[1, :n] = want[2, :n] = np.rint(halves)
    want[1, n] = want[2, n] = 127
    want[3, ::2], want[3, 1::2] = 127, -127
    want[4, :n], want[4, n] = 42, -127
    want[5, -4:] = [1, 0, -3, 0]
    want[7, -4:] = want[8, -4:] = [0, -127, 4, 1]
    return x, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_rows_in_the_last_chunk(dtype):
    """The edge rows at zamba2's width 112, their NaN, inf and exact halves
    in the row's last 8 columns, where the vector body's last lane of a row
    holds them: the expected payload, and equal to the reference."""

    x, want = _edge_rows_at_end(112)
    jx, tx = _both(x, dtype)
    tq, ts = tqr.quantize_int8_rows(tx)
    np.testing.assert_array_equal(tq.numpy(), want)
    np.testing.assert_array_equal(ts[[0, 1, 2, 5, 6, 7, 8], 0].numpy(),
                                  [1.0, 1.0, 2.0, 1.0, np.inf, 1.0, 1.0])
    jq, js = jattn._quantize_kv(jx)
    _equal(tq, jq)
    _equal(ts, js)
    _equal(tqr.dequantize_int8_rows(tq, ts), jattn._dequantize_kv(jq, js, jnp.float32))


def _non_finite_rows(width: int, cols: slice) -> np.ndarray:
    """Rows of 0.25 with a NaN, an inf, and a NaN beside -inf in ``cols``
    (four columns)."""

    x = np.full((3, width), 0.25, np.float32)
    x[0, cols] = [1.0, np.nan, -3.0, 0.5]
    x[1, cols] = [2.0, np.inf, -1.0, 0.0]
    x[2, cols] = [np.nan, -np.inf, 4.0, 1.0]
    return x


def _check_non_finite(x: np.ndarray, cols: slice, dtype: str) -> None:
    jx, tx = _both(x, dtype)
    tq, ts = tqr.quantize_int8_rows(tx)
    jq, js = jattn._quantize_kv(jx)
    _equal(tq, jq)
    _equal(ts, js)
    np.testing.assert_array_equal(ts[:, 0].numpy(), [1.0, np.inf, 1.0])
    np.testing.assert_array_equal(tq[0, cols].numpy(), [1, 0, -3, 0])
    np.testing.assert_array_equal(tq[2, cols].numpy(), [0, -127, 4, 1])
    for name in ("float32", "bfloat16"):
        jd, td = _DTYPES[name]
        out = tqr.dequantize_int8_rows(tq, ts, td)
        _equal(out, jattn._dequantize_kv(jq, js, jd))
        assert not out[0].isnan().any() and out[1].isnan().all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_finite_rows_follow_the_reference(dtype):
    """A NaN makes the row's absmax NaN, which is not > 0: scale 1, and the
    NaN quantizes to 0; -inf beside it clips to -127.  An inf makes the
    scale inf, every element 0, and the dequantized row NaN.  The CUDA
    kernel is held to the same on the card by ``chip_smoke.py``."""

    _check_non_finite(_non_finite_rows(16, slice(0, 4)), slice(0, 4), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_finite_rows_in_the_last_chunk(dtype):
    """The same at zamba2's width 112, the non-finite elements in the row's
    last 4 columns: the vector body's last chunk of the row (8 columns in
    bf16, 4 in fp32)."""

    cols = slice(108, 112)
    _check_non_finite(_non_finite_rows(112, cols), cols, dtype)


# (width, itemsize, row stride in elements, address) → the quantize body
_BODIES = {
    "bf16_16": (16, 2, 16, 0, tqk.VECTOR_BODY),             # 2 chunks, 2 lanes a row
    "bf16_100": (100, 2, 100, 0, tqk.WARP_BODY),            # 200-byte rows
    "bf16_112": (112, 2, 112, 0, tqk.VECTOR_BODY),          # 14 chunks, 16 lanes
    "bf16_112_stride_128": (112, 2, 128, 0, tqk.VECTOR_BODY),
    "bf16_112_stride_116": (112, 2, 116, 0, tqk.WARP_BODY),  # 232-byte stride
    "bf16_112_view_offset_1": (112, 2, 113, 2, tqk.WARP_BODY),
    "bf16_112_address_8": (112, 2, 112, 8, tqk.WARP_BODY),
    "bf16_128": (128, 2, 128, 0, tqk.VECTOR_BODY),
    "bf16_256": (256, 2, 256, 256, tqk.VECTOR_BODY),        # 32 chunks, the warp
    "fp32_100": (100, 4, 100, 0, tqk.VECTOR_BODY),          # 400 bytes: 25 chunks
    "fp32_112": (112, 4, 112, 0, tqk.VECTOR_BODY),          # 28 chunks, 32 lanes
    "fp32_256": (256, 4, 256, 0, tqk.VECTOR_BODY),          # 64 chunks, 2 a lane
    "fp32_256_address_4": (256, 4, 256, 4, tqk.WARP_BODY),
    "fp32_1": (1, 4, 1, 0, tqk.WARP_BODY),
    # rows over 256 elements take the wide body, by width alone
    "fp32_257": (257, 4, 257, 0, tqk.WIDE_BODY),
    "bf16_4096_view_offset_1": (4096, 2, 4097, 2, tqk.WIDE_BODY),
    "fp32_152064": (152_064, 4, 152_064, 0, tqk.WIDE_BODY),
}


@pytest.mark.parametrize("case", list(_BODIES))
def test_quant_body_by_shape(case):
    width, itemsize, stride, ptr, want = _BODIES[case]
    assert tqk.quant_body(width, itemsize, stride, 1 << 20 | ptr) == want


def test_quantize_wrapper_passes_the_chosen_body(monkeypatch):
    """The wrapper hands the C entry ``quant_body``'s choice for the tensor
    it was given, whatever its row count: the vector body for aligned rows
    (a decode step's few as a prefill's many), the warp body for a view one
    element in; the CUDA launch itself is recorded, not made."""

    calls = []
    monkeypatch.setattr(tqk, "_check_rows", lambda *a: None)
    monkeypatch.setattr(tqk, "_launch", lambda symbol, args, *a: calls.append((symbol, args)))
    base = torch.zeros((4096, 128), dtype=torch.bfloat16)
    for x in (base[:, :112], base[:64, :112], base[:, 1:113]):
        tqk.quantize_int8_rows(x)
    want = [tqk.quant_body(112, 2, 128, base.data_ptr())] * 2 + [tqk.WARP_BODY]
    assert want[0] == tqk.VECTOR_BODY
    assert [args[7] for _, args in calls] == want
    assert [args[6] for _, args in calls] == [128] * 3
    assert [args[4] for _, args in calls] == [4096, 64, 4096]
    assert {symbol for symbol, _ in calls} == {"quantize_int8_rows"}


def test_quantize_wrapper_passes_the_wide_body(monkeypatch):
    """Rows wider than 256 reach the C entry as the wide body, aligned or
    not, whatever the row count; the launch is recorded, not made."""

    calls = []
    monkeypatch.setattr(tqk, "_check_rows", lambda *a: None)
    monkeypatch.setattr(tqk, "_launch", lambda symbol, args, *a: calls.append(args))
    base = torch.zeros((3, 3073))
    for x in (base[:, :3072], base[:, 1:], base[:1, :257]):
        tqk.quantize_int8_rows(x)
    assert [args[7] for args in calls] == [tqk.WIDE_BODY] * 3
    assert [(args[4], args[5], args[6]) for args in calls] == [(3, 3072, 3073)] * 2 + [
        (1, 257, 3073)]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; they raise before any build
    on anything else and count no launch."""

    x = torch.ones((4, 256))
    with pytest.raises(errors.Error) as ei:
        tqk.quantize_int8_rows(x)
    assert ei.value.klass == errors.ErrorClass.ERR_ARG
    with pytest.raises(errors.Error) as ei:
        tqk.dequantize_int8_rows(torch.zeros((4, 256), dtype=torch.int8), torch.ones((4, 1)))
    assert ei.value.klass == errors.ErrorClass.ERR_ARG
    assert tqk.LAUNCHES == {"quantize_int8_rows": 0, "dequantize_int8_rows": 0}


def test_kernel_declares_both_c_entry_points():
    src = tqk.SOURCE.read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', src)) == set(tqk.LIBRARY.entries)


def test_argtypes_match_the_c_entry_points():
    """Each entry's ctypes declaration follows its C parameter list, the
    quantize's ``int body`` (after the row stride, before the stream)
    included: ctypes would pass an undeclared argument as a 32-bit int."""

    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    src = tqk.SOURCE.read_text()
    params = {}
    for symbol, argtypes in tqk.ARGTYPES.items():
        decl = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
        params[symbol] = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1) for p in decl.split(",")]
        assert argtypes == [ctype[t] for t, _ in params[symbol]], symbol
    assert params["quantize_int8_rows"][7] == ["int", "body"]


def test_nvcc_flags_keep_ieee_arithmetic():
    """The quant kernel's bit-exactness needs IEEE division and denormals:
    none of the flags that give them up."""

    flags = " ".join(nvcc.NVCC_FLAGS)
    for bad in ("--use_fast_math", "-use_fast_math", "-prec-div=false", "-ftz=true",
                "-prec-sqrt=false"):
        assert bad not in flags


def test_build_key_covers_the_flags(monkeypatch):
    """A change of the flags builds anew: the build directory's hash covers
    them as well as the source."""

    before = tqk.LIBRARY.out_dir()
    monkeypatch.setattr(nvcc, "NVCC_FLAGS", nvcc.NVCC_FLAGS + ("-lineinfo",))
    assert tqk.LIBRARY.out_dir() != before
    assert tqk.LIBRARY.out_dir().parent == before.parent



def test_build_key_covers_included_headers(tmp_path):
    """A change of a header that a source includes from the repository
    builds anew: the flash and ring sources share the tile body's header,
    and both libraries' hashes move with it (on copies, laid out as in the
    repository)."""

    from repro_torch.kernels.flash_attention import kernel as tfk
    from repro_torch.kernels.ring_attention import kernel as trk

    header = tfk.SOURCE.parent / "flash_tile.cuh"
    copies = {}
    for src in (tfk.SOURCE, trk.SOURCE, header):
        dst = tmp_path / src.relative_to(tfk.SOURCE.parents[2])
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
        copies[src.name] = dst
    libs = [nvcc.Library(copies[src.name], name, {})
            for src, name in ((tfk.SOURCE, "flash_attention"), (trk.SOURCE, "ring_attention"))]
    assert all(copies["flash_tile.cuh"] in nvcc.included_files(lib.source) for lib in libs)
    before = [lib.out_dir() for lib in libs]
    copies["flash_tile.cuh"].write_text(copies["flash_tile.cuh"].read_text() + "\n// edit\n")
    after = [lib.out_dir() for lib in libs]
    assert all(a != b and a.parent == b.parent for a, b in zip(after, before))
