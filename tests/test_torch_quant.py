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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_finite_rows_follow_the_reference(dtype):
    """A NaN makes the row's absmax NaN, which is not > 0: scale 1, and the
    NaN quantizes to 0.  An inf makes the scale inf, every element 0, and
    the dequantized row NaN.  The CUDA kernel is held to the same on the
    card by ``chip_smoke.py``."""

    x = np.full((3, 16), 0.25, np.float32)
    x[0, :4] = [1.0, np.nan, -3.0, 0.5]
    x[1, :4] = [2.0, np.inf, -1.0, 0.0]
    x[2, :4] = [np.nan, -np.inf, 4.0, 1.0]
    jx, tx = _both(x, dtype)
    tq, ts = tqr.quantize_int8_rows(tx)
    jq, js = jattn._quantize_kv(jx)
    _equal(tq, jq)
    _equal(ts, js)
    np.testing.assert_array_equal(ts[:, 0].numpy(), [1.0, np.inf, 1.0])
    np.testing.assert_array_equal(tq[0, :4].numpy(), [1, 0, -3, 0])
    for name in ("float32", "bfloat16"):
        jd, td = _DTYPES[name]
        out = tqr.dequantize_int8_rows(tq, ts, td)
        _equal(out, jattn._dequantize_kv(jq, js, jd))
        assert not out[0].isnan().any() and out[1].isnan().all()


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
