"""The port's flash attention on CPU tensors against the reference: the JAX
Pallas kernel in interpret mode, the jnp oracle and the jnp chunked path.
Inputs are numpy arrays from a seed, handed to both frameworks.

fp32 tolerance 2e-5 and bf16 2e-2, as in ``tests/test_kernels.py``: both
sides compute an exact fp32 softmax, in different summation orders, and
bf16 outputs round once more at the end."""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfk
from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention import ref as jref
from repro_torch.core import errors
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.kernels.quant import kernel as tqk
from repro_torch.kernels.ssd_scan import kernel as tsk

torch.set_num_threads(1)


def _qkv(seed, B, Sq, H, Hk, D, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (
        rng.standard_normal((B, Sq, H, D), dtype=np.float32),
        rng.standard_normal((B, Sk, Hk, D), dtype=np.float32),
        rng.standard_normal((B, Sk, Hk, D), dtype=np.float32),
    )


def _both(arrs, dtype="float32"):
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("B,S,H,Hk,D", [
    (1, 128, 4, 4, 32),      # MHA
    (2, 256, 4, 2, 32),      # GQA
    (1, 128, 4, 1, 64),      # MQA
    (1, 512, 2, 2, 16),      # long-ish, small heads
])
def test_flash_shapes_match_pallas(B, S, H, Hk, D):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, B, S, H, Hk, D))
    out = tfa.flash_attention(tq, tk, tv, causal=True, impl="pallas")
    ref = jfa.flash_attention(jq, jk, jv, causal=True, impl="pallas")
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_flash_dtypes_match_pallas(dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 1, 128, 4, 2, 32), dtype)
    out = tfa.flash_attention(tq, tk, tv, causal=True, impl="pallas")
    ref = jfa.flash_attention(jq, jk, jv, causal=True, impl="pallas")
    assert out.dtype == tq.dtype
    _close(out, ref, tol)


_FEATURES = {
    "window": dict(sliding_window=64),
    "softcap": dict(logit_softcap=50.0),
    "prefix": dict(prefix_len=32),
    "noncausal": dict(causal=False),
}


@pytest.mark.parametrize("feature", sorted(_FEATURES))
def test_flash_features_match_pallas(feature):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 256, 4, 2, 32))
    kw = {"causal": True, **_FEATURES[feature]}
    out = tfa.flash_attention(tq, tk, tv, impl="pallas", **kw)
    ref = jfa.flash_attention(jq, jk, jv, impl="pallas", **kw)
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("sq,sk,causal", [
    (100, 100, True),
    (600, 600, True),
    (600, 600, False),
    (37, 81, False),
    (130, 50, False),
])
def test_flash_ragged_lengths_match_pallas(sq, sk, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 1, sq, 4, 2, 16, Sk=sk))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    ref = jfk.flash_attention_fwd(jq, jk, jv, causal=causal, block_q=128, block_k=128)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("feature", ["window", "prefix", "softcap"])
def test_flash_ragged_features_match_pallas(feature):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 1, 330, 4, 2, 16))
    kw = {"window": dict(sliding_window=100),
          "prefix": dict(prefix_len=40),
          "softcap": dict(logit_softcap=30.0)}[feature]
    out = tfa.flash_attention(tq, tk, tv, causal=True, **kw)
    ref = jfk.flash_attention_fwd(jq, jk, jv, causal=True, block_q=128, block_k=128, **kw)
    _close(out, ref, 2e-5)


def test_flash_prefix_longer_than_a_block_matches_oracle():
    """A prefix-LM prefix longer than one tile (paligemma: 256 > 64-row
    tiles).  Held against the jnp oracle, not the Pallas kernel, whose
    causal tile skip drops prefix columns here (ROADMAP C1)."""

    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(6, 1, 256, 4, 2, 32))
    kw = dict(causal=True, prefix_len=200, sliding_window=64)
    out = tfa.flash_attention(tq, tk, tv, **kw)
    _close(out, jref.mha(jq, jk, jv, **kw), 2e-5)
    chunked = tref.chunked_mha(tq, tk, tv, q_block=64, k_block=64, **kw)
    _close(chunked, jref.mha(jq, jk, jv, **kw), 2e-5)


@pytest.mark.parametrize("feature", sorted(_FEATURES) + ["plain"])
def test_chunked_matches_reference_chunked(feature):
    """``impl="chunked"`` with blocks that divide the sequence runs the
    blockwise loops (ragged shapes fall back to ``mha`` on both sides)."""

    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 2, 256, 4, 2, 16))
    kw = {"causal": True, **_FEATURES.get(feature, {})}
    out = tref.chunked_mha(tq, tk, tv, q_block=64, k_block=64, **kw)
    ref = jref.chunked_mha(jq, jk, jv, q_block=64, k_block=64, **kw)
    _close(out, ref, 2e-5)
    _close(tfa.flash_attention(tq, tk, tv, impl="chunked", **kw),
           jfa.flash_attention(jq, jk, jv, impl="pallas", **kw), 2e-5)


def test_flash_backward_matches_reference_grads():
    """The CPU path is differentiable; its grads equal the reference's."""

    import jax

    arrs = _qkv(3, 1, 64, 2, 2, 16)
    (jq, jk, jv), _ = _both(arrs)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrs)
    tfa.flash_attention(tq, tk, tv, causal=True, logit_softcap=20.0).sum().backward()
    g_ref = jax.grad(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=True, logit_softcap=20.0).sum(),
        argnums=(0, 1, 2),
    )(jq, jk, jv)
    for t, j in zip((tq, tk, tv), g_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=2e-4, rtol=2e-4)


def _qkv_mla(seed, B, S, H, Hk, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, S, Hk, D), dtype=np.float32),
            rng.standard_normal((B, S, Hk, Dv), dtype=np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,H,Hk,D,Dv,kw", [
    (2, 48, 4, 4, 24, 16, dict(causal=True, scale=24 ** -0.5)),   # deepseek smoke's MLA
    (1, 40, 4, 2, 192, 128, dict(causal=True, scale=192 ** -0.5)),  # MLA widths, GQA
    (1, 33, 2, 1, 64, 8, dict(causal=False, logit_softcap=30.0)),
])
def test_flash_narrower_values_match_reference(B, S, H, Hk, D, Dv, kw, dtype, tol):
    """Values narrower than the keys (MLA: keys of nope + rope, values of
    v_head_dim): the port's plain attention and its public wrapper give
    the reference's (b, s, h, dv) output."""

    (jq, jk, jv), (tq, tk, tv) = _both(_qkv_mla(20, B, S, H, Hk, D, Dv), dtype)
    want = jfa.flash_attention(jq, jk, jv, impl="ref", **kw)
    assert want.shape == (B, S, H, Dv)
    _close(tref.mha(tq, tk, tv, **kw), jref.mha(jq, jk, jv, **kw), tol)
    out = tfa.flash_attention(tq, tk, tv, **kw)
    assert out.shape == (B, S, H, Dv) and out.dtype == tq.dtype
    _close(out, want, tol)


def test_flash_narrower_values_backward_matches_reference():
    """The grads of q, k and the narrower v equal the reference's."""

    import jax

    arrs = _qkv_mla(21, 2, 32, 4, 2, 24, 16)
    (jq, jk, jv), _ = _both(arrs)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrs)
    kw = dict(causal=True, scale=24 ** -0.5)
    tfa.flash_attention(tq, tk, tv, **kw).square().sum().backward()
    g_ref = jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, impl="ref", **kw) ** 2),
        argnums=(0, 1, 2),
    )(jq, jk, jv)
    for t, j in zip((tq, tk, tv), g_ref):
        assert t.grad.shape == j.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=2e-4, rtol=2e-4)


def test_chunked_and_pallas_need_equal_widths_as_the_reference():
    """ROADMAP C14, pinned: the reference's chunked path reshapes v with
    q's width and raises on narrower values, and its Pallas kernel (in
    interpret mode) returns an output of q's width, not v's; so the
    reference's MLA runs only with ``attn_impl="ref"``.  The port's chunked
    path raises on whole blocks as the reference's does, and falls back to
    the plain version on ragged ones, as both do."""

    (jq, jk, jv), (tq, tk, tv) = _both(_qkv_mla(22, 1, 64, 2, 2, 24, 16))
    with pytest.raises(TypeError):
        jref.chunked_mha(jq, jk, jv, q_block=32, k_block=32)
    with pytest.raises(RuntimeError):
        tref.chunked_mha(tq, tk, tv, q_block=32, k_block=32)
    assert jfa.flash_attention(jq, jk, jv, impl="pallas").shape[-1] == 24
    _close(tref.chunked_mha(tq, tk, tv, q_block=48, k_block=48),
           jref.chunked_mha(jq, jk, jv, q_block=48, k_block=48), 2e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; it raises before any
    build on anything else."""

    _, (tq, tk, tv) = _both(_qkv(8, 1, 16, 2, 1, 16))
    with pytest.raises(errors.Error) as ei:
        tfk.flash_attention_fwd(tq, tk, tv)
    assert ei.value.klass == errors.ErrorClass.ERR_ARG
    assert tfk.LAUNCHES == 0


def test_kernel_argtypes_match_the_c_signature():
    """The ctypes declaration of each kernel's C entry points (flash
    attention, SSD scan, int8 quantize and dequantize) covers every
    parameter, so no pointer or stride is cut to 32 bits."""

    want = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong, "float": ctypes.c_float}
    for lib in (tfk.LIBRARY, tsk.LIBRARY, tqk.LIBRARY):
        src = lib.source.read_text()
        assert lib.entries, lib.name
        for symbol, argtypes in lib.entries.items():
            sig = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', src, re.S).group(1)
            params = [p.strip() for p in sig.split(",")]
            assert len(params) == len(argtypes), symbol
            for decl, ctype in zip(params, argtypes):
                base = decl.rsplit(" ", 1)[0].replace("const ", "").strip()
                assert ctype is want[base], (symbol, decl, ctype)


# ---------------------------------------------------------------------------
# The limit of one bf16 pass of P.  On the card, bf16 inputs run the
# tensor-core body: an fp32 online softmax over key tiles whose P is rounded
# to bf16 once for the P V product (l is summed from the fp32 P).  Each p
# moves by at most 2^-8 p, so an output by at most 2^-8 (sum_k p_k |v_k|) / l:
# the plain version run on |v|.  chip_smoke.py holds the kernel within
# atol + rtol |plain| + 2^-8 plain(|v|); here that arithmetic, emulated in
# plain torch, is held within the same limit.
# ---------------------------------------------------------------------------

P_BF16 = 2.0 ** -8
FLASH_ATOL, BF16_RTOL = 1e-4, 2.0 ** -8  # chip_smoke.py's limits of a bf16 case


def _bf16_values(arrs):
    """fp32 tensors holding bf16 values, as the kernel reads them."""

    return [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrs]


def _flash_one_bf16_pass(q, k, v, *, block_k, causal=True, sliding_window=None,
                         prefix_len=None, logit_softcap=None, scale=None):
    """The tensor-core body's arithmetic: key tiles of ``block_k``, fp32
    logits and online softmax, P rounded to bf16 for P V; the output
    rounded to bf16."""

    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    k, v = k.repeat_interleave(h // hk, dim=2), v.repeat_interleave(h // hk, dim=2)
    mask = tref.attention_mask(sq, sk, causal=causal, sliding_window=sliding_window,
                               prefix_len=prefix_len)
    m = torch.full((b, h, sq, 1), tref.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, block_k):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, k0:k0 + block_k]) * scale
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = torch.where(mask[:, k0:k0 + block_k], s, tref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(),
                                        v[:, k0:k0 + block_k])
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).bfloat16().float()


_P_CASES = {
    # gemma2's features at a small size: softcap, window, prefix, GQA
    "softcap_window_prefix_gqa": (dict(B=2, Sq=256, H=4, Hk=2, D=64), 64,
                                  dict(causal=True, sliding_window=96, prefix_len=40,
                                       logit_softcap=50.0)),
    # not causal, a ragged last key tile, zamba2's head width on the 128 tile
    "full_ragged_d112": (dict(B=1, Sq=200, H=2, Hk=2, D=112), 128, dict(causal=False)),
}


def _p_case(case):
    """(|emulated - plain|, old limit, limit with the bf16-P term)."""

    shape, block_k, kw = _P_CASES[case]
    q, k, v = _bf16_values(_qkv(30 + sorted(_P_CASES).index(case), **shape))
    got = _flash_one_bf16_pass(q, k, v, block_k=block_k, **kw)
    plain = tref.mha(q, k, v, **kw)
    abs_v = tref.mha(q, k, v.abs(), **kw)
    old = FLASH_ATOL + BF16_RTOL * plain.abs()
    return (got - plain).abs(), old, old + P_BF16 * abs_v


@pytest.mark.parametrize("case", sorted(_P_CASES))
def test_one_bf16_pass_of_p_within_the_derived_limit(case):
    diff, _, limit = _p_case(case)
    assert bool((diff <= limit).all()), (diff / limit).max().item()


def test_one_bf16_pass_of_p_breaks_the_old_limit():
    """Without the 2^-8 plain(|v|) term the limit does not hold: the term is
    needed, not slack."""

    assert any(bool((diff > old).any()) for diff, old, _ in map(_p_case, sorted(_P_CASES)))


def test_bf16_copy_layout_check():
    """The tensor-core body copies bf16 rows 16 bytes at a time: the
    wrappers take innermost stride 1, a 16-byte-aligned base and other
    strides in multiples of 8 elements (dimensions of length 1 aside), and
    raise ERR_ARG on anything else."""

    x = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16)
    for ok in (x, x.transpose(1, 2), x[:, :, :1], x[..., :56], x[:1, :, 2:]):
        tfk.check_copyable("flash kernel", "q", ok)
    for bad in (x[..., 1:], x.transpose(2, 3), torch.zeros((2, 16, 4, 60), dtype=torch.bfloat16)):
        with pytest.raises(errors.Error) as ei:
            tfk.check_copyable("flash kernel", "q", bad)
        assert ei.value.klass == errors.ErrorClass.ERR_ARG
