"""The port's models against the reference, on CPU tensors: the common
layers, then ``prefill`` (logits and every cache leaf) and two ``decode``
steps of the dense, MoE (grok-1; deepseek-v2 with MLA and a leading dense
layer), VLM, SSM, hybrid and encoder-decoder families, with parameters
converted from the reference's init.

The models run in fp32.  Logits agree within 1e-4: the two frameworks sum
the same products in different orders, and those rounding differences grow
through the layers and the vocab-wide head."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import common as jcommon
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon

torch.set_num_threads(1)

TOL = 1e-4


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol
    )


def test_rms_norm_rope_gelu_softcap_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    scale = rng.standard_normal((16,), dtype=np.float32) * 0.1
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tcommon.rms_norm(tx, torch.from_numpy(scale), 1e-6),
           jcommon.rms_norm(jx, jnp.asarray(scale), 1e-6), 1e-6)
    pos = np.arange(5) + 7
    _close(tcommon.rope(tx, torch.from_numpy(pos), theta=10_000.0),
           jcommon.rope(jx, jnp.asarray(pos), theta=10_000.0), 1e-5)
    _close(tcommon.rope(tx, torch.from_numpy(pos), theta=10_000.0, rope_dim=8),
           jcommon.rope(jx, jnp.asarray(pos), theta=10_000.0, rope_dim=8), 1e-5)
    for name in ("gelu", "gelu_tanh", "silu", "relu"):
        _close(tcommon.activation(name)(tx * 3), jcommon.activation(name)(jx * 3), 1e-6)
    _close(tcommon.softcap(tx * 80, 50.0), jcommon.softcap(jx * 80, 50.0), 1e-5)
    labels = rng.integers(0, 16, size=(2, 5, 3))
    _close(tcommon.cross_entropy(tx, torch.from_numpy(labels), softcap_val=30.0),
           jcommon.cross_entropy(jx, jnp.asarray(labels), softcap_val=30.0), 1e-5)


def _models(arch):
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    jb, tb = japi.build(jcfg), tapi.build(tcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jb, jparams, tcfg, tb, tparams


def _leaves(cache, prefix=""):
    """Every leaf of a cache (dicts of KVCache, SSMCache, HybridCache) by
    its path; ``None`` leaves included."""

    if isinstance(cache, dict):
        items = sorted(cache.items())
    elif dataclasses.is_dataclass(cache):
        items = [(f.name, getattr(cache, f.name)) for f in dataclasses.fields(cache)]
    else:
        return {prefix: cache}
    out = {}
    for name, sub in items:
        out.update(_leaves(sub, f"{prefix}.{name}" if prefix else name))
    return out


def _same_cache(tcache, jcache):
    """Every leaf: same shape and dtype; an int8 payload within one step
    (JAX quantizes inside a compiled step, where XLA multiplies by the
    reciprocal of 127, and the two frameworks' fp32 K/V differ in the last
    bits), every other leaf within ``TOL``; ``pos`` exactly."""

    t, j = _leaves(tcache), _leaves(jcache)
    assert t.keys() == j.keys()
    for key in t:
        if j[key] is None:
            assert t[key] is None, key
            continue
        assert tuple(t[key].shape) == tuple(j[key].shape), key
        assert str(t[key].dtype).removeprefix("torch.") == str(j[key].dtype), key
        if t[key].dtype == torch.int8:
            diff = np.abs(t[key].numpy().astype(np.int32) - np.asarray(j[key], np.int32))
            assert diff.max() <= 1, key
        elif key.endswith("pos"):
            assert int(t[key]) == int(j[key]), key
        else:
            _close(t[key], j[key])


def _batch(cfg, seq, seed, enc_len=None):
    """Tokens (2, seq), and the family's stub inputs: the VLM's 2 x
    ``num_image_tokens`` image embeddings of 1152, the encoder-decoder's
    2 x ``enc_len`` frames of d_model; as numpy, then as each package's."""

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(2, seq), dtype=np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal((2, cfg.num_image_tokens, 1152),
                                                    dtype=np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, enc_len or seq, cfg.d_model), dtype=np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _prefill_and_decode_match(arch, seq, kv_cache_dtype="bfloat16", enc_len=None):
    jcfg, jb, jparams, tcfg, tb, tparams = _models(arch)
    jbatch, tbatch = _batch(jcfg, seq, 1, enc_len)
    jpc = dataclasses.replace(jbase.ParallelConfig(), kv_cache_dtype=kv_cache_dtype)
    tpc = dataclasses.replace(tbase.ParallelConfig(), kv_cache_dtype=kv_cache_dtype)
    jl, jc = jb.prefill(jparams, jbatch, jpc, extra_capacity=3)
    with torch.inference_mode():
        tl, tc = tb.prefill(tparams, tbatch, tpc, extra_capacity=3)
    _close(tl, jl)
    _same_cache(tc, jc)
    for _ in range(2):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jb.decode(jparams, jc, jnp.asarray(tok), jpc)
        with torch.inference_mode():
            tl, tc = tb.decode(tparams, tc, torch.from_numpy(tok), tpc)
        _close(tl, jl)
        _same_cache(tc, jc)


@pytest.mark.parametrize("arch,seq", [
    ("gemma2_9b", 12), ("phi4_mini_3_8b", 10), ("mamba2_2_7b", 12), ("zamba2_7b", 12),
])
def test_prefill_and_decode_match(arch, seq):
    """gemma2's smoke window is 8, so a 12-token prompt fills the ring
    buffer of its local layers and decode wraps it.  The SSM caches
    (``SSMCache``, and ``HybridCache.attn`` / ``.ssm``) are held leaf by
    leaf: conv window, fp32 state, KV and ``pos``."""

    _prefill_and_decode_match(arch, seq)


@pytest.mark.parametrize("arch,seq", [
    ("gemma2_9b", 12), ("phi4_mini_3_8b", 10), ("zamba2_7b", 12),
])
def test_int8_cache_prefill_and_decode_match(arch, seq):
    """``kv_cache_dtype="int8"``: gemma2's ring buffer wrapped, phi4-mini
    with no window, zamba2's stacked shared-attention cache.  The int8
    payload and its fp32 scales, the padded headroom's included (scale 1.0),
    are held leaf by leaf after the prefill and each decode step."""

    _prefill_and_decode_match(arch, seq, "int8")


@pytest.mark.parametrize("arch,seq,enc_len,kv", [
    ("paligemma_3b", 10, None, "bfloat16"), ("paligemma_3b", 10, None, "int8"),
    ("seamless_m4t_large_v2", 10, 13, "bfloat16"), ("seamless_m4t_large_v2", 7, 7, "int8"),
])
def test_vlm_and_encdec_prefill_and_decode_match(arch, seq, enc_len, kv):
    """paligemma: 4 image tokens before the text, a bidirectional prefix,
    and the cache holds them (decode is the dense step).  seamless: 13
    frames into the encoder (non-causal), the decoder's self-attention
    cache and the stacked cross-attention K/V (``EncDecCache``) leaf by
    leaf.  With ``kv_cache_dtype="int8"`` the VLM quantizes its cache as the
    dense family does; the encoder-decoder's cache stays in the model's
    dtype with no scales in both packages (ROADMAP C11)."""

    _prefill_and_decode_match(arch, seq, kv, enc_len)


@pytest.mark.parametrize("quantized", [False, True])
def test_kv_cache_init_matches_reference(quantized):
    """``KVCache.init``: the reference's leaves, shapes, dtypes and zeros."""

    from repro.models.attention import KVCache as JKV
    from repro_torch.models.attention import KVCache as TKV

    jc = JKV.init(3, 2, 7, 2, 16, dtype=jnp.float32, quantized=quantized)
    tc = TKV.init(3, 2, 7, 2, 16, dtype=torch.float32, quantized=quantized)
    _same_cache(tc, jc)
    assert not any(t.any() for t in _leaves(tc).values() if t is not None)


def test_loss_matches():
    jcfg, jb, jparams, tcfg, tb, tparams = _models("gemma2_9b")
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size, size=(2, 12), dtype=np.int32)
    jloss, _ = jb.loss(jparams, {"tokens": jnp.asarray(toks)}, jbase.ParallelConfig())
    tloss, _ = tb.loss(tparams, {"tokens": torch.from_numpy(toks)}, tbase.ParallelConfig())
    _close(tloss, jloss)


@pytest.mark.parametrize("arch,enc_len", [("paligemma_3b", None),
                                           ("seamless_m4t_large_v2", 9)])
def test_vlm_and_encdec_loss_match(arch, enc_len):
    """The VLM's loss covers the text only (its logits from the image
    prefix on); the encoder-decoder's reads 9 frames against 12 tokens."""

    jcfg, jb, jparams, tcfg, tb, tparams = _models(arch)
    jbatch, tbatch = _batch(jcfg, 12, 2, enc_len)
    jloss, _ = jb.loss(jparams, jbatch, jbase.ParallelConfig())
    tloss, _ = tb.loss(tparams, tbatch, tbase.ParallelConfig())
    _close(tloss, jloss)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_7b"])
def test_ssm_loss_matches(arch):
    jcfg, jb, jparams, tcfg, tb, tparams = _models(arch)
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size, size=(2, 12), dtype=np.int32)
    jloss, _ = jb.loss(jparams, {"tokens": jnp.asarray(toks)}, jbase.ParallelConfig())
    tloss, _ = tb.loss(tparams, {"tokens": torch.from_numpy(toks)}, tbase.ParallelConfig())
    _close(tloss, jloss)


def test_init_matches_reference_tree():
    """The port's own random init has the reference's tree: names, shapes
    and dtypes (the values differ: torch and jax draw different numbers)."""

    for arch in ("gemma2_9b", "qwen1_5_32b", "mamba2_2_7b", "zamba2_7b"):
        _same_init_tree(arch)


def _same_init_tree(arch):
    jcfg = jbase.get_smoke_config(arch)
    jparams = japi.build(jcfg).init(jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tparams = tapi.build(tbase.get_smoke_config(arch)).init(gen)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = {
        jax.tree_util.keystr(p): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
        for p, t in jax.tree_util.tree_flatten_with_path(tparams)[0]
    }
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        key = jax.tree_util.keystr(path)
        assert flat_t[key] == (tuple(leaf.shape), str(leaf.dtype)), key


@pytest.mark.parametrize("arch", ["paligemma_3b", "seamless_m4t_large_v2"])
def test_vlm_and_encdec_init_trees_match_reference(arch):
    """paligemma's ``mm_proj`` (1152, d_model) beside the dense trunk;
    seamless's ``encoder`` and ``decoder`` stacks (a leading layer
    dimension, as the reference's ``jax.vmap`` init gives), ``enc_norm``
    and the decoder's ``ln_cross`` and ``cross`` leaves."""

    _same_init_tree(arch)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_7b"])
def test_params_from_jax_carries_the_ssm_trees(arch):
    """The converted reference tree has the port's own tree: the stacked
    ``layers``, the hybrid's ``(groups, attn_every, …)`` ``ssm_layers``,
    ``ssm_tail`` and the unstacked ``shared_attn``."""

    _converted_is_own_tree(arch)


@pytest.mark.parametrize("arch", ["paligemma_3b", "seamless_m4t_large_v2"])
def test_params_from_jax_carries_the_vlm_and_encdec_trees(arch):
    """``mm_proj`` and the ``encoder``/``decoder`` stacks convert to the
    port's own tree."""

    _converted_is_own_tree(arch)


def _converted_is_own_tree(arch):
    *_, tb, tparams = _models(arch)
    own = tb.init(torch.Generator().manual_seed(0))
    flat = {jax.tree_util.keystr(p): (tuple(t.shape), t.dtype)
            for p, t in jax.tree_util.tree_flatten_with_path(own)[0]}
    conv = {jax.tree_util.keystr(p): (tuple(t.shape), t.dtype)
            for p, t in jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert conv == flat


def test_other_families_raise_typed():
    """Every family of the reference builds; a name that is none of them
    raises typed."""

    from repro_torch.core import errors

    cfg = dataclasses.replace(tbase.get_smoke_config("gemma2_9b"), family="diffusion")
    with pytest.raises(errors.Error) as ei:
        tapi.build(cfg)
    assert ei.value.klass == errors.ErrorClass.ERR_UNSUPPORTED_OPERATION


@pytest.mark.parametrize("change", [
    dict(num_experts=4, moe_top_k=2, moe_d_ff=32),
    dict(mla=True, q_lora=16, kv_lora=16, rope_head_dim=8, nope_head_dim=8, v_head_dim=8),
    dict(first_dense_layers=1, num_layers=3),
])
def test_vlm_trunk_still_refuses_moe_and_mla(change):
    """The trunk no longer refuses experts, MLA or leading dense layers
    (ROADMAP A12 items 3-4, ported): on the VLM's trunk each gives the
    reference's init tree and loss."""

    jcfg = dataclasses.replace(jbase.get_smoke_config("paligemma_3b"), dtype="float32",
                               **change)
    tcfg = dataclasses.replace(tbase.get_smoke_config("paligemma_3b"), dtype="float32",
                               **change)
    jb, tb = japi.build(jcfg), tapi.build(tcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    own = tb.init(torch.Generator().manual_seed(0))
    assert {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(own)[0]} == \
        {jax.tree_util.keystr(k): tuple(v.shape)
         for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    jbatch, tbatch = _batch(jcfg, 8, 2)
    jloss, _ = jb.loss(jparams, jbatch, jbase.ParallelConfig())
    tloss, _ = tb.loss(tparams, tbatch, tbase.ParallelConfig())
    _close(tloss, jloss)


# -- MoE (grok-1) and MLA + MoE (deepseek-v2) -------------------------------------

_MOE = ("grok_1_314b", "deepseek_v2_236b")


@pytest.mark.parametrize("arch,seq,kv", [
    ("grok_1_314b", 12, "bfloat16"), ("grok_1_314b", 10, "int8"),
    ("deepseek_v2_236b", 12, "bfloat16"),
])
def test_moe_prefill_and_decode_match(arch, seq, kv):
    """grok's GQA cache (int8 too) and deepseek's latent caches: the
    stacked ``layer`` ``MLACache`` and the leading dense block's
    ``dense_0``, leaf by leaf after the prefill and each decode step."""

    _prefill_and_decode_match(arch, seq, kv)


def test_mla_cache_ignores_int8_as_the_reference():
    """ROADMAP C13, pinned: the reference's MLA cache has no int8 form, so
    ``kv_cache_dtype="int8"`` leaves deepseek's latent cache in the model's
    dtype; both packages' int8 prefills give the bf16 setting's caches."""

    jcfg, jb, jparams, tcfg, tb, tparams = _models("deepseek_v2_236b")
    jbatch, tbatch = _batch(jcfg, 10, 3)
    caches = {}
    for kv in ("bfloat16", "int8"):
        jpc = dataclasses.replace(jbase.ParallelConfig(), kv_cache_dtype=kv)
        tpc = dataclasses.replace(tbase.ParallelConfig(), kv_cache_dtype=kv)
        _, jc = jb.prefill(jparams, jbatch, jpc, extra_capacity=2)
        with torch.inference_mode():
            _, tc = tb.prefill(tparams, tbatch, tpc, extra_capacity=2)
        _same_cache(tc, jc)
        caches[kv] = _leaves(tc)
        assert set(tc) == {"layer", "dense_0"}
        assert tb.init_cache(tpc, 2, 12)["layer"].ckv.dtype == torch.float32
    assert caches["int8"].keys() == caches["bfloat16"].keys()
    for key, t in caches["int8"].items():
        assert torch.equal(t, caches["bfloat16"][key]), key


@pytest.mark.parametrize("arch", _MOE)
def test_moe_forward_logits_and_aux_match(arch):
    """``lm_forward``: the logits, and the aux metrics summed over the
    stacked units (deepseek's dense_0 adds none)."""

    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr

    jcfg, jb, jparams, tcfg, tb, tparams = _models(arch)
    jbatch, tbatch = _batch(jcfg, 12, 4)
    jl, jaux = jtr.lm_forward(jparams, jbatch, jcfg, jbase.ParallelConfig())
    tl, taux = ttr.lm_forward(tparams, tbatch, tcfg, tbase.ParallelConfig())
    _close(tl, jl)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)
    assert float(taux["load_balance_loss"]) > 0


@pytest.mark.parametrize("arch", _MOE)
def test_moe_loss_and_grads_match(arch):
    """The loss adds 1e-2 load balance + 1e-3 router z; the metrics carry
    the aux terms; every gradient leaf (the fp32 routers and deepseek's
    dense_0 included) within 1e-4."""

    from repro_torch.core.futures import flatten

    jcfg, jb, jparams, tcfg, tb, tparams = _models(arch)
    jbatch, tbatch = _batch(jcfg, 12, 5)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jb.loss(p, jbatch, jbase.ParallelConfig()), has_aux=True)(jparams)
    leaves, treedef = flatten(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tm = tb.loss(tparams, tbatch, tbase.ParallelConfig())
    _close(tloss.detach(), jloss)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5)
    tg = torch.autograd.grad(tloss, leaves)
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tparams), tg))[0]
    assert len(tflat) == len(jflat)
    for k, g in tflat:
        _close(g, jflat[jax.tree_util.keystr(k)])


@pytest.mark.parametrize("arch", _MOE)
def test_moe_init_trees_match_reference(arch):
    """grok's stacked experts and untied head; deepseek's stacked MLA and
    MoE units beside the unstacked ``dense_0`` block."""

    _same_init_tree(arch)
    _converted_is_own_tree(arch)


def test_build_accepts_every_architecture():
    """``api.build`` accepts every arch of ``ARCHITECTURES`` (full and
    smoke configs), and each smoke model initialises."""

    for arch in tbase.ARCHITECTURES:
        assert tapi.build(tbase.get_config(arch)).cfg.name == arch
        bundle = tapi.build(tbase.get_smoke_config(arch))
        assert bundle.init(torch.Generator().manual_seed(0))
