"""The port's mixture-of-experts block and MLA attention against the
reference, on CPU tensors, with parameters from the reference's init
(``convert.params_from_jax``) and inputs from a numpy seed.

* ``_sort_dispatch``: the slots and each row's slot id exactly, with many
  ties in a bucket and a capacity that drops rows.
* ``moe`` and ``moe_per_row``: outputs within 2e-5 (fp32) and 2e-2 (bf16),
  the aux metrics within fp32 rounding (the dropped share exactly); tied
  router logits pick the reference's experts; a bf16 k = 6 call gives the
  same bits twice.
* MLA: ``_mla_latents``, ``mla_attention_full`` (keys of nope + rope,
  values of v_head_dim) and the absorbed ``mla_attention_decode`` with its
  in-place cache write, and ``MLACache.init``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import mlp as tmlp

torch.set_num_threads(1)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol)


def _cfgs(arch, dtype="float32", **change):
    return (dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype, **change),
            dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype, **change))


def _moe_params(jcfg, seed=0):
    jp = jmlp.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(jcfg.dtype))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


# -- dispatch ---------------------------------------------------------------------


@pytest.mark.parametrize("n,e,c", [(48, 4, 8), (96, 6, 16), (40, 3, 40), (25, 5, 1)])
def test_sort_dispatch_exact(n, e, c):
    """Buckets drawn from few experts, so every bucket holds many ties and
    (but at c = 40) overflows: the rows that stay are the first c of each
    bucket in row order, and each row's slot id is exact."""

    rng = np.random.default_rng(n + e)
    bucket = rng.integers(0, e, size=(n,), dtype=np.int32)
    rows = rng.standard_normal((n, 8), dtype=np.float32)
    j_slots, j_slot = jmlp._sort_dispatch(jnp.asarray(rows), jnp.asarray(bucket), e, c)
    t_slots, t_slot = tmlp._sort_dispatch(torch.from_numpy(rows), torch.from_numpy(bucket), e, c)
    assert t_slot.dtype == torch.int32
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
    dropped = int((t_slot == e * c).sum())
    assert dropped == max(0, n - sum(min(c, int((bucket == b).sum())) for b in range(e)))
    if c < 40:
        assert dropped > 0


def test_round_up_matches():
    for x, m in [(0, 8), (1, 8), (8, 8), (9, 8), (191, 8), (1280, 8)]:
        assert tmlp._round_up(x, m) == jmlp._round_up(x, m)


# -- the MoE block ----------------------------------------------------------------


def _moe_case(arch, dtype, shape, *, per_row=False, capacity=None, **change):
    jcfg, tcfg = _cfgs(arch, dtype, **change)
    jp, tp = _moe_params(jcfg)
    jx, tx = _x(shape, dtype)
    if per_row:
        jy, jaux = jmlp.moe_per_row(jp, jx, jcfg)
        ty, taux = tmlp.moe_per_row(tp, tx, tcfg)
    else:
        jy, jaux = jmlp.moe(jp, jx, jcfg, capacity=capacity)
        ty, taux = tmlp.moe(tp, tx, tcfg, capacity=capacity)
    return jy, jaux, ty, taux


def _aux_equal(taux, jaux):
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6, atol=1e-7)
    assert float(taux["dropped_fraction"]) == float(jaux["dropped_fraction"])


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch,shape,per_row,capacity", [
    ("grok_1_314b", (2, 12, 64), False, None),
    ("deepseek_v2_236b", (2, 12, 64), False, None),
    ("deepseek_v2_236b", (2, 12, 64), True, None),
    ("grok_1_314b", (3, 10, 64), True, None),
    ("deepseek_v2_236b", (2, 16, 64), False, 2),   # a capacity that drops most rows
])
def test_moe_matches_reference(arch, shape, per_row, capacity, dtype, tol):
    """grok's smoke block (4 experts, top-2, gelu) and deepseek's (8 routed
    and 2 shared experts, top-2, silu), through the global and the per-row
    dispatch: outputs and aux metrics."""

    jy, jaux, ty, taux = _moe_case(arch, dtype, shape, per_row=per_row, capacity=capacity)
    assert ty.shape == tuple(jy.shape) and ty.dtype == getattr(torch, dtype)
    _close(ty, jy, tol)
    _aux_equal(taux, jaux)
    if capacity is not None:
        assert float(taux["dropped_fraction"]) > 0.5


@pytest.mark.parametrize("per_row", [False, True])
def test_moe_tied_router_logits_pick_the_references_experts(per_row):
    """A zero router gives every expert the same probability: ``top_k``
    takes the lowest expert ids first, so every row goes to experts 0 and
    1, which overflow their capacity in row order."""

    jcfg, tcfg = _cfgs("deepseek_v2_236b")
    jp, tp = _moe_params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jx, tx = _x((2, 20, 64), "float32", seed=5)
    fn_j = jmlp.moe_per_row if per_row else jmlp.moe
    fn_t = tmlp.moe_per_row if per_row else tmlp.moe
    jy, jaux = fn_j(jp, jx, jcfg)
    ty, taux = fn_t(tp, tx, tcfg)
    _, _, _, top_e = tmlp._route(tp, tx, tcfg.moe_top_k)
    assert (top_e == torch.arange(tcfg.moe_top_k)).all()
    _close(ty, jy, 2e-5)
    _aux_equal(taux, jaux)
    assert float(taux["dropped_fraction"]) > 0


def test_moe_bf16_top6_same_bits_twice():
    """k = 6 in bf16 (deepseek's top-k): the combine adds each token's six
    rows in a fixed order, so two calls give the same bits, within the
    bf16 limit of the reference."""

    jcfg, tcfg = _cfgs("deepseek_v2_236b", "bfloat16", moe_top_k=6)
    jp, tp = _moe_params(jcfg)
    jx, tx = _x((2, 24, 64), "bfloat16")
    jy, jaux = jmlp.moe(jp, jx, jcfg)
    ty, taux = tmlp.moe(tp, tx, tcfg)
    assert torch.equal(tmlp.moe(tp, tx, tcfg)[0], ty)
    _close(ty, jy, 2e-2)
    _aux_equal(taux, jaux)


def test_moe_grads_match_reference():
    """The gradients of the input and of every expert leaf (the fp32 router
    included) through dispatch, experts and combine."""

    jcfg, tcfg = _cfgs("deepseek_v2_236b")
    jp, tp = _moe_params(jcfg)
    jx, tx = _x((2, 12, 64), "float32")

    def jloss(p, x):
        y, aux = jmlp.moe(p, x, jcfg)
        return jnp.sum(y ** 2) + aux["load_balance_loss"] + aux["router_z_loss"]

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = jax.tree_util.tree_leaves(tp)
    for t in leaves + [tx]:
        t.requires_grad_(True)
    y, aux = tmlp.moe(tp, tx, tcfg)
    loss = (y ** 2).sum() + aux["load_balance_loss"] + aux["router_z_loss"]
    tg = torch.autograd.grad(loss, leaves + [tx])
    for t, j in zip(tg, jax.tree_util.tree_leaves(jg[0]) + [jg[1]]):
        _close(t, j, 1e-4)


def test_moe_init_tree_matches_reference():
    """The fp32 router beside the bf16 experts and the shared experts'
    dense MLP: names, shapes and dtypes of the reference's tree."""

    jcfg, tcfg = _cfgs("deepseek_v2_236b", "bfloat16")
    jp = jmlp.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = tmlp.init_moe(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, stack=(3,))
    flat_j = {jax.tree_util.keystr(k): ((3,) + tuple(v.shape), str(v.dtype))
              for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
              for k, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert flat_t == flat_j
    assert flat_t["['router']"][1] == "float32"


# -- MLA --------------------------------------------------------------------------


def _mla(dtype="float32", seed=0):
    jcfg, tcfg = _cfgs("deepseek_v2_236b", dtype)
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.dtype(dtype))
    return jcfg, tcfg, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_mla_latents_and_full_attention_match(dtype, tol):
    jcfg, tcfg, jp, tp = _mla(dtype)
    jx, tx = _x((2, 10, 64), dtype, seed=3)
    pos = np.arange(10) + 2
    for t, j in zip(tattn._mla_latents(tp, tx, tcfg, torch.from_numpy(pos)),
                    jattn._mla_latents(jp, jx, jcfg, jnp.asarray(pos))):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, tol)
    assert tattn._mla_scale(tcfg) == jattn._mla_scale(jcfg)
    jy, (jckv, jkr) = jattn.mla_attention_full(
        jp, jx, jcfg, jbase.ParallelConfig(), positions=jnp.asarray(pos), return_cache=True)
    ty, (tckv, tkr) = tattn.mla_attention_full(
        tp, tx, tcfg, tbase.ParallelConfig(), positions=torch.from_numpy(pos),
        return_cache=True)
    for t, j in ((ty, jy), (tckv, jckv), (tkr, jkr)):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, tol)


def test_mla_absorbed_decode_matches():
    """Three absorbed decode steps on a 6-token cache with headroom: the
    outputs, and the cache written in place at each position."""

    jcfg, tcfg, jp, tp = _mla()
    b, cap = 2, 9
    rng = np.random.default_rng(4)
    ckv = np.zeros((b, cap, jcfg.kv_lora), np.float32)
    kr = np.zeros((b, cap, jcfg.rope_head_dim), np.float32)
    ckv[:, :6] = rng.standard_normal((b, 6, jcfg.kv_lora))
    kr[:, :6] = rng.standard_normal((b, 6, jcfg.rope_head_dim))
    jckv, jkr = jnp.asarray(ckv), jnp.asarray(kr)
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    for step in range(3):
        pos = 6 + step
        jx, tx = _x((b, 1, 64), "float32", seed=10 + step)
        jy, (jckv, jkr) = jattn.mla_attention_decode(
            jp, jx, jckv, jkr, jnp.asarray(pos, jnp.int32), jcfg, jbase.ParallelConfig())
        ty, (ckv_out, kr_out) = tattn.mla_attention_decode(
            tp, tx, tckv, tkr, torch.tensor(pos, dtype=torch.int32), tcfg,
            tbase.ParallelConfig())
        assert ckv_out is tckv and kr_out is tkr  # written in place
        _close(ty, jy, 2e-5)
        _close(tckv, jckv, 2e-5)
        _close(tkr, jkr, 2e-5)


def test_mla_decode_refuses_per_row_positions():
    """Per-row ``(B,)`` positions, which the MLA decode refused until the
    continuous-batching engine came, are taken now: each row writes at its
    own position, and a position past the latent cache's end is clamped to
    its last slot (``dynamic_update_slice``'s rule) instead of refused;
    outputs and both latent layers are the reference's."""

    jcfg, tcfg, jp, tp = _mla()
    rng = np.random.default_rng(5)
    ckv = rng.standard_normal((2, 4, jcfg.kv_lora), dtype=np.float32)
    kr = rng.standard_normal((2, 4, jcfg.rope_head_dim), dtype=np.float32)
    jx, tx = _x((2, 1, 64), "float32", seed=6)
    pos = np.array([1, 7], np.int32)
    jy, (jckv, jkr) = jattn.mla_attention_decode(
        jp, jx, jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(pos), jcfg,
        jbase.ParallelConfig())
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    ty, _ = tattn.mla_attention_decode(
        tp, tx, tckv, tkr, torch.from_numpy(pos), tcfg, tbase.ParallelConfig())
    _close(ty, jy, 2e-5)
    _close(tckv, jckv, 2e-5)
    _close(tkr, jkr, 2e-5)
    assert not np.array_equal(tckv[1, 3].numpy(), ckv[1, 3])   # the clamped write


def test_mla_cache_init_matches_reference():
    jc = jattn.MLACache.init(3, 2, 7, 32, 8, jnp.float32)
    tc = tattn.MLACache.init(3, 2, 7, 32, 8, torch.float32)
    for name in ("ckv", "k_rope", "pos"):
        t, j = getattr(tc, name), getattr(jc, name)
        assert tuple(t.shape) == tuple(j.shape) and not t.any()
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)


def test_mla_init_tree_matches_reference():
    jcfg, tcfg = _cfgs("deepseek_v2_236b", "bfloat16")
    jp = jattn.init_mla(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = tattn.init_mla(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == \
        {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tp.items()}
