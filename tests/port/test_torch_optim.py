"""The port's optimizer against the reference on the CPU: one AdamW step
from the same parameters, gradients and moments (fp32 and bf16 moments),
global-norm clipping, and the learning-rate schedules.

The update runs the reference's operations in the same order in fp32, so
parameters agree within 1e-6; a bf16 moment is the same fp32 value rounded
once, so within one bf16 ulp of the reference's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import errors as terrors

torch.set_num_threads(1)


def _tree(rng, scale=1.0):
    return {
        "w": (scale * rng.standard_normal((12, 7))).astype(np.float32),
        "layers": {"a": (scale * rng.standard_normal((3, 5, 4))).astype(np.float32),
                   "b": (scale * rng.standard_normal((3, 4))).astype(np.float32)},
        "s": np.asarray(scale * rng.standard_normal(), np.float32),  # 0-d: no decay
    }


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x.float() if x.dtype == torch.bfloat16
                                                       else x), tree)


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (the spacing of bf16 values there)."""

    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_step_matches_reference(moment_dtype):
    """Step 2 from the reference's state after step 1, with a cosine
    schedule: parameters within 1e-6, moments exact in fp32 and within one
    bf16 ulp in bf16."""

    rng = np.random.default_rng(0)
    params, g1, g2 = _tree(rng), _tree(rng, 0.3), _tree(rng, 0.3)
    kw = dict(weight_decay=0.1, moment_dtype=moment_dtype)
    jopt = joptim.AdamW(lr=joptim.cosine_warmup(1e-2, 3, 10), **kw)
    topt = toptim.AdamW(lr=toptim.cosine_warmup(1e-2, 3, 10), **kw)
    jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g1), jopt.init(
        jax.tree_util.tree_map(jnp.asarray, params)), jax.tree_util.tree_map(jnp.asarray, params))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    jp2, js2 = jopt.update(jax.tree_util.tree_map(jnp.asarray, g2), js, jp)
    tp2, ts2 = topt.update(params_from_jax(g2, "cpu"), ts, tp)
    assert int(ts2.step) == int(js2.step) == 2
    for t, j in zip(jax.tree_util.tree_leaves(_np(tp2)), jax.tree_util.tree_leaves(jp2)):
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-6, rtol=0)
    for moment in ("mu", "nu"):
        tm = jax.tree_util.tree_leaves(_np(getattr(ts2, moment)))
        jm = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(getattr(js2, moment))]
        for t, j in zip(tm, jm):
            if moment_dtype == "float32":
                np.testing.assert_allclose(t, j, atol=1e-7, rtol=1e-6)
            else:
                assert np.all(np.abs(t - j) <= _ulp_bf16(j)), moment


def test_adamw_init_and_int8_moments():
    params = params_from_jax(_tree(np.random.default_rng(1)), "cpu")
    state = toptim.AdamW(moment_dtype="bfloat16").init(params)
    assert int(state.step) == 0 and state.mu["w"].dtype == torch.bfloat16
    assert all(float(x.abs().sum()) == 0.0 for x in (state.mu["w"], state.nu["layers"]["a"]))
    with pytest.raises(terrors.Error) as ei:
        toptim.AdamW(moment_dtype="int8")
    assert ei.value.klass == terrors.ErrorClass.ERR_UNSUPPORTED_OPERATION
    assert "A13" in str(ei.value)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped (0.5) and unclipped (1e3) cases: the norm and every leaf."""

    tree = _tree(np.random.default_rng(2))
    jc, jn = joptim.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    tc, tn = toptim.clip_by_global_norm(params_from_jax(tree, "cpu"), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(toptim.global_norm(tc)),
                               float(joptim.global_norm(jc)), rtol=1e-6)
    for t, j in zip(jax.tree_util.tree_leaves(_np(tc)), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 100, 130])
def test_schedules_match_reference(step):
    """cosine_warmup at 0, inside and at the end of the warmup, mid decay
    and at and past the end; linear_warmup and constant beside it."""

    pairs = [
        (joptim.cosine_warmup(3e-4, 10, 100), toptim.cosine_warmup(3e-4, 10, 100)),
        (joptim.cosine_warmup(1e-3, 10, 100, 0.0), toptim.cosine_warmup(1e-3, 10, 100, 0.0)),
        (joptim.linear_warmup(3e-4, 10), toptim.linear_warmup(3e-4, 10)),
        (joptim.constant(2e-4), toptim.constant(2e-4)),
    ]
    for jfn, tfn in pairs:
        j = float(jfn(jnp.asarray(step, jnp.int32)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            t = tfn(arg)
            assert t.dtype == torch.float32
            np.testing.assert_allclose(float(t), j, rtol=1e-6, atol=0)
