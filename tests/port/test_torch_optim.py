"""The port's optimizer against the reference on the CPU: one AdamW step
from the same parameters, gradients and moments (fp32, bf16 and int8
moments), the int8 moments' store and read, global-norm clipping, and the
learning-rate schedules.

The update runs the reference's operations in the same order in fp32, so
parameters agree within 1e-6; a bf16 moment is the same fp32 value rounded
once, so within one bf16 ulp of the reference's.  An int8 moment is the
same fp32 value quantized: the store and the read alone are bit for bit
the reference's run eagerly (both divide as IEEE divisions); after an
update, whose fp32 moment may differ from the reference's in its last bit,
a scale is held within one fp32 ulp and a payload within 1."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim import adamw as jadamw
from repro_torch import optim as toptim
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core.futures import flatten
from repro_torch.optim import adamw as tadamw

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


def _ulp_f32(x: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_step_matches_reference(moment_dtype):
    """Step 2 from the reference's state after step 1, with a cosine
    schedule: parameters within 1e-6, moments exact in fp32 and within one
    bf16 ulp in bf16; int8 scales within one fp32 ulp and payloads within
    1 (the fp32 moment before the store may differ in its last bit)."""

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
        if moment_dtype == "int8":
            # q, scale per leaf, dict keys sorted, in both packages
            tm = [x.numpy() for x in flatten(getattr(ts2, moment))[0]]
            jm = [np.asarray(x) for x in jax.tree_util.tree_leaves(getattr(js2, moment))]
            assert len(tm) == len(jm) == 8
            for t, j in zip(tm, jm):
                assert t.dtype == j.dtype and t.shape == j.shape
                if t.dtype == np.int8:
                    assert np.all(np.abs(t.astype(np.int32) - j) <= 1), moment
                else:
                    assert np.all(np.abs(t - j) <= _ulp_f32(j)), moment
            continue
        tm = jax.tree_util.tree_leaves(_np(getattr(ts2, moment)))
        jm = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(getattr(js2, moment))]
        for t, j in zip(tm, jm):
            if moment_dtype == "float32":
                np.testing.assert_allclose(t, j, atol=1e-7, rtol=1e-6)
            else:
                assert np.all(np.abs(t - j) <= _ulp_bf16(j)), moment


def test_adamw_init_and_int8_moments():
    """bf16 moments start at zero; int8 moments start as the reference's
    init stores zeros: zero payloads of the parameter's shape and unit
    scales of ``shape[:-1] + (1,)``, the 0-d leaf's payload and scale 0-d,
    and no other leaf (the reference's ``meta`` is static)."""

    tree = _tree(np.random.default_rng(1))
    params = params_from_jax(tree, "cpu")
    state = toptim.AdamW(moment_dtype="bfloat16").init(params)
    assert int(state.step) == 0 and state.mu["w"].dtype == torch.bfloat16
    assert all(float(x.abs().sum()) == 0.0 for x in (state.mu["w"], state.nu["layers"]["a"]))
    state = toptim.AdamW(moment_dtype="int8").init(params)
    jstate = joptim.AdamW(moment_dtype="int8").init(jax.tree_util.tree_map(jnp.asarray, tree))
    for moment in ("mu", "nu"):
        t = flatten(getattr(state, moment))[0]
        j = jax.tree_util.tree_leaves(getattr(jstate, moment))
        assert len(t) == len(j) == 8
        for tl, jl in zip(t, j):
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            assert str(tl.dtype).removeprefix("torch.") == str(jl.dtype)
        assert isinstance(getattr(state, moment)["s"], tadamw._Q8)
        assert getattr(state, moment)["s"].q.shape == ()


def _rows(width: int, kind: str) -> np.ndarray:
    """Three rows of ``width`` (0-d for ``kind="0d"``), numpy seed 3: normal
    draws, or with a row of zeros, a NaN or an inf in the middle row."""

    rng = np.random.default_rng(3)
    if kind == "0d":
        return np.asarray(rng.standard_normal() * 0.7, np.float32)
    x = (rng.standard_normal((3, width)) * 2.5).astype(np.float32)
    if kind == "zero":
        x[1] = 0.0
    elif kind == "nan":
        x[1, width // 2] = np.nan
    elif kind == "inf":
        x[1, width - 1] = np.inf
    return x


_Q8_CASES = [(w, "normal") for w in (1, 255, 256, 257, 3072, 27_392)] + [
    (0, "0d"), (300, "zero"), (300, "nan"), (300, "inf")]


@pytest.mark.parametrize("width,kind", _Q8_CASES)
def test_q8_store_and_read_match_reference(width, kind):
    """``_q8_of`` and ``_q8_read`` against the reference's, run eagerly, bit
    for bit: the payload, the scales and the fp32 read (NaN where the
    reference has NaN), at widths across the row kernel's 256 and the
    moments' widths, and on a 0-d leaf (stored truncated, ROADMAP C9), a
    row of zeros (scale 1), a NaN (scale 1, the NaN stores 0) and an inf
    (scale inf, the row reads NaN)."""

    x = _rows(width, kind)
    tz = tadamw._q8_of(torch.from_numpy(x))
    jz = jadamw._q8_of(jnp.asarray(x))
    for t, j in ((tz.q, jz.q), (tz.scale, jz.scale)):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tadamw._q8_read(tz).numpy(), np.asarray(jadamw._q8_read(jz)))


def test_int8_row_pieces_equal_one_piece(monkeypatch):
    """The int8 update in pieces of whole rows equals the unpieced update
    bit for bit, with ``PIECE`` so small that pieces hold one or two rows
    (one row where a row is wider than ``PIECE``) and a leaf's last piece
    is short."""

    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((7, 5, 13)).astype(np.float32),
              "b": rng.standard_normal((11, 40)).astype(np.float32),
              "c": rng.standard_normal(90).astype(np.float32),
              "s": np.asarray(rng.standard_normal(), np.float32)}
    grads = [jax.tree_util.tree_map(lambda x: (0.3 * rng.standard_normal(x.shape)).astype(
        np.float32), params) for _ in range(2)]
    results = []
    for piece in (1 << 26, 30):
        monkeypatch.setattr(tadamw, "PIECE", piece)
        opt = toptim.AdamW(lr=1e-2, moment_dtype="int8")
        p = params_from_jax(params, "cpu")
        state = opt.init(p)
        for g in grads:
            opt.update(params_from_jax(g, "cpu"), state, p)
        results.append(flatten((p, state))[0])
    assert len(results[0]) == len(results[1]) == 4 + 1 + 16
    for a, b in zip(*results):
        assert torch.equal(a, b)


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
