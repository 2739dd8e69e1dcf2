"""The port's continuous-batching engine against the reference's, on CPU
tensors: per-row ``(B,)`` decode positions in the cache write, the GQA and
MLA decode and the whole decode step; the paged block pool; the engine's
admission, preemption, resume and retirement, token for token and stat for
stat, beside each package's fixed-batch ``Server`` oracle; the decode step's
graph path (``graph_stub``); and ``serve --continuous-batching``.

Tolerances: tokens, positions, int8 payloads and scales exactly; fp32
outputs within 2e-5, bf16 within 2e-2."""

from __future__ import annotations

import dataclasses
import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_stub
from repro.configs import base as jbase
from repro.core import errors as jerrors
from repro.core import onesided
from repro.core import tool as jtool
from repro.launch import serve as jserve
from repro.launch.mesh import make_host_communicator as j_comm
from repro.models import api as japi
from repro.models import attention as jattn
from repro.runtime import engine as jengine
from repro.runtime import kvpool as jkvpool
from repro.runtime import server as jserver
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core import errors, tool
from repro_torch.core.descriptors import WindowSpec
from repro_torch.core.futures import flatten
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import kvpool as tkvpool
from repro_torch.runtime import server as tserver

torch.set_num_threads(1)

BUCKET = 8
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol)


def _to_torch(a):
    """A JAX array's values as a torch tensor of the same dtype."""

    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pair(shape, dtype, seed):
    """The same values as a JAX and a torch array of ``dtype``."""

    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    j = jnp.asarray(x, jnp.dtype(dtype))
    return j, _to_torch(j)


# ---------------------------------------------------------------------------
# per-row cache writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("t,pos,ring", [
    (1, [0, 3, 5, 9], False),     # row 2 at S - T, row 3 past the end
    (2, [1, 4, 5, 11], False),    # row 1 at S - T, rows 2 and 3 clamped to it
    (1, [2, 6, 13, 40], True),    # ring addressing: pos % S
], ids=["t1", "t2", "ring"])
def test_cache_layer_update_per_row_matches_reference(kind, t, pos, ring):
    """Each row writes its ``T`` tokens at its own position, clamped into
    [0, S - T] as ``dynamic_update_slice`` clamps: the port's in-place
    scatter leaves the reference's arrays, int8 bits and scales included."""

    b, s, hk, dh = 4, 6, 2, 8
    dtype = "float32" if kind == "int8" else kind
    jk, tk = _pair((b, s, hk, dh), dtype, 1)
    jv, tv = _pair((b, s, hk, dh), dtype, 2)
    jkn, tkn = _pair((b, t, hk, dh), dtype, 3)
    jvn, tvn = _pair((b, t, hk, dh), dtype, 4)
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.tensor(pos, dtype=torch.int32)
    if kind == "int8":
        jk, jv = (jattn._quantize_kv(x) for x in (jk, jv))
        jk, jks, jv, jvs = jk[0], jk[1], jv[0], jv[1]
        tk, tks, tv, tvs = (_to_torch(a) for a in (jk, jks, jv, jvs))
    else:
        jks = jvs = tks = tvs = None
    jout = jattn.cache_layer_update(jk, jv, jks, jvs, jkn, jvn, jpos, ring=ring)
    tout = tattn.cache_layer_update(tk, tv, tks, tvs, tkn, tvn, tpos, ring=ring)
    assert tout[0] is tk and tout[1] is tv          # written in place
    for to, jo in zip(tout, jout):
        if jo is None:
            assert to is None
            continue
        assert str(to.dtype).removeprefix("torch.") == str(jo.dtype)
        np.testing.assert_array_equal(to.float().numpy(), np.asarray(jo, np.float32))


# ---------------------------------------------------------------------------
# per-row decode attention
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype, **change):
    return (dataclasses.replace(jbase.get_smoke_config(arch), dtype=dtype, **change),
            dataclasses.replace(tbase.get_smoke_config(arch), dtype=dtype, **change))


def _gqa_case(dtype, kv, window):
    """phi4-mini's smoke attention (GQA 4/2 of 16; a window of 4 as a ring
    buffer of 4 slots): weights, the cached layer, a token per row."""

    jcfg, tcfg = _cfgs("phi4_mini_3_8b", dtype)
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    b, cap = 3, 4 if window else 9
    hk, dh = jcfg.num_kv_heads, jcfg.head_dim
    jk, _ = _pair((b, cap, hk, dh), dtype, 5)
    jv, _ = _pair((b, cap, hk, dh), dtype, 6)
    if kv == "int8":
        (jk, jks), (jv, jvs) = jattn._quantize_kv(jk), jattn._quantize_kv(jv)
    else:
        jks = jvs = None
    jx, tx = _pair((b, 1, jcfg.d_model), dtype, 7)
    return jcfg, tcfg, jp, tp, (jk, jv, jks, jvs), jx, tx


def _torch_cache(arrays):
    return [None if a is None else _to_torch(a) for a in arrays]


@pytest.mark.parametrize("dtype,kv,window", [
    ("float32", "float32", None), ("bfloat16", "bfloat16", None),
    ("float32", "int8", None), ("float32", "float32", 4),
])
def test_attention_decode_per_row_matches_reference(dtype, kv, window):
    """``attention_decode`` with ragged ``(B,)`` positions (one row past the
    linear cache's end, whose write clamps; or a ring buffer wrapped
    several times): outputs and the written cache against the reference."""

    jcfg, tcfg, jp, tp, jcache, jx, tx = _gqa_case(dtype, kv, window)
    pos = [2, 7, 11] if window is None else [1, 6, 13]
    jy, jout = jattn.attention_decode(jp, jx, *jcache, jnp.asarray(pos, jnp.int32), jcfg,
                                      jbase.ParallelConfig(), sliding_window=window)
    tcache = _torch_cache(jcache)
    with torch.inference_mode():
        ty, tout = tattn.attention_decode(tp, tx, *tcache, torch.tensor(pos, dtype=torch.int32),
                                          tcfg, tbase.ParallelConfig(), sliding_window=window)
    _close(ty, jy, TOL[dtype])
    for to, jo in zip(tout, jout):
        if jo is None:
            continue
        if to.dtype == torch.int8:
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        else:
            _close(to, jo, TOL[dtype])


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_attention_decode_per_row_equals_scalar_at_equal_depth(kv):
    """Every row at one depth: the per-row path gives the scalar path's
    output and cache, bit for bit."""

    _, tcfg, _, tp, jcache, _, tx = _gqa_case("float32", kv, None)
    outs = []
    for pos in (torch.tensor(5, dtype=torch.int32), torch.full((3,), 5, dtype=torch.int32)):
        cache = _torch_cache(jcache)
        with torch.inference_mode():
            outs.append(tattn.attention_decode(tp, tx, *cache, pos, tcfg, tbase.ParallelConfig(),
                                               sliding_window=None))
    (ys, cs), (yr, cr) = outs
    assert torch.equal(ys, yr)
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(cs, cr))


def _mla_case(dtype):
    jcfg, tcfg = _cfgs("deepseek_v2_236b", dtype)
    jp = jattn.init_mla(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    b, cap = 3, 9
    jckv, tckv = _pair((b, cap, jcfg.kv_lora), dtype, 8)
    jkr, tkr = _pair((b, cap, jcfg.rope_head_dim), dtype, 9)
    jx, tx = _pair((b, 1, jcfg.d_model), dtype, 10)
    return jcfg, tcfg, jp, tp, (jckv, jkr, jx), (tckv, tkr, tx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_per_row_matches_reference(dtype):
    """The absorbed MLA decode with ragged ``(B,)`` positions, one past the
    latent cache's end: output and both latent layers."""

    jcfg, tcfg, jp, tp, (jckv, jkr, jx), (tckv, tkr, tx) = _mla_case(dtype)
    pos = [0, 4, 12]
    jy, (jckv, jkr) = jattn.mla_attention_decode(jp, jx, jckv, jkr, jnp.asarray(pos, jnp.int32),
                                                 jcfg, jbase.ParallelConfig())
    with torch.inference_mode():
        ty, (ckv, kr) = tattn.mla_attention_decode(tp, tx, tckv, tkr,
                                                   torch.tensor(pos, dtype=torch.int32), tcfg,
                                                   tbase.ParallelConfig())
    assert ckv is tckv and kr is tkr
    for t, j in ((ty, jy), (ckv, jckv), (kr, jkr)):
        _close(t, j, TOL[dtype])


def test_mla_decode_per_row_equals_scalar_at_equal_depth():
    _, tcfg, _, tp, _, (tckv, tkr, tx) = _mla_case("float32")
    outs = []
    for pos in (torch.tensor(6, dtype=torch.int32), torch.full((3,), 6, dtype=torch.int32)):
        ckv, kr = tckv.clone(), tkr.clone()
        with torch.inference_mode():
            y, _ = tattn.mla_attention_decode(tp, tx, ckv, kr, pos, tcfg, tbase.ParallelConfig())
        outs.append((y, ckv, kr))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------------------
# lm_decode with a (B,) position vector
# ---------------------------------------------------------------------------


def _leaves(cache):
    """Every leaf of a cache tree by its path, ``None`` leaves dropped."""

    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}")
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{path}.{f.name}")
        elif node is not None:
            out[path] = node

    walk(cache, "")
    return out


@pytest.mark.parametrize("arch,kv", [("phi4_mini_3_8b", "bfloat16"), ("phi4_mini_3_8b", "int8"),
                                     ("grok_1_314b", "bfloat16"),
                                     ("deepseek_v2_236b", "bfloat16")])
def test_lm_decode_per_row_matches_reference(arch, kv):
    """Prefill three 6-token prompts, give each row its own depth (the
    engine's slot table), decode three steps: logits and every cache leaf
    (the int8 payload and scales exactly, the position vector exactly)
    against the reference.  Covers the uniform stack, the MoE blocks and
    deepseek's ``dense_0`` with its MLA cache."""

    jcfg, tcfg = _cfgs(arch, "float32")
    jb, tb = japi.build(jcfg), tapi.build(tcfg)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jpc = dataclasses.replace(jbase.ParallelConfig(), kv_cache_dtype=kv)
    tpc = dataclasses.replace(tbase.ParallelConfig(), kv_cache_dtype=kv)
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size, size=(3, 6), dtype=np.int32)
    _, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, jpc, extra_capacity=4)
    with torch.inference_mode():
        _, tc = tb.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tpc, extra_capacity=4)
    pos = np.array([6, 2, 9], np.int32)   # row 2 reaches the end and clamps
    jc = {k: dataclasses.replace(v, pos=jnp.asarray(pos)) for k, v in jc.items()}
    tc = {k: dataclasses.replace(v, pos=torch.from_numpy(pos.copy())) for k, v in tc.items()}
    tok = toks[:, -1:]
    for _ in range(3):
        jl, jc = jb.decode(jparams, jc, jnp.asarray(tok), jpc)
        with torch.inference_mode():
            tl, tc = tb.decode(tparams, tc, torch.from_numpy(tok), tpc)
        _close(tl, jl, TOL["float32"])
        tleaves, jleaves = _leaves(tc), _leaves(jc)
        assert tleaves.keys() == jleaves.keys()
        for key, t in tleaves.items():
            j = jleaves[key]
            if key.endswith("pos") or t.dtype == torch.int8:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=key)
            else:
                _close(t, j, TOL["float32"])
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    np.testing.assert_array_equal(tc[next(iter(tc))].pos.numpy(), pos + 3)


# ---------------------------------------------------------------------------
# the block pool
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    """A call's result, or its error class and exception type's name."""

    try:
        return ("ok", fn(*args))
    except (errors.Error, jerrors.Error) as e:
        return ("raised", type(e).__name__, e.klass.name)


def _pool_counts(module):
    counts = module.pvar_read()
    return counts.get("kvpool_alloc", 0), counts.get("kvpool_free", 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_matches_reference_under_a_seeded_sequence(seed):
    """Both pools take one seeded sequence of ``ensure``, ``release`` and
    ``fits`` (slots and depths past the pool's range included): the same
    block ids, the same ``ERR_NO_MEM`` / ``ERR_RMA_RANGE`` / ``ERR_ARG``,
    the same live and free counts and the same pvar deltas."""

    kw = dict(num_slots=3, slot_capacity=10, block_tokens=4, budget_blocks=6)
    jp, tp = jkvpool.KVBlockPool(**kw), tkvpool.KVBlockPool(**kw)
    j0, t0 = _pool_counts(jtool), _pool_counts(tool)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        op = rng.choice(["ensure", "ensure", "release", "fits"])
        slot, tokens = int(rng.integers(-1, 4)), int(rng.integers(0, 14))
        args = (slot,) if op == "release" else (slot, tokens)
        if op == "release" and not 0 <= slot < 3:
            continue   # release of an unknown slot is a no-op in both
        assert _outcome(getattr(tp, op), *args) == _outcome(getattr(jp, op), *args), (op, args)
        assert (tp.live_blocks, tp.free_blocks) == (jp.live_blocks, jp.free_blocks)
        assert [tp.block_ids(s) for s in range(3)] == [jp.block_ids(s) for s in range(3)]
    j1, t1 = _pool_counts(jtool), _pool_counts(tool)
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    assert t1[0] > t0[0] and t1[1] > t0[1]


def test_pool_budget_and_range_errors():
    """The reference's own pool test on the port's pool."""

    pool = tkvpool.KVBlockPool(num_slots=2, slot_capacity=8, block_tokens=4, budget_blocks=3)
    assert pool.blocks_per_slot == 2 and pool.total_blocks == 4
    assert pool.ensure(0, 8) == [0, 1]
    assert pool.ensure(1, 4) == [2]
    with pytest.raises(errors.NoMemError):
        pool.ensure(1, 8)
    with pytest.raises(errors.RmaRangeError):
        pool.ensure(0, 9)
    with pytest.raises(errors.ArgError):
        pool.ensure(2, 4)
    assert pool.release(0) == [0, 1]
    assert pool.ensure(1, 8) == [3]
    assert pool.free_blocks == 1
    with pytest.raises(errors.NoMemError):
        tkvpool.KVBlockPool(num_slots=2, slot_capacity=8, block_tokens=4, budget_blocks=1)


def _dynamic_window(num_pages, dynamic=True):
    """The port's RMA window over a slot table's stand-in buffer."""

    from repro_torch.core import onesided as tonesided
    from repro_torch.core.communicator import world

    return tonesided.Window(world(device_type="cpu"), torch.zeros(8, 4),
                            WindowSpec(dynamic=dynamic, num_pages=num_pages))


def test_pool_mirrors_window_attach_state_as_the_reference():
    """The port's pool bound to the port's dynamic window attaches and
    detaches the pages the reference's pool attaches to its dynamic window;
    it refuses a static window (``ERR_WIN``) and a page count other than
    its blocks (``ERR_RMA_RANGE``)."""

    kw = dict(num_slots=2, slot_capacity=8, block_tokens=4)
    jp, tp = jkvpool.KVBlockPool(**kw), tkvpool.KVBlockPool(**kw)
    jwin = onesided.Window(j_comm(), np.zeros((8, 4), np.float32),
                           WindowSpec(dynamic=True, num_pages=jp.total_blocks))
    twin = _dynamic_window(tp.total_blocks)
    seen = []
    for op, args in (("ensure", (0, 8)), ("bind", ()), ("ensure", (1, 5)), ("release", (0,)),
                     ("ensure", (0, 3)), ("release", (1,))):
        for pool, win in ((jp, jwin), (tp, twin)):
            if op == "bind":
                pool.bind_window(win)
            else:
                getattr(pool, op)(*args)
        seen.append(set(twin.attached_pages))
        assert twin.attached_pages == set(jwin.attached_pages)
    assert seen == [set(), {0, 1}, {0, 1, 2, 3}, {2, 3}, {0, 2, 3}, {0}]
    with pytest.raises(errors.WinError):
        tp.bind_window(_dynamic_window(tp.total_blocks, dynamic=False))
    with pytest.raises(errors.RmaRangeError):
        tp.bind_window(_dynamic_window(3))


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------


def _tiny(module):
    # float32: the parity tests compare argmax chains token for token
    return module.ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
        num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64, dtype="float32",
    )


def _model(module, name):
    if name.startswith("tiny"):
        return _tiny(module), module.ParallelConfig(
            kv_cache_dtype="int8" if name == "tiny_int8" else "bfloat16")
    return (dataclasses.replace(module.get_smoke_config(name), dtype="float32"),
            module.get_parallel(name))


_SERVERS: dict = {}


def _servers(name):
    """(reference, port) Servers with 4 slots and 6 new tokens on the same
    weights, built once per model for the module."""

    if name not in _SERVERS:
        scfg = dict(max_batch=4, max_new_tokens=6, temperature=0.0)
        jcfg, jpcfg = _model(jbase, name)
        tcfg, tpcfg = _model(tbase, name)
        js = jserver.Server(jcfg, jpcfg, jserver.ServerConfig(**scfg), j_comm())
        ts = tserver.Server(tcfg, tpcfg, tserver.ServerConfig(**scfg), device="cpu")
        ts.params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params), "cpu")
        _SERVERS[name] = js, ts
    return _SERVERS[name]


def _prompts(n, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=(int(rng.integers(2, BUCKET + 1)),), dtype=np.int32)
            for _ in range(n)]


def _oracle(module, server, prompts):
    """The fixed-batch Server on bucket-left-padded prompts: the engine's
    parity oracle."""

    outs, mb = [], server.scfg.max_batch
    for i in range(0, len(prompts), mb):
        reqs = [module.Request(tokens=np.concatenate([np.zeros((BUCKET - len(p),), np.int32), p]))
                for p in prompts[i:i + mb]]
        tokens, _ = server.generate(reqs)
        outs += [np.asarray(t) for t in tokens]
    return outs


# behaviour: (prompt seeds per run, budgets, EngineConfig knobs) — the
# reference's tests/test_engine.py cases on 4 slots of 6 new tokens
_BEHAVIOURS = {
    # 6 ragged requests: the last two are admitted mid-flight, each retires
    # at its own budget
    "ragged": ([3], [6, 3, 5, 2, 4, 6], dict(block_tokens=4)),
    # 20 blocks of 2 tokens cannot hold 4 rows of depth 14: evictions, and
    # resumes that re-prefill prompt + generated[:-1]
    "preempt": ([11], [6] * 6, dict(block_tokens=2, pool_blocks=20)),
    # two runs on one engine: the second run's occupants reuse the first's
    # slot-affine block ids
    "reuse": ([1, 2], [2] * 4, dict(block_tokens=4)),
}

_COUNTERS = ("engine:admit", "engine:retire", "engine:preempt", "trace:insert_row",
             "kvpool_alloc", "kvpool_free")


def _run_engine(module, engine_module, server, behaviour):
    seeds, budgets, knobs = _BEHAVIOURS[behaviour]
    vocab = server.cfg.vocab_size
    before = module.pvar_read()
    eng = engine_module.Engine(server, engine_module.EngineConfig(prompt_bucket=BUCKET, **knobs))
    runs, prompts = [], []
    for seed in seeds:
        ps = _prompts(len(budgets), seed, vocab)
        prompts += ps
        handles = [eng.submit(p, max_new=b) for p, b in zip(ps, budgets)]
        eng.run()
        runs.append(handles)
    after = module.pvar_read()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in _COUNTERS}
    return eng, runs, prompts, counts


@pytest.mark.parametrize("name", ["tiny", "tiny_int8", "grok_1_314b", "deepseek_v2_236b"])
@pytest.mark.parametrize("behaviour", sorted(_BEHAVIOURS))
def test_engine_matches_reference_engine(behaviour, name):
    """The same requests through both engines: every request's tokens, state,
    preemptions and block ids, the engines' ``stats()`` and the pvars
    (admissions, retirements, preemptions, insert signatures, pool blocks)
    are the same; and each engine agrees with its package's fixed-batch
    oracle on the same requests.  The dense models agree on every request.
    The MoE models' capacity-bounded dispatch drops tokens by the batch's
    other rows in both packages, so there the port must agree with its
    oracle exactly where the reference agrees with its own (ROADMAP C15)."""

    js, ts = _servers(name)
    jeng, jruns, prompts, jcounts = _run_engine(jtool, jengine, js, behaviour)
    with torch.inference_mode():
        teng, truns, _, tcounts = _run_engine(tool, tengine, ts, behaviour)
    assert teng.stats() == jeng.stats()
    assert tcounts == jcounts
    handles = [(t, j) for tr, jr in zip(truns, jruns) for t, j in zip(tr, jr)]
    for t, j in handles:
        assert t.generated == [int(x) for x in j.generated]
        assert (t.state, t.slot, t.preemptions, t.block_ids, t.cached_tokens) == \
            (j.state, j.slot, j.preemptions, j.block_ids, j.cached_tokens)
        assert t.state == "finished" and len(t.generated) == t.max_new
    joracle, toracle = _oracle(jserver, js, prompts), _oracle(tserver, ts, prompts)
    for a, b in zip(toracle, joracle):
        np.testing.assert_array_equal(a, b)
    jagree = [np.array_equal(j.generated, o[: j.max_new]) for (_, j), o in zip(handles, joracle)]
    tagree = [np.array_equal(t.generated, o[: t.max_new]) for (t, _), o in zip(handles, toracle)]
    assert tagree == jagree
    if not name.startswith(("grok", "deepseek")):
        assert all(tagree)
    stats = teng.stats()
    assert stats["pool_live_blocks"] == 0 and stats["finished"] == len(handles)
    if behaviour == "preempt":
        assert stats["preemptions"] > 0
    if behaviour == "ragged":
        assert stats["steps"] < sum(_BEHAVIOURS["ragged"][1])   # admitted mid-flight
    if behaviour == "reuse":
        first, second = truns
        assert sorted(map(tuple, (h.block_ids for h in first))) == \
            sorted(map(tuple, (h.block_ids for h in second)))


def test_submit_validation():
    _, ts = _servers("tiny")
    eng = tengine.make_engine(ts, tengine.EngineConfig(prompt_bucket=4))
    with pytest.raises(errors.TruncateError):
        eng.submit(np.ones((5,), np.int32))                 # prompt > bucket
    with pytest.raises(errors.ArgError):
        eng.submit(np.ones((3,), np.int32), max_new=9)      # budget > ceiling
    with pytest.raises(errors.UnsupportedError):
        eng.submit(tserver.Request(tokens=np.ones((3,), np.int32),
                                   extra={"image_embeds": np.ones((2, 8))}))
    assert not eng.waiting


@pytest.mark.parametrize("arch", ["tiny_window", "mamba2_2_7b"])
def test_engine_refuses_what_the_reference_refuses(arch):
    """Ring-buffer caches (a sliding window) and families other than
    dense/moe (Mamba-2): the same ``ERR_UNSUPPORTED_OPERATION`` in both
    packages."""

    scfg = dict(max_batch=2, max_new_tokens=3)

    def cfg(module):
        if arch == "tiny_window":
            return dataclasses.replace(_tiny(module), sliding_window=4)
        return module.get_smoke_config(arch)

    with pytest.raises(jerrors.Error) as je:
        jengine.Engine(jserver.Server(cfg(jbase), jbase.ParallelConfig(),
                                      jserver.ServerConfig(**scfg), j_comm()),
                       jengine.EngineConfig())
    with pytest.raises(errors.Error) as te:
        tengine.Engine(tserver.Server(cfg(tbase), tbase.ParallelConfig(),
                                      tserver.ServerConfig(**scfg), device="cpu"),
                       tengine.EngineConfig())
    assert te.value.klass.name == je.value.klass.name == "ERR_UNSUPPORTED_OPERATION"


def test_temperature_sampling_is_seeded():
    """Above temperature 0 an engine samples from a generator seeded by
    ``scfg.seed``: the same seed repeats its tokens, another seed does not."""

    def tokens(seed):
        server = tserver.Server(_tiny(tbase), tbase.ParallelConfig(),
                                tserver.ServerConfig(max_batch=2, max_new_tokens=6,
                                                     temperature=1.0, seed=seed),
                                device="cpu")
        eng = tengine.Engine(server, tengine.EngineConfig(prompt_bucket=BUCKET))
        handles = [eng.submit(p) for p in _prompts(3, 5, 64)]
        eng.run()
        return [h.generated for h in handles]

    assert tokens(0) == tokens(0)
    assert tokens(0) != tokens(1)


# ---------------------------------------------------------------------------
# the graph path
# ---------------------------------------------------------------------------


def test_graph_decode_captures_once_a_run_and_inserts_in_place(monkeypatch):
    """The decode step through the graph path (capture and replay stood in
    for by ``graph_stub``): the eager engine's tokens; one capture a run,
    whatever the admissions and preemptions; the slot table's buffers are
    the ones the engine made (no copy, no recapture); the graph is released
    at the end of each run."""

    _, ts = _servers("tiny")
    _, (want,), _, _ = _run_engine(tool, tengine, ts, "preempt")
    want = [h.generated for h in want]
    graph_stub.install(monkeypatch)
    monkeypatch.setattr(ts, "_decode_reqs", {})   # a request built under the stub
    ecfg = tengine.EngineConfig(prompt_bucket=BUCKET, **_BEHAVIOURS["preempt"][2])
    eng = tengine.Engine(ts, ecfg)
    table = {id(t): t.data_ptr() for t in flatten(eng.cache)[0] if t.dim() > 1}
    insert, req_seen = eng._insert, []

    def watched_insert(*a):
        if eng._decode_req is not None:
            req_seen.append(eng._decode_req.captured)
        return insert(*a)

    monkeypatch.setattr(eng, "_insert", watched_insert)
    for run in (1, 2):
        handles = [eng.submit(p) for p in _prompts(6, 11, 64)]
        eng.run()
        req = eng._decode_req
        assert req.captures and req.captured == run
        assert req._graph is None and req._bound == []
        assert [h.generated for h in handles] == want
    assert eng.stats()["preemptions"] > 0 and req_seen   # admissions while the graph lived
    assert {id(t): t.data_ptr() for t in flatten(eng.cache)[0] if t.dim() > 1} == table


@pytest.mark.parametrize("graph", [False, True])
def test_engine_frees_its_caches_at_once(monkeypatch, graph):
    """Without the cyclic garbage collector: each admission's side-batch
    cache is freed once its rows are inserted, and the slot table once the
    engine is dropped after ``run()`` (its released graph holds none of it)."""

    if graph:
        graph_stub.install(monkeypatch)
    _, ts = _servers("tiny")
    side, prefill = [], ts.bundle.prefill

    def recording_prefill(*a, **k):
        logits, cache = prefill(*a, **k)
        side.extend(weakref.ref(t) for t in flatten(cache)[0])
        return logits, cache

    monkeypatch.setattr(ts, "bundle", dataclasses.replace(ts.bundle, prefill=recording_prefill))
    monkeypatch.setattr(ts, "_prefill_reqs", {})
    monkeypatch.setattr(ts, "_decode_reqs", {})
    gc.disable()
    try:
        eng = tengine.Engine(ts, tengine.EngineConfig(prompt_bucket=BUCKET, block_tokens=2,
                                                      pool_blocks=20))
        n_leaves = len(flatten(eng.cache)[0])
        # the slot table's buffers (its position vector is replaced each step)
        table = [weakref.ref(t) for t in flatten(eng.cache)[0] if t.dim() > 1]
        for p in _prompts(6, 11, 64):
            eng.submit(p)
        eng.run()
        assert eng.stats()["preemptions"] > 0
        assert side and all(r() is None for r in side[n_leaves:])
        assert all(r() is not None for r in table)
        del eng
        assert all(r() is None for r in table)
    finally:
        gc.enable()
    assert all(r.captures == graph for r in ts._decode_reqs.values())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_continuous_batching_cli_prints_the_references_lengths(capsys):
    argv = ["--arch", "phi4_mini_3_8b", "--smoke", "--continuous-batching", "--requests", "6",
            "--prompt-len", "8", "--new-tokens", "4"]
    assert jserve.main(argv) == 0
    ref = capsys.readouterr().out
    assert serve.main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out

    def lengths_and_keys(out):
        line = next(x for x in out.splitlines() if x.startswith("generated lengths:"))
        stats = json.loads(out[out.index("{"):])
        return line, sorted(stats), stats["finished"]

    assert lengths_and_keys(port) == lengths_and_keys(ref)
    assert "generated lengths: [4, 4, 4, 4, 4, 4]" in port


def test_continuous_batching_cli_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(errors.Error) as ei:
        serve.main(["--arch", "phi4_mini_3_8b", "--smoke", "--continuous-batching",
                    "--requests", "2", "--prompt-len", "4", "--new-tokens", "2"])
    assert ei.value.klass == errors.ErrorClass.ERR_SESSION


def test_continuous_batching_refuses_disaggregate():
    """As the reference's CLI, ``--continuous-batching`` with
    ``--disaggregate`` is a usage error."""

    argv = ["--arch", "phi4_mini_3_8b", "--smoke", "--continuous-batching", "--disaggregate"]
    with pytest.raises(SystemExit) as je:
        jserve.main(argv)
    with pytest.raises(SystemExit) as te:
        serve.main(argv + ["--device", "cpu"])
    assert te.value.code == je.value.code == 2
