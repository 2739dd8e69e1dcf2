"""The port's RMA windows (``core/onesided.py``) against the reference's:
the reference's single-process window checks (epochs, refusals, extent) on
the world of one, each refusal raising the same class in both packages; the
window numerics on the world of one; the RMA numerics of the reference's
``CODE_RMA`` on 4 gloo ranks (one process each) against the reference on 4
virtual JAX devices, the same per-rank inputs from a seed, exact in fp32
(integer-valued inputs, so every sum is exact in any order); and the KV
block pool bound to a real dynamic window."""

from __future__ import annotations

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jmpx
from repro.core import errors as jerrors
from repro.core import onesided as jonesided
from repro.core.descriptors import ReduceOp as JReduceOp
from repro.core.descriptors import WindowSpec as JWindowSpec
from repro.runtime import kvpool as jkvpool
from repro_torch.core import errors, onesided, tool
from repro_torch.core.communicator import world
from repro_torch.core.descriptors import ReduceOp, WindowSpec
from repro_torch.runtime import kvpool
from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)

WORLD = 4


def _comms():
    return world(device_type="cpu"), jmpx.world()


def _same_refusal(port_fn, ref_fn):
    """Both calls raise, and with the same error class."""

    with pytest.raises(jerrors.Error) as je:
        ref_fn()
    with pytest.raises(errors.Error) as te:
        port_fn()
    assert te.value.klass.name == je.value.klass.name


# -- epoch / validation (the reference's single-process checks) ---------------


def test_access_outside_epoch_is_err_win():
    tc, jc = _comms()
    tw = onesided.Window(tc, torch.zeros(4))
    jw = jonesided.Window(jc, jnp.zeros((4,), jnp.float32))
    for call in (lambda w, o: w.put(o, [(0, 0)]), lambda w, o: w.get([(0, 0)]),
                 lambda w, o: w.accumulate(o, target=0), lambda w, o: w.rput(o, [(0, 0)])):
        _same_refusal(lambda: call(tw, torch.ones(4)),
                      lambda: call(jw, jnp.ones((4,), jnp.float32)))
    with pytest.raises(errors.WinError):
        tw.put(torch.ones(4), [(0, 0)])


def test_duplicate_put_targets_are_err_rank():
    # two origins writing one target in an epoch is a data race, never
    # last-writer-wins; the reference's world here has one rank, so the
    # pairs are checked on a window over its own world and on the port's
    tc, jc = _comms()
    tw = onesided.Window(tc, torch.zeros(4)).fence()
    jw = jonesided.Window(jc, jnp.zeros((4,), jnp.float32)).fence()
    for pairs in ([(0, 0), (0, 0)],):
        _same_refusal(lambda: tw.put(torch.ones(4), pairs),
                      lambda: jw.put(jnp.ones((4,), jnp.float32), pairs))
        _same_refusal(lambda: tw.rput(torch.ones(4), pairs),
                      lambda: jw.rput(jnp.ones((4,), jnp.float32), pairs))


def test_epoch_write_ledger_spans_calls():
    """A second put covering an already-written span of the same target
    raises ERR_RANK even from a separate call."""

    tc, jc = _comms()
    tw = onesided.Window(tc, torch.zeros(8)).fence()
    jw = jonesided.Window(jc, jnp.zeros((8,), jnp.float32)).fence()
    for w, ones in ((tw, torch.ones(8)), (jw, jnp.ones((8,), jnp.float32))):
        w.rput(ones, [(0, 0)], page=(0, 2))
        w.rput(ones, [(0, 0)], page=(1, 2))   # disjoint: fine
    _same_refusal(lambda: tw.rput(torch.ones(8), [(0, 0)]),
                  lambda: jw.rput(jnp.ones((8,), jnp.float32), [(0, 0)]))
    _same_refusal(lambda: tw.rput(torch.ones(8), [(0, 0)], page=(1, 4)),
                  lambda: jw.rput(jnp.ones((8,), jnp.float32), [(0, 0)], page=(1, 4)))
    tw.fence()
    assert torch.equal(tw.buffer, torch.ones(8))


def test_perm_out_of_range_is_err_rank():
    tc, jc = _comms()
    tw = onesided.Window(tc, torch.zeros(4)).fence()
    jw = jonesided.Window(jc, jnp.zeros((4,), jnp.float32)).fence()
    n = tc.size()
    assert n == jc.size() == 1
    _same_refusal(lambda: tw.put(torch.ones(4), [(0, n)]),
                  lambda: jw.put(jnp.ones((4,), jnp.float32), [(0, n)]))
    _same_refusal(lambda: tw.accumulate(torch.ones(4), target=n),
                  lambda: jw.accumulate(jnp.ones((4,), jnp.float32), target=n))


def test_page_out_of_range_is_err_count_at_issue():
    tc, jc = _comms()
    tw = onesided.Window(tc, torch.zeros(8)).fence()
    jw = jonesided.Window(jc, jnp.zeros((8,), jnp.float32)).fence()
    _same_refusal(lambda: tw.rput(torch.ones(8), [(0, 0)], page=(5, 2)),
                  lambda: jw.rput(jnp.ones((8,), jnp.float32), [(0, 0)], page=(5, 2)))
    _same_refusal(lambda: tw.put(torch.ones(8), [(0, 0)], page=(2, 2)),
                  lambda: jw.put(jnp.ones((8,), jnp.float32), [(0, 0)], page=(2, 2)))


def test_bare_none_window_is_err_type():
    tc, jc = _comms()
    _same_refusal(lambda: onesided.Window(tc, None), lambda: jonesided.Window(jc, None))
    with pytest.raises(errors.TypeError_):
        onesided.Window(tc, None)


def test_window_spec_honored():
    tc, jc = _comms()
    _same_refusal(lambda: onesided.Window(tc, torch.zeros(4), WindowSpec(no_locks=False)),
                  lambda: jonesided.Window(jc, jnp.zeros(4), JWindowSpec(no_locks=False)))
    tw = onesided.Window(tc, torch.zeros(4)).fence()
    jw = jonesided.Window(jc, jnp.zeros((4,), jnp.float32)).fence()
    for op in ("MAXLOC", "NO_OP"):
        _same_refusal(lambda: tw.accumulate(torch.ones(4), target=0, op=ReduceOp[op]),
                      lambda: jw.accumulate(jnp.ones((4,), jnp.float32), target=0,
                                            op=JReduceOp[op]))


def test_shape_mismatch_is_err_truncate():
    tc, jc = _comms()
    tw = onesided.Window(tc, torch.zeros(4)).fence()
    jw = jonesided.Window(jc, jnp.zeros((4,), jnp.float32)).fence()
    _same_refusal(lambda: tw.put(torch.ones(5), [(0, 0)]),
                  lambda: jw.put(jnp.ones((5,), jnp.float32), [(0, 0)]))


def test_extent_and_datatype():
    tc, jc = _comms()
    assert onesided.Window(tc, torch.zeros(4)).extent() == \
        jonesided.Window(jc, jnp.zeros((4,), jnp.float32)).extent() == 16
    assert onesided.Window(tc, torch.zeros(4)).datatype is None
    agg_t = {"a": torch.zeros(2), "b": torch.zeros(3, dtype=torch.int32)}
    agg_j = {"a": jnp.zeros((2,), jnp.float32), "b": jnp.zeros((3,), jnp.int32)}
    tw, jw = onesided.Window(tc, agg_t), jonesided.Window(jc, agg_j)
    assert tw.extent() == jw.extent() == 2 * 4 + 3 * 4
    assert tw.datatype is not None


# -- numerics on the world of one ----------------------------------------------


def _jax_one(fn):
    """``fn`` inside the reference's SPMD region on its world of one."""

    comm = jmpx.world()
    return jax.tree.map(np.asarray, comm.spmd(lambda: fn(comm))())


def test_window_numerics_on_a_world_of_one():
    """put, paged rput, get, rget, accumulate over the op set, the atomics
    and a three-bucket aggregate, each equal to the reference's."""

    rng = np.random.default_rng(5)
    w0 = rng.integers(-4, 5, size=(8,)).astype(np.float32)
    val = rng.integers(1, 4, size=(8,)).astype(np.float32)
    # "a" and "c" share the fp32 buffer (10 elements): its middle page of 3
    # spans the end of one leaf and the start of the other
    agg = {"a": rng.integers(0, 9, size=(2, 3)).astype(np.float32),
           "b": rng.integers(0, 9, size=(5,)).astype(np.int32),
           "c": rng.integers(0, 9, size=(4,)).astype(np.float32),
           "h": rng.integers(0, 9, size=(3,)).astype(np.float32)}

    def body(mod, comm, arr, spec_cls, op_cls, to_h):
        out = {}
        win = mod.Window(comm, arr(w0)).fence()
        out["get"] = win.get([(0, 0)])
        win.put(arr(val), [(0, 0)], page=(1, 2))
        for op in ("SUM", "PROD", "MAX", "MIN", "REPLACE"):
            win.accumulate(arr(val), target=0, op=op_cls[op])
            out[f"acc_{op}"] = win.buffer + 0
        out["fo"] = win.fetch_and_op(arr(np.array(2.0, np.float32)), target=0, op=op_cls.SUM, index=3)
        out["cas"] = win.compare_and_swap(float(val[0]), 9.0, target=0, index=0)
        out["ga"] = win.get_accumulate(arr(val), target=0, op=op_cls.MAX)
        out["win"] = win.fence().buffer
        zeros = {k: arr(np.zeros_like(v)) for k, v in agg.items()}
        zeros["h"] = to_h(zeros["h"])
        win = mod.Window(comm, zeros, spec_cls(num_pages=3)).fence()
        for p in range(3):
            win.rput({"a": arr(agg["a"]), "b": arr(agg["b"]), "c": arr(agg["c"]),
                      "h": to_h(arr(agg["h"]))}, [(0, 0)], page=p)
        out.update({f"agg_{k}": v for k, v in win.fence().buffer.items()})
        return out

    tc = world(device_type="cpu")
    got = body(onesided, tc, torch.from_numpy, WindowSpec, ReduceOp,
               lambda t: t.to(torch.bfloat16))
    want = _jax_one(lambda jc: body(jonesided, jc, jnp.asarray, JWindowSpec, JReduceOp,
                                    lambda t: t.astype(jnp.bfloat16)))
    assert set(got) == set(want)
    for k in got:
        g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
        np.testing.assert_array_equal(g, np.asarray(want[k], dtype=g.dtype), err_msg=k)


def test_dynamic_window_attach_detach():
    """Dynamic windows: attach/detach, page_alloc/page_free, the refusals
    (ERR_RMA_RANGE, ERR_RMA_ATTACH, ERR_NO_MEM) and the pvars, as the
    reference's."""

    tc, jc = _comms()
    results = []
    for mod, comm, zeros, spec in ((onesided, tc, torch.zeros(8), WindowSpec),
                                   (jonesided, jc, jnp.zeros((8,), jnp.float32), JWindowSpec)):
        win = mod.Window(comm, zeros, spec(dynamic=True, num_pages=4))
        ids = win.page_alloc(2)
        win.attach([3])
        win.fence()
        rec = {"ids": ids, "free": win.free_pages(), "attached": sorted(win.attached_pages)}
        errs = {}
        for name, fn in (("put_detached", lambda: win.put(zeros, [(0, 0)], page=2)),
                         ("full_put", lambda: win.put(zeros, [(0, 0)])),
                         ("reattach", lambda: win.attach([0])),
                         ("detach_free", lambda: win.detach([2])),
                         ("alloc_too_many", lambda: win.page_alloc(3)),
                         ("static_attach", lambda: mod.Window(comm, zeros).attach([0]))):
            try:
                fn()
                errs[name] = "none"
            except (errors.Error, jerrors.Error) as e:
                errs[name] = e.klass.name
        win.page_free([0])
        rec.update(errs=errs, after=sorted(win.attached_pages))
        results.append(rec)
    assert results[0] == results[1]
    assert results[0]["errs"]["put_detached"] == "ERR_RMA_RANGE"


def test_fence_completes_chained_requests_and_counts_pvars():
    """rput requests chained with then() and joined with when_all complete
    in issue order by the closing fence; every call counts its pvar."""

    from repro_torch.core.futures import Future, when_all

    tool.pvar_reset()
    win = onesided.Window(world(device_type="cpu"), torch.zeros(6), WindowSpec(num_pages=3))
    win.fence()
    fut = win.rput(torch.arange(6.0), [(0, 0)], page=0)
    assert isinstance(fut, Future)
    chained = fut.then(lambda f: (f.get(), win.rput(torch.arange(6.0), [(0, 0)], page=1))[1])
    joined = when_all([chained, win.rget([(0, 0)])])
    win.rput(torch.arange(6.0), [(0, 0)], page=2)
    win.fence()
    assert torch.equal(win.buffer, torch.arange(6.0))
    assert len(joined.get()) == 2
    counts = tool.pvar_read()
    assert (counts["rma_rput"], counts["rma_rget"], counts["rma_fence"]) == (3, 1, 2)


def test_pvars_paused_is_per_thread():
    """The pause a persistent handoff takes after its first start stops
    this thread's counts only: a background thread (file I/O) goes on
    counting."""

    import threading

    tool.pvar_reset()
    with tool.pvars_paused():
        tool.pvar_count("rma_put")
        t = threading.Thread(target=tool.pvar_count, args=("rma_get",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with tool.pvars_paused(False):
        tool.pvar_count("rma_fence")
    counts = tool.pvar_read()
    assert (counts["rma_put"], counts["rma_get"], counts["rma_fence"]) == (0, 1, 1)


# -- the KV block pool over a real dynamic window -------------------------------


def test_kvpool_binds_a_dynamic_window():
    """``KVBlockPool.bind_window`` takes the port's dynamic window: ensure
    and release attach and detach its pages exactly as the reference pool's
    do on the reference's window; a static or mis-sized window is refused
    with the reference's classes."""

    tc, jc = _comms()
    kw = dict(num_slots=2, slot_capacity=8, block_tokens=2, budget_blocks=6)
    tp, jp = kvpool.KVBlockPool(**kw), jkvpool.KVBlockPool(**kw)
    twin = onesided.Window(tc, torch.zeros(8, 4), WindowSpec(dynamic=True,
                                                             num_pages=tp.total_blocks))
    jwin = jonesided.Window(jc, np.zeros((8, 4), np.float32),
                            JWindowSpec(dynamic=True, num_pages=jp.total_blocks))
    tp.bind_window(twin)
    jp.bind_window(jwin)
    for pool in (tp, jp):
        pool.ensure(0, 5)
        pool.ensure(1, 3)
        pool.release(0)
        pool.ensure(1, 6)
    assert twin.attached_pages == jwin.attached_pages
    _same_refusal(lambda: kvpool.KVBlockPool(**kw).bind_window(onesided.Window(tc, torch.zeros(4))),
                  lambda: jkvpool.KVBlockPool(**kw).bind_window(
                      jonesided.Window(jc, np.zeros(4, np.float32))))
    _same_refusal(
        lambda: kvpool.KVBlockPool(**kw).bind_window(onesided.Window(
            tc, torch.zeros(4), WindowSpec(dynamic=True, num_pages=3))),
        lambda: jkvpool.KVBlockPool(**kw).bind_window(jonesided.Window(
            jc, np.zeros(4, np.float32), JWindowSpec(dynamic=True, num_pages=3))))


# -- numerics on 4 ranks --------------------------------------------------------


JAX_SIDE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import core as mpx
    from repro.core import errors, futures, onesided
    from repro.core.descriptors import ReduceOp, WindowSpec

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    comm = mpx.world()
    N = comm.size()
    assert N == 4, N
    W = P("world")

    def per_rank(fn, *arrays):
        body = lambda *a: jax.tree.map(lambda t: jnp.asarray(t)[None], fn(*[t[0] for t in a]))
        f = comm.spmd(body, in_specs=tuple(W for _ in arrays), out_specs=W)
        return jax.tree.map(np.asarray, f(*arrays))

    @mpx.register_aggregate
    @dataclasses.dataclass
    class KV:
        k: jax.Array
        v: jax.Array

    w0, val, bits, k0, v0 = (jnp.asarray(inp[k]) for k in ("w0", "val", "bits", "k", "v"))
    out = {}

    def ops(w, x):
        win = onesided.Window(comm, w).fence()
        got = win.get([((d - 1) % N, d) for d in range(N)])
        win.put(x, [(1, 0)])
        win.accumulate(x, target=2, op=ReduceOp.MAX)
        win.accumulate(x, target=3, op=ReduceOp.PROD)
        win.accumulate(x, target=1, op=ReduceOp.SUM)
        return got, win.fence().buffer
    out["ops_get"], out["ops_buffer"] = per_rank(ops, w0, val)

    def bit_ops(b):
        win = onesided.Window(comm, b).fence()
        win.accumulate(b, target=0, op=ReduceOp.BXOR)
        win.accumulate(b, target=1, op=ReduceOp.LOR)
        win.accumulate(b, target=2, op=ReduceOp.BAND)
        return win.fence().buffer
    out["bits_buffer"] = per_rank(bit_ops, bits)

    def spec(w, x):
        win = onesided.Window(comm, w, WindowSpec(accumulate_op=ReduceOp.MIN)).fence()
        win.accumulate(x, target=1)
        return win.fence().buffer
    out["spec_buffer"] = per_rank(spec, w0, val)

    def atomics(w):
        win = onesided.Window(comm, w).fence()
        r = (win.fetch_and_op(jnp.float32(5.0), target=1, op=ReduceOp.SUM, index=2),
             win.compare_and_swap(float(inp["w0"][2][0]), 42.0, target=2, index=0),
             win.compare_and_swap(7.5, -1.0, target=2, index=1),
             win.get_accumulate(jnp.ones((4,), jnp.float32), target=3, op=ReduceOp.NO_OP),
             win.fetch_and_op(w[0], target=0, op=ReduceOp.MAX, index=1),
             win.fetch_and_op(w[3], target=3, op=ReduceOp.REPLACE, index=3))
        return r + (win.fence().buffer,)
    (out["fo_sum"], out["cas_hit"], out["cas_miss"], out["ga_noop"], out["fo_max"],
     out["fo_replace"], out["atomics_buffer"]) = per_rank(atomics, w0)

    def pytree(k, v):
        agg = KV(k=k, v=v)
        win = onesided.Window(comm, jax.tree_util.tree_map(jnp.zeros_like, agg),
                              WindowSpec(num_pages=3)).fence()
        futures.when_all([win.rput(agg, [(N - 1, 1)], page=p) for p in range(3)]).get()
        buf = win.fence().buffer
        return buf.k, buf.v
    out["pytree_k"], out["pytree_v"] = per_rank(pytree, k0, v0)

    def rget(w):
        win = onesided.Window(comm, w).fence()
        got = win.rget([(2, 0), (0, 3)]).get()
        win.fence()
        return got
    out["rget"] = per_rank(rget, w0)

    def ordering(w):
        win = onesided.Window(comm, jnp.zeros((4,), jnp.float32)).fence()
        f1 = win.raccumulate(jnp.full((4,), 5.0, jnp.float32), target=2, op=ReduceOp.REPLACE)
        f2 = f1.then(lambda f: (f.get(), win.raccumulate(
            jnp.ones((4,), jnp.float32), target=2, op=ReduceOp.SUM).get())[1])
        futures.when_all([f1, f2]).get()
        return win.fence().buffer
    out["order_buffer"] = per_rank(ordering, w0)

    def replace(x):
        win = onesided.Window(comm, jnp.zeros((4,), jnp.float32)).fence()
        win.accumulate(x + 10.0, target=3, op=ReduceOp.REPLACE)
        return win.fence().buffer
    out["replace_buffer"] = per_rank(replace, val)

    def ledger(w):
        win = onesided.Window(comm, jnp.zeros((8,), jnp.float32)).fence()
        win.put(jnp.full((8,), 1.0, jnp.float32), [(0, 3)], page=(0, 2))
        win.put(jnp.full((8,), 2.0, jnp.float32), [(1, 3)], page=(1, 2))
        try:
            win.put(jnp.full((8,), 3.0, jnp.float32), [(2, 3)])
            refused = False
        except errors.RankError:
            refused = True
        win.fence()
        win.fence()
        win.put(jnp.full((8,), 4.0, jnp.float32), [(2, 3)])
        return jnp.asarray(refused), win.fence().buffer
    out["ledger_error"], out["ledger_buffer"] = per_rank(ledger, w0)

    def empty(w, x):
        win = onesided.Window(comm, w).fence()
        win.put(x, [])
        return win.fence().buffer
    out["empty_buffer"] = per_rank(empty, w0, val)

    def dynamic(w):
        win = onesided.Window(comm, jnp.zeros((8,), jnp.float32),
                              WindowSpec(dynamic=True, num_pages=4))
        win.attach([1, 2]).fence()
        win.put(jnp.arange(8.0, dtype=jnp.float32) + comm.rank(), [(0, 2)], page=1)
        try:
            win.put(jnp.arange(8.0, dtype=jnp.float32), [(1, 2)], page=3)
            refused = False
        except errors.RmaRangeError:
            refused = True
        win.fence()
        win.detach([1])
        return jnp.asarray(refused), win.buffer, jnp.asarray(sorted(win.attached_pages))
    out["dynamic_error"], out["dynamic_buffer"], out["dynamic_attached"] = per_rank(dynamic, w0)
    np.savez(work + "/jax.npz", **out)
    print("JAX_RMA_OK")
""")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("rma")
    rng = np.random.default_rng(0)
    # integer-valued floats: every sum and product is exact in any order
    np.savez(work / "inputs.npz",
             w0=rng.integers(-3, 4, size=(WORLD, 4)).astype(np.float32),
             val=rng.integers(1, 4, size=(WORLD, 4)).astype(np.float32),
             bits=rng.integers(0, 16, size=(WORLD, 4)).astype(np.int32),
             k=rng.integers(-9, 9, size=(WORLD, 2, 3)).astype(np.float32),
             v=rng.integers(-9, 9, size=(WORLD, 4)).astype(np.int32))
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("rma", WORLD, work)
    finish_jax(jax_proc, "JAX_RMA_OK")
    ranks[0]["__work__"] = np.array(str(work))
    return ranks, dict(np.load(work / "jax.npz"))


_RMA = ["ops_get", "ops_buffer", "bits_buffer", "spec_buffer", "fo_sum", "cas_hit", "cas_miss",
        "ga_noop", "fo_max", "fo_replace", "atomics_buffer", "pytree_k", "pytree_v", "rget",
        "order_buffer", "replace_buffer", "ledger_error", "ledger_buffer", "empty_buffer",
        "dynamic_error", "dynamic_buffer", "dynamic_attached"]


@pytest.mark.parametrize("name", _RMA)
def test_rma_numerics_equal_the_reference(both, name):
    ranks, ref = both
    for r in range(WORLD):
        got, want = ranks[r][name], ref[name][r]
        assert got.shape == want.shape, (name, r, got.shape, want.shape)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{name} r{r}")


def test_rma_markers_hold(both):
    """The reference test's own expectations, on 4 ranks: the ledger and
    dynamic refusals, the issue order of chained requests, the paged
    aggregate landing whole on its target."""

    ranks, _ = both
    for r in range(WORLD):
        assert bool(ranks[r]["ledger_error"]) and bool(ranks[r]["dynamic_error"])
        assert np.array_equal(ranks[r]["dynamic_attached"], [2])
    assert np.array_equal(ranks[2]["order_buffer"], np.full(4, 5.0 + WORLD))
    assert np.array_equal(ranks[3]["ledger_buffer"], np.full(8, 4.0))
    inputs = np.load(ranks[0]["__work__"].item() + "/inputs.npz")
    assert np.array_equal(ranks[1]["pytree_k"], inputs["k"][WORLD - 1])
    assert np.array_equal(ranks[1]["pytree_v"], inputs["v"][WORLD - 1])
