"""The port's request layer against the reference's (``tests/test_requests.py``
mirrored): argument binding (``ERR_REQUEST`` on drift), donation
bookkeeping, the warm start on owned zeros, continuations on every start,
the pvar counts, and the persistent collectives on 4 gloo ranks against the
reference's on 4 virtual JAX devices (the same per-rank inputs, made with
numpy from a seed; floats to 1e-6, integers exactly).

The CUDA graph path of :class:`PersistentRequest` runs here through
``graph_stub`` (the capture and replay stood in on the CPU): the buffers
the graph reads, the copies into them, recapture, release, the launch
counts and the typed failures."""

from __future__ import annotations

import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_stub
from repro import core as mpx
from repro.core import errors as jerrors
from repro.core.futures import PersistentRequest as JRequest
from repro_torch.core import errors, futures, tool
from repro_torch.core.communicator import world
from repro_torch.core.futures import PersistentRequest
from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)

WORLD = 4


# ---------------------------------------------------------------------------
# argument binding, donation, warm start, continuations, pvars
# ---------------------------------------------------------------------------

_DRIFT = {
    # (example argument, drifted argument), as numpy
    "shape": (np.zeros((4,), np.float32), np.ones((5,), np.float32)),
    "dtype": (np.zeros((4,), np.float32), np.ones((4,), np.int32)),
    "structure": ({"a": np.zeros((2,), np.float32)},
                  {"a": np.ones((2,), np.float32), "b": np.ones((2,), np.float32)}),
}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("case", sorted(_DRIFT))
def test_start_drift_raises_as_the_reference(case):
    example, drifted = _DRIFT[case]
    first = (lambda t: t["a"] + 1.0) if isinstance(example, dict) else (lambda x: x * 2.0)
    jreq = JRequest(jax.jit(first), (_jax(example),))
    with pytest.raises(jerrors.RequestError):
        jreq.start(_jax(drifted))
    req = PersistentRequest(first, (_torch(example),))
    with pytest.raises(errors.RequestError):
        req.start(_torch(drifted))
    assert req.starts == 0


def test_donation_bookkeeping():
    """``donate_argnums`` is kept as the reference keeps it and marks the
    leaves of the donated arguments; on the CPU the request stays eager."""

    jreq = JRequest(jax.jit(lambda x: x + 1.0, donate_argnums=(0,)),
                    (jax.ShapeDtypeStruct((8,), jnp.float32),), donate_argnums=(0,))
    req = PersistentRequest(lambda x, w: x.add_(w), (torch.zeros(8), torch.ones(8)),
                            donate_argnums=(0,))
    assert req.donate_argnums == jreq.donate_argnums == (0,)
    assert req._donated == [True, False]
    assert not req.captures and req.settled  # CPU tensors: eager
    inp = torch.zeros(8)
    out = req.start(inp, torch.ones(8)).get()
    want = np.asarray(jreq.start(jnp.zeros((8,), jnp.float32)).get())
    np.testing.assert_array_equal(out.numpy(), want)
    assert out is inp  # the donated buffer is updated in place and handed on
    with pytest.raises(errors.ArgError):
        PersistentRequest(lambda x: x, (torch.zeros(2),), donate_argnums=(1,))


def test_warm_start_runs_on_owned_zeros():
    seen = []

    def step(x):
        seen.append(x.clone())
        return x.add_(1.0)   # in place: the warm start must not touch the example

    example = torch.full((4,), 7.0)
    req = PersistentRequest(step, (example,), donate_argnums=(0,), warm_start=True)
    assert len(seen) == 1 and torch.equal(seen[0], torch.zeros(4))
    assert torch.equal(example, torch.full((4,), 7.0))
    assert req.starts == 0
    out = req.start(torch.full((4,), 1.0)).get()
    jreq = JRequest(jax.jit(lambda x: x + 1.0), (jnp.full((4,), 7.0),), warm_start=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jreq.start(jnp.full((4,), 1.0)).get()))


def test_continuations_chain_on_every_start():
    req = PersistentRequest(lambda x: x + 1.0, (torch.tensor(0.0),))
    req.then(lambda f: f.get() * 10.0).then(lambda f: f.get() + 5.0)
    jreq = JRequest(jax.jit(lambda x: x + 1.0), (jax.ShapeDtypeStruct((), jnp.float32),))
    jreq.then(lambda f: f.get() * 10.0).then(lambda f: f.get() + 5.0)
    for v in (1.0, 2.0):
        assert float(req.start(torch.tensor(v)).get()) == float(
            jreq.start(jnp.float32(v)).get())
    assert req.starts == jreq.starts == 2


def test_start_counts_pvars():
    tool.pvar_reset()
    req = PersistentRequest(lambda x: x, (torch.tensor(0.0),))
    req.start(torch.tensor(0.0)).get()
    req.start(torch.tensor(1.0)).get()
    counts = tool.pvar_read()
    assert counts["persistent_init"] == 1 and counts["persistent_start"] == 2
    # a rejected start is not an MPI_Start event
    with pytest.raises(errors.RequestError):
        req.start(torch.ones(3))
    assert tool.pvar_read()["persistent_start"] == 2 and req.starts == 2


def test_init_pvars_are_the_references():
    from repro.core import tool as jtool

    names = [f"{n}_init" for n in ("allreduce", "alltoall", "reduce_scatter", "allgather")]
    assert all(n in jtool.pvar_info() and n in tool.pvar_info() for n in names)
    comm = world(device_type="cpu")
    before = tool.pvar_read()
    comm.allreduce_init(torch.ones(3))
    comm.allgather_init({"a": torch.ones(2), "n": torch.ones(2, dtype=torch.int32)})
    after = tool.pvar_read()
    assert after["allreduce_init"] - before["allreduce_init"] == 1
    assert after["allgather_init"] - before["allgather_init"] == 1
    # one request per dtype bucket: 1 + 2
    assert after["persistent_init"] - before["persistent_init"] == 3


def test_comm_persistent_matches_the_reference():
    """``comm.persistent`` binds this rank's step, which may call the
    communicator's collectives; on a world of one the reference's SPMD
    step gives the same values."""

    x = np.arange(6, dtype=np.float32)
    jcomm = mpx.world()
    jreq = jcomm.persistent(lambda a: jcomm.allreduce(a) * 2.0, jnp.asarray(x))
    comm = world(device_type="cpu")
    req = comm.persistent(lambda a: comm.allreduce(a) * 2.0, torch.from_numpy(x),
                          donate_argnums=(0,))
    assert isinstance(req, PersistentRequest) and req.donate_argnums == (0,)
    np.testing.assert_array_equal(req.start(torch.from_numpy(x)).get().numpy(),
                                  np.asarray(jreq.start(jnp.asarray(x)).get()))


def test_flatten_and_unflatten_hold_no_reference_cycle():
    """Dropping the results frees the leaves at once, without the cyclic
    garbage collector (a recursive closure would keep them in a cycle)."""

    import gc
    import weakref

    tree = {"a": [torch.zeros(3), (torch.ones(2), None)],
            "b": _State(torch.zeros(1), torch.ones(1))}
    leaves, treedef = futures.flatten(tree)
    refs = [weakref.ref(t) for t in leaves]
    gc.disable()
    try:
        rebuilt = futures.unflatten(treedef, leaves)
        assert futures.flatten(rebuilt)[1] == treedef
        del tree, leaves, rebuilt
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the CUDA graph path, with graph_stub standing in for capture and replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _State:
    acc: torch.Tensor      # updated in place
    pos: torch.Tensor      # a fresh tensor each step


def _decode_like(w, state, tok):
    """A decode step's shape: weights read, state updated in place, pos
    advanced into a new tensor, a fresh token read."""

    state.acc.add_(w * tok + state.pos)
    return state.acc.sum() * 1.0, _State(state.acc, state.pos + 1)


def _eager_run(w, n, toks):
    state = _State(torch.zeros(3), torch.zeros((), dtype=torch.int64))
    outs = []
    for t in toks[:n]:
        y, state = _decode_like(w, state, t)
        outs.append(float(y))
    return outs, state


def _graph_run(w, toks, req=None):
    state = _State(torch.zeros(3), torch.zeros((), dtype=torch.int64))
    req = req or PersistentRequest(_decode_like, (w, state, toks[0]), donate_argnums=(1,))
    outs = []
    for t in toks:
        y, state = req(w, state, t)
        outs.append(float(y))
    return req, outs, state


def _toks(n, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(float(v)) for v in rng.integers(1, 9, size=n)]


def test_graph_replays_bound_buffers(monkeypatch):
    graph_stub.install(monkeypatch)
    w, toks = torch.tensor([1.0, 2.0, 3.0]), _toks(6)
    req, outs, state = _graph_run(w, toks)
    want, want_state = _eager_run(w, 6, toks)
    assert req.captures and req.settled and req.captured == 1 and req.starts == 6
    assert req._graph.replays == 5          # start 1 eager, start 2 captured and replayed
    assert outs == want and torch.equal(state.acc, want_state.acc)
    assert int(state.pos) == int(want_state.pos) == 6
    # the graph reads the weights and the donated state in place, the token
    # from its own copy
    assert req._in_place == [True, True, True, False]
    assert req._bound[0] is w and req._bound[3] is not toks[1]


def test_graph_copies_a_donated_leaf_that_moved(monkeypatch):
    graph_stub.install(monkeypatch)
    w, toks = torch.tensor([1.0, 2.0, 3.0]), _toks(5)
    req, _, state = _graph_run(w, toks[:3])
    bound_acc, pos = req._bound[1], int(state.pos)
    fresh = _State(torch.full((3,), 5.0), state.pos.clone())
    y, out = req(w, fresh, toks[3])
    assert req.captured == 1            # copied in, not captured again
    assert out.acc is bound_acc and int(out.pos) == pos + 1
    assert float(y) == float((torch.full((3,), 5.0) + w * toks[3] + pos).sum())
    # the last start's outputs are the graph's static buffers: overwritten
    assert state.pos is out.pos


def test_graph_captures_again_when_a_read_leaf_moves(monkeypatch):
    graph_stub.install(monkeypatch)
    w, toks = torch.tensor([1.0, 2.0, 3.0]), _toks(6)
    req, _, state = _graph_run(w, toks[:3])
    w2 = torch.tensor([-1.0, 0.5, 2.0])
    acc_before = state.acc.clone()
    y, state = req(w2, state, toks[3])
    # captured again; w2 was not the previous start's buffer, so the new
    # graph reads it from a copy of its own
    assert req.captured == 2 and not req._in_place[0] and torch.equal(req._bound[0], w2)
    assert float(y) == float((acc_before + w2 * toks[3] + 3).sum())


def test_release_captures_again_without_an_eager_start(monkeypatch):
    graph_stub.install(monkeypatch)
    w, toks = torch.tensor([1.0, 2.0, 3.0]), _toks(6)
    req, outs, _ = _graph_run(w, toks[:3])
    req.release()
    assert not req.settled and req._bound == []
    calls = []

    def counted(*args):
        calls.append(1)
        return _decode_like(*args)

    req._fn = counted
    _, outs2, _ = _graph_run(w, toks[:3], req)
    assert req.captured == 2 and outs2 == outs
    assert len(calls) == 1 + 3   # the stub's capture run, then its three replays


def test_graph_replays_count_the_captured_launches(monkeypatch):
    graph_stub.install(monkeypatch)
    counted = {"n": 0}

    def add(n):
        counted["n"] += n

    launch = tool.launch_counter("test_requests_kernel", add)

    def step(state, x):
        launch()
        launch()
        return state.add_(x)

    req = PersistentRequest(step, (torch.zeros(2), torch.ones(2)), donate_argnums=(0,))
    state = torch.zeros(2)
    for _ in range(5):
        state = req(state, torch.ones(2))
    # start 1 counted by the step itself; the capture recorded 2 and every
    # replay (4) added them back; the stub's own re-runs of the step are
    # replays, whose Python the card never runs, so they count once each
    assert req._launches == {"test_requests_kernel": 2}
    assert torch.equal(state, torch.full((2,), 5.0))
    assert counted["n"] == 2 + 4 * 2 + 4 * 2


def test_graph_drift_raises_with_error_checking_off(monkeypatch):
    graph_stub.install(monkeypatch)
    req = PersistentRequest(lambda s, x: s.add_(x), (torch.zeros(2), torch.ones(2)),
                            donate_argnums=(0,))
    s = req(torch.zeros(2), torch.ones(2))
    s = req(s, torch.ones(2))
    tool.cvar_set("error_checking", False)
    try:
        with pytest.raises(errors.RequestError):
            req(s, torch.ones(1))   # a copy would broadcast it
    finally:
        tool.cvar_set("error_checking", True)


def test_scalar_argument_keeps_the_step_eager(monkeypatch):
    """A graph would bake a Python scalar in: such a request stays eager,
    and a new value at a later start takes effect."""

    graph_stub.install(monkeypatch)
    req = PersistentRequest(lambda s, k: s.add_(k), (torch.zeros(2), 1.0), donate_argnums=(0,))
    assert not req.captures
    s = req(req(torch.zeros(2), 1.0), 1.0)
    assert torch.equal(req(s, 2.0), torch.full((2,), 4.0)) and req.captured == 0


@pytest.mark.parametrize("failure,klass", [
    (RuntimeError("operation not permitted when stream is capturing"), errors.ErrorClass.ERR_OTHER),
    (torch.OutOfMemoryError("CUDA out of memory"), errors.ErrorClass.ERR_NO_MEM),
])
def test_failed_capture_raises_typed_with_no_eager_fallback(monkeypatch, failure, klass):
    graph_stub.install(monkeypatch)

    def refuse(fn, args):
        raise failure

    monkeypatch.setattr(futures, "_graph_capture", refuse)
    calls = []

    def step(s):
        calls.append(1)
        return s.add_(1.0)

    req = PersistentRequest(step, (torch.zeros(2),), donate_argnums=(0,))
    s = req(torch.zeros(2))
    with pytest.raises(errors.Error) as e:
        req(s)
    assert e.value.klass == klass and len(calls) == 1 and req.starts == 1


def test_stays_eager_without_donation_or_off_the_card(monkeypatch):
    assert not PersistentRequest(lambda x: x, (torch.zeros(2),), donate_argnums=(0,)).captures
    graph_stub.install(monkeypatch)
    assert not PersistentRequest(lambda x: x, (torch.zeros(2),)).captures
    assert not PersistentRequest(lambda x, a: x, (torch.zeros(2), np.zeros(2)),
                                 donate_argnums=(0,)).captures


# ---------------------------------------------------------------------------
# persistent collectives: 4 gloo ranks against 4 virtual JAX devices
# ---------------------------------------------------------------------------

JAX_SIDE = textwrap.dedent("""
    import dataclasses
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import core as mpx
    from repro.core import errors

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    comm = mpx.world()
    assert comm.size() == 4, comm.size()
    devs = list(comm.mesh.devices.flat)

    def per_rank(a):
        # rank r's value as device r's shard of a replicated array: the
        # persistent collectives bind replicated operands (P())
        return jax.make_array_from_single_device_arrays(
            a.shape[1:], NamedSharding(comm.mesh, P()),
            [jax.device_put(a[r], d) for r, d in enumerate(devs)])

    def shards(x):
        by = {s.device: np.asarray(s.data) for s in x.addressable_shards}
        return np.stack([by[d] for d in devs])

    @dataclasses.dataclass
    class Grads:
        w: object
        b: object
        n: object

    def grads(i):
        return Grads(*(per_rank(inp[k][i]) for k in ("w", "b", "n")))

    out = {}
    single = comm.allreduce_init(per_rank(inp["x"][0]))
    for i in range(2):
        out[f"allreduce_single_{i}"] = shards(single.start(per_rank(inp["x"][i])).get())
    for name in ("allreduce", "reduce_scatter", "allgather"):
        req = getattr(comm, f"{name}_init")(grads(0))
        out[f"{name}_buckets"] = np.array([len(req.requests)] * 4)
        for i in range(2):
            got = req.start(grads(i)).get()
            leaves = [got.w, got.b, got.n] if name == "allreduce" else got
            for j, leaf in enumerate(leaves):
                out[f"{name}_{i}_{j}"] = shards(leaf)
        g = grads(0)
        try:
            req.start(Grads(g.w, g.b, g.n.astype(jnp.float32)))
            drift = False
        except errors.RequestError:
            drift = True
        out[f"{name}_drift"] = np.array([drift] * 4)
    out["starts"] = np.array([single.starts] * 4)
    np.savez(work + "/jax.npz", **out)
    print("JAX_REQUESTS_OK")
""")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("requests")
    rng = np.random.default_rng(0)
    # (start, rank, ...): two starts on other values; w and b make a
    # float32 bucket of 12 and n an int32 bucket of 4, both divisible by 4
    np.savez(work / "inputs.npz",
             x=rng.uniform(0.5, 1.5, size=(2, WORLD, 8)).astype(np.float32),
             w=rng.standard_normal((2, WORLD, 4, 2), dtype=np.float32),
             b=rng.standard_normal((2, WORLD, 4), dtype=np.float32),
             n=rng.integers(-1000, 1000, size=(2, WORLD, 4)).astype(np.int32))
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("requests", WORLD, work)
    finish_jax(jax_proc, "JAX_REQUESTS_OK")
    return ranks, dict(np.load(work / "jax.npz"))


_OUTPUTS = (["allreduce_single_0", "allreduce_single_1", "starts"]
            + [f"{n}_{k}" for n in ("allreduce", "reduce_scatter", "allgather")
               for k in ("buckets", "drift")]
            + [f"allreduce_{i}_{j}" for i in range(2) for j in range(3)]
            + [f"{n}_{i}_{j}" for n in ("reduce_scatter", "allgather")
               for i in range(2) for j in range(2)])


@pytest.mark.parametrize("name", _OUTPUTS)
def test_persistent_collective_equals_the_reference(both, name):
    ranks, ref = both
    for r in range(WORLD):
        got, want = ranks[r][name], ref[name][r]
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (name, r, got.shape, got.dtype, want.shape, want.dtype)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"{name} r{r}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} r{r}")


def test_persistent_collectives_give_buckets_and_bind_the_aggregate(both):
    ranks, _ = both
    for r in ranks:
        assert int(r["allreduce_buckets"]) == 2 and bool(r["allreduce_drift"])
        # shape-changing: the raw float32 and int32 buckets, blocks of 12 / 4 and 4 / 4
        assert r["reduce_scatter_0_0"].shape == (3,) and r["reduce_scatter_0_1"].shape == (1,)
        assert r["allgather_0_0"].shape == (48,) and r["allgather_0_1"].dtype == np.int32
        assert int(r["starts"]) == 2
