"""The port's topologies: the host-level tables copied from the reference
(the cart arithmetic, the neighbor edge sets and their matching rounds,
the serving fan-out helpers) equal it over grids, periods, graphs and P:D
splits, with the same refusals; a ``CartComm`` and a ``DistGraphComm``
answer on the world of one of this process; and the neighborhood
collectives and ``moe_neighbor`` run on 4 gloo ranks (one process each)
against the reference on 4 virtual JAX devices, the same per-rank inputs
from a seed (the cart's shift exchanges are in
``test_torch_collectives.py``)."""

from __future__ import annotations

import dataclasses
import itertools
import textwrap

import jax

import numpy as np
import pytest
import torch

from repro.core import errors as jerrors
from repro.core import topology as jtopo
from repro_torch.core import errors, topology
from repro_torch.core.communicator import world
from repro_torch.core.futures import Future, when_all, when_any
from repro_torch.launch.mesh import make_host_communicator
from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)

_GRIDS = [(4,), (2, 3), (3, 1, 2), (1,)]


def _periods(dims):
    return itertools.product((False, True), repeat=len(dims))


@pytest.mark.parametrize("dims", _GRIDS)
def test_cart_tables_equal_the_reference(dims):
    n = int(np.prod(dims))
    for r in range(n):
        assert topology.cart_coords_of(dims, r) == jtopo.cart_coords_of(dims, r)
    for periods in _periods(dims):
        for coords in itertools.product(*[range(-1, d + 1) for d in dims]):
            try:
                want = jtopo.cart_rank_of(dims, periods, coords)
            except jerrors.Error as e:
                with pytest.raises(errors.Error) as ei:
                    topology.cart_rank_of(dims, periods, coords)
                assert ei.value.klass.name == e.klass.name
                continue
            assert topology.cart_rank_of(dims, periods, coords) == want
        for dim in range(len(dims)):
            for disp in (1, -1, 2):
                assert topology.cart_shift_tables(dims, periods, dim, disp) == \
                    jtopo.cart_shift_tables(dims, periods, dim, disp)


def test_cart_shift_record_equals_the_reference():
    assert [f.name for f in dataclasses.fields(topology.CartShift)] == \
        [f.name for f in dataclasses.fields(jtopo.CartShift)]
    assert topology.PROC_NULL == jtopo.PROC_NULL


def test_cart_comm_queries_on_a_world_of_one():
    cart = topology.cart_create(world(device_type="cpu"), (1,), (True,), axis_names=("ring",))
    assert (cart.ndims, cart.dims, cart.periods, cart.size()) == (1, (1,), (True,), 1)
    assert cart.rank() == 0 and cart.coords() == (0,) and cart.cart_coords(0) == (0,)
    assert cart.cart_rank((3,)) == 0  # periodic: wraps
    shift = cart.cart_shift(0, 1)
    assert (shift.sources, shift.destinations, shift.axis_perm) == ((0,), (0,), ((0, 0),))
    x = torch.arange(6.0).reshape(2, 3)
    fut = cart.shift_exchange({"a": x, "b": [x + 1]}, 0, 1)
    got = fut.get()
    assert torch.equal(got["a"], x) and torch.equal(got["b"][0], x + 1)
    assert got["a"].data_ptr() != x.data_ptr()
    line = topology.cart_create(world(device_type="cpu"), (1,), (False,), tag="line-1")
    assert torch.equal(line.shift_exchange(x, 0, 1).get(), torch.zeros_like(x))  # PROC_NULL
    assert line.cart_sub([True]).dims == (1,)


def test_cart_over_one_axis_of_a_grid():
    comm = make_host_communicator(1, 1, device="cpu")
    cart = topology.CartComm(comm, ("model",), dims=(1,), periods=(True,))
    assert cart.axis_names == ("model",) and cart.device == torch.device("cpu")
    with pytest.raises(errors.Error) as ei:
        topology.CartComm(comm, ("model",), dims=(2,), periods=(True,))
    assert ei.value.klass == errors.ErrorClass.ERR_DIMS


def test_when_all_and_when_any():
    a, b = Future(torch.ones(2), works=()), Future(torch.zeros(2), works=())
    got, i = when_any([a, b])
    assert got is a and i == 0
    x, y = when_all([a, b]).get()
    assert torch.equal(x, torch.ones(2)) and torch.equal(y, torch.zeros(2))
    with pytest.raises(errors.Error) as ei:
        when_all([a])
    assert ei.value.klass == errors.ErrorClass.ERR_REQUEST


# ---------------------------------------------------------------------------
# the neighbor engine's host tables and the serving fan-out helpers
# ---------------------------------------------------------------------------


def _edges(edges):
    return [(e.src, e.dst, e.out_slot, e.in_slot) for e in edges]


@pytest.mark.parametrize("dims", _GRIDS + [(2,), (2, 2)])
def test_cart_edges_and_rounds_equal_the_reference(dims):
    for periods in _periods(dims):
        port, ref = topology.cart_edges(dims, periods), jtopo.cart_edges(dims, periods)
        assert _edges(port) == _edges(ref)
        assert [_edges(r) for r in topology._matching_rounds(port)] == \
            [_edges(r) for r in jtopo._matching_rounds(ref)]


_GRAPHS = {
    "star": ([[1, 2, 3], [0], [], []], [[1], [0], [0], [0]]),
    "ring_null": ([[3, -1], [0], [1], [2]], [[1], [2], [3], [0, -1]]),
    "repeated": ([[1, 1], [0, 0]], [[1, 1], [0, 0]]),
    "full": ([[0, 1, 2]] * 3, [[0, 1, 2]] * 3),
}


@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_graph_edges_and_rounds_equal_the_reference(name):
    srcs, dsts = _GRAPHS[name]
    port, ref = topology._build_edges(srcs, dsts), jtopo._build_edges(srcs, dsts)
    assert _edges(port) == _edges(ref)
    assert [_edges(r) for r in topology._matching_rounds(port)] == \
        [_edges(r) for r in jtopo._matching_rounds(ref)]


def test_inconsistent_graph_is_err_topology_in_both():
    for srcs, dsts in (([[1], []], [[], []]), ([[], []], [[1], []])):
        with pytest.raises(jerrors.Error) as je:
            jtopo._build_edges(srcs, dsts)
        with pytest.raises(errors.Error) as te:
            topology._build_edges(srcs, dsts)
        assert te.value.klass.name == je.value.klass.name == "ERR_TOPOLOGY"


@pytest.mark.parametrize("split", [(2, 2), (1, 3), (2, 6), (3, 5), (1, 1), (4, 4)])
def test_fanout_helpers_equal_the_reference(split):
    adj = topology.serving_fanout_adjacency(*split)
    assert adj == jtopo.serving_fanout_adjacency(*split)
    routes = topology.fanout_routes(*adj)
    assert routes == jtopo.fanout_routes(*adj)
    rounds = topology.fanout_rounds(routes)
    assert rounds == jtopo.fanout_rounds(routes)
    assert len(rounds) == -(-split[1] // split[0])
    for rnd in rounds:
        assert len({s for s, _ in rnd}) == len({d for _, d in rnd}) == len(rnd)


def test_fanout_refusals_equal_the_reference():
    """The refusals of the reference's engine tests: more prefill than
    decode ranks and an empty prefill side are ERR_DIMS; a graph over a
    bridge of the wrong size is ERR_TOPOLOGY."""

    for split in ((3, 2), (0, 4)):
        with pytest.raises(jerrors.Error) as je:
            jtopo.serving_fanout_adjacency(*split)
        with pytest.raises(errors.DimsError) as te:
            topology.serving_fanout_adjacency(*split)
        assert te.value.klass.name == je.value.klass.name
    with pytest.raises(errors.Error) as te:
        topology.serving_fanout_graph(world(device_type="cpu"), 1, 3)
    assert te.value.klass == errors.ErrorClass.ERR_TOPOLOGY


def test_dist_graph_on_a_world_of_one():
    """A self-loop graph: degrees, neighbors with weights, each
    neighborhood collective (and the persistent form, started twice)
    returns its input; bad adjacency raises the reference's classes."""

    comm = world(device_type="cpu")
    g = topology.dist_graph_create_adjacent(comm, [[0, -1]], [[0]], source_weights=[[2.0, 1.0]])
    assert (g.indegree(), g.outdegree(), g.dist_graph_neighbors_count(0)) == (2, 1, (2, 1))
    assert g.dist_graph_neighbors(0) == ((0, -1), (2.0, 1.0), (0,), (1.0,))
    x = torch.arange(6.0).reshape(1, 2, 3)
    got = g.neighbor_alltoall(x).get()
    assert torch.equal(got[0], x[0]) and torch.equal(got[1], torch.zeros_like(x[0]))
    assert torch.equal(g.neighbor_allgather(x[0]).get()[0], x[0])
    blocks, rc = g.neighbor_alltoallv(x, [[2]]).get()
    assert rc.tolist() == [2, 0] and torch.equal(blocks[0], x[0]) and not blocks[1].any()
    loop = topology.dist_graph_create_adjacent(comm, [[0]], [[0]])
    req = loop.neighbor_alltoall_init({"a": torch.zeros(4), "b": torch.zeros(2, dtype=torch.int32)})
    for i in range(2):
        v = {"a": torch.arange(4.0) + i, "b": torch.tensor([i, -i], dtype=torch.int32)}
        out = req.start(v).get()
        assert torch.equal(out["a"], v["a"]) and torch.equal(out["b"], v["b"])
    assert req.starts == 2
    for args, klass in ((([[5]], [[0]]), "ERR_RANK"), (([[0]], [[0], [0]]), "ERR_TOPOLOGY")):
        with pytest.raises(errors.Error) as ei:
            topology.dist_graph_create_adjacent(comm, *args)
        assert ei.value.klass.name == klass
    with pytest.raises(errors.Error) as ei:
        loop.neighbor_alltoall(torch.zeros(2, 3)).get()
    assert ei.value.klass == errors.ErrorClass.ERR_COUNT


# ---------------------------------------------------------------------------
# the neighborhood collectives and moe_neighbor on 4 gloo ranks
# ---------------------------------------------------------------------------

WORLD = 4

JAX_NEIGHBORS = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import core as mpx
    from repro.core import topology
    from repro.configs.base import ModelConfig
    from repro.models import mlp

    sys.path.insert(0, "tests/port")
    from torch_ranks import FULL_COUNTS, NEIGHBOR_GRAPHS

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    comm = mpx.world()
    N = comm.size()
    assert N == 4, N
    W = P("world")

    def per_rank(fn, *arrays, c=comm, spec=W):
        def body(*a):
            out = fn(*[t[0] for t in a])
            return jax.tree.map(lambda t: jnp.asarray(t)[None], out)
        f = c.spmd(body, in_specs=tuple(spec for _ in arrays), out_specs=spec)
        return jax.tree.map(np.asarray, f(*arrays))

    x, blocks = jnp.asarray(inp["x"]), jnp.asarray(inp["blocks"])
    out = {}
    cart = topology.cart_create(comm, (2, 2), (True, False), axis_names=("row", "col"))
    RC = P(("row", "col"))
    out["cart_allgather"] = per_rank(lambda a: cart.neighbor_allgather(a).get(), x,
                                     c=cart, spec=RC)
    out["cart_alltoall"] = per_rank(lambda b: cart.neighbor_alltoall(b[:, 0]).get(), blocks,
                                    c=cart, spec=RC)
    out["cart_alltoallv"], out["cart_alltoallv_rc"] = per_rank(
        lambda b: cart.neighbor_alltoallv(
            b, [[3, 1, 2, 0], [1, 1, 1, 1], [2, 0, 3, 1], [0, 2, 2, 3]]).get(),
        blocks, c=cart, spec=RC)
    for name, (srcs, dsts) in NEIGHBOR_GRAPHS.items():
        g = topology.dist_graph_create_adjacent(comm, srcs, dsts)
        out[f"{name}_degrees"] = np.array([[g.indegree(r), g.outdegree(r), g.indegree(),
                                            g.outdegree()] for r in range(N)])
        out[f"{name}_allgather"] = per_rank(lambda a: g.neighbor_allgather(a).get(), x, c=g)
        out[f"{name}_alltoall"] = per_rank(
            lambda b: g.neighbor_alltoall(
                b[: g.outdegree(), 0] + 1.0 + g.rank().astype(jnp.float32)).get(),
            blocks, c=g)
    full = topology.dist_graph_create_adjacent(comm, *NEIGHBOR_GRAPHS["full"])
    out["full_alltoallv"], out["full_alltoallv_rc"] = per_rank(
        lambda b: full.neighbor_alltoallv(b, FULL_COUNTS).get(), blocks, c=full)
    two = mpx.Communicator.create((2,), ("r",))
    pair = topology.cart_create(two, (2,), (True,))
    def nv(z):
        r = pair.rank().astype(jnp.float32)
        b = jnp.arange(6, dtype=jnp.float32).reshape(2, 3) + 1.0 + 10.0 * r
        got, rc = pair.neighbor_alltoallv(b[..., None], [3, 1]).get()
        return got[..., 0][None], rc[None]
    got, rc = pair.spmd(nv, out_specs=(P("cart0"), P("cart0")))(jnp.zeros((), jnp.float32))
    out["pair_alltoallv"], out["pair_rc"] = np.asarray(got), np.asarray(rc)
    ring = topology.cart_create(comm, (N,), (True,), tag="repro://cart/ring4")
    req = ring.neighbor_alltoall_init(jax.ShapeDtypeStruct((2, 8), jnp.float32))
    for i in range(2):
        out[f"persistent_{i}"] = np.asarray(req.start(jnp.asarray(inp["same"][i])).get())

    # moe_neighbor on the reference's weights
    m = dict(np.load(work + "/moe/inputs.npz"))
    cfg = ModelConfig(name="t", family="moe", num_layers=2, d_model=16, num_heads=2,
                      num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                      num_experts=2 * N, moe_top_k=2, moe_d_ff=24)
    for name, radius, capacity in (("full", None, None), ("r1", 1, None), ("r1_cap", 1, 3)):
        g = topology.dist_graph_create_adjacent(
            comm, *mlp.expert_dispatch_graph(N, cfg.num_experts, radius=radius))
        def run(xl, router, wg, wu, wd):
            y, aux = mlp.moe_neighbor({"router": router, "w_gate": wg, "w_up": wu,
                                       "w_down": wd}, xl, cfg, g, capacity=capacity)
            return y, jax.tree.map(lambda t: t[None], aux)
        y, aux = g.spmd(run, in_specs=(W, P(), W, W, W), out_specs=(W, W))(
            *(jnp.asarray(m[k]) for k in ("x", "router", "w_gate", "w_up", "w_down")))
        out[f"moe_{name}_y"] = np.asarray(y).reshape(N, -1, 16)
        for k, v in aux.items():
            out[f"moe_{name}_{k}"] = np.asarray(v)
    np.savez(work + "/jax.npz", **out)
    print("JAX_NEIGHBORS_OK")
""")


@pytest.fixture(scope="module")
def neighbors(tmp_path_factory):
    """Both programs' results, the reference's and the port's, from one
    run each side (the two sides at once)."""

    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import mlp as jmlp

    work = tmp_path_factory.mktemp("neighbors")
    rng = np.random.default_rng(0)
    np.savez(work / "inputs.npz",
             x=rng.integers(-9, 9, size=(WORLD, 3)).astype(np.float32),
             blocks=rng.integers(-9, 9, size=(WORLD, 4, 3, 2)).astype(np.float32),
             same=rng.integers(-9, 9, size=(2, 2, 8)).astype(np.float32))
    cfg = JModelConfig(name="t", family="moe", num_layers=2, d_model=16, num_heads=2,
                       num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                       num_experts=2 * WORLD, moe_top_k=2, moe_d_ff=24)
    p = jmlp.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    moe = {k: np.asarray(v) for k, v in p.items()}
    moe["x"] = rng.standard_normal((4 * WORLD, 16)).astype(np.float32)
    (work / "moe").mkdir()
    np.savez(work / "moe" / "inputs.npz", **moe)
    jax_proc = start_jax(JAX_NEIGHBORS, work)
    ranks = run_ranks("neighbors", WORLD, work)
    moe_ranks = run_ranks("moe_neighbor", WORLD, work / "moe")
    finish_jax(jax_proc, "JAX_NEIGHBORS_OK")
    return ranks, moe_ranks, dict(np.load(work / "jax.npz"))


_NEIGHBOR_CASES = (["cart_allgather", "cart_alltoall", "cart_alltoallv", "cart_alltoallv_rc",
                    "full_alltoallv", "full_alltoallv_rc"]
                   + [f"{g}_{op}" for g in ("star", "ring_null", "full")
                      for op in ("degrees", "allgather", "alltoall")])


@pytest.mark.parametrize("name", _NEIGHBOR_CASES)
def test_neighbor_collective_equals_the_reference(neighbors, name):
    ranks, _, ref = neighbors
    for r in range(WORLD):
        got, want = ranks[r][name], ref[name][r]
        assert got.shape == want.shape, (name, r, got.shape, want.shape)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{name} r{r}")


def test_size2_periodic_cart_alltoallv_counts(neighbors):
    """Both slots of a size-2 periodic dim name the same rank: the recv
    counts follow the cart slot pairing (the reference's regression)."""

    ranks, _, ref = neighbors
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["pair_rc"], ref["pair_rc"][r])
        np.testing.assert_array_equal(ranks[r]["pair_alltoallv"], ref["pair_alltoallv"][r])
    np.testing.assert_array_equal(ranks[0]["pair_alltoallv"], [[14, 0, 0], [11, 12, 13]])


def test_persistent_neighbor_alltoall_equals_the_reference(neighbors):
    ranks, _, ref = neighbors
    for r in range(WORLD):
        assert int(ranks[r]["persistent_starts"]) == 2
        for i in range(2):
            np.testing.assert_array_equal(ranks[r][f"persistent_{i}"], ref[f"persistent_{i}"])


@pytest.mark.parametrize("case", ["full", "r1", "r1_cap"])
def test_moe_neighbor_equals_the_reference(neighbors, case):
    """Expert-parallel dispatch over the router's expert graph: the same
    outputs (fp32, 1e-5: the expert products run in another library) and
    the same aux values, drops at the small capacity included."""

    _, ranks, ref = neighbors
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"{case}_y"], ref[f"moe_{case}_y"][r],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{case} r{r}")
        for k in ("load_balance_loss", "router_z_loss", "dropped_fraction"):
            np.testing.assert_allclose(ranks[r][f"{case}_{k}"], ref[f"moe_{case}_{k}"][r],
                                       rtol=1e-5, err_msg=f"{case} {k} r{r}")
    if case == "r1_cap":
        assert any(float(ranks[r]["r1_cap_dropped_fraction"]) > 0 for r in range(WORLD))
    assert all(bool(ranks[r]["narrow_graph_error"]) for r in range(WORLD))
