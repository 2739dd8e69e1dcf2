"""The port's collectives on 4 gloo ranks (one process each) against the
reference's on 4 virtual JAX devices: the same per-rank inputs, made with
numpy from a seed, through every ported collective, the typed errors of bad
calls, and the shift exchanges of a 2 x 2 cart (periodic rows,
non-periodic columns).  The two sides run at once.

Floats are held at 1e-6 (sums taken in another order), integers and
booleans exactly."""

from __future__ import annotations

import textwrap

import numpy as np
import pytest
import torch

from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)

WORLD = 4

JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import core as mpx
    from repro.core import errors, topology
    from repro.core.descriptors import CollectiveSpec, ReduceOp

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    comm = mpx.world()
    assert comm.size() == 4, comm.size()
    W = P("world")

    def per_rank(fn, *arrays, c=comm, spec=W):
        body = lambda *a: jax.tree.map(lambda t: jnp.asarray(t)[None], fn(*[t[0] for t in a]))
        f = c.spmd(body, in_specs=tuple(spec for _ in arrays), out_specs=spec)
        return jax.tree.map(np.asarray, f(*arrays))

    def err(fn):
        try:
            fn()
        except errors.Error as e:
            return e.klass.name
        return "none"

    x, ints, xv = (jnp.asarray(inp[k]) for k in ("x", "ints", "xv"))
    out = {
        "allreduce_sum": per_rank(lambda a: comm.allreduce(a), x),
        "allreduce_max": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.MAX), x),
        "allreduce_min": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.MIN), x),
        "allreduce_prod": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.PROD), x),
        "allreduce_land": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.LAND), ints),
        "allreduce_lor": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.LOR), ints),
        "allreduce_lxor": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.LXOR), ints),
        "allreduce_band": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.BAND), ints),
        "allreduce_bor": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.BOR), ints),
        "allreduce_bxor": per_rank(lambda a: comm.allreduce(a, op=ReduceOp.BXOR), ints),
        "broadcast": per_rank(lambda a: comm.broadcast(a, root=2), x),
        "reduce": per_rank(lambda a: comm.reduce(a, root=1), x),
        "reduce_scatter": per_rank(lambda a: comm.reduce_scatter(a), x),
        "allgather": per_rank(lambda a: comm.allgather(a), x),
        "allgather_stacked": per_rank(
            lambda a: comm.allgather(a, spec=CollectiveSpec(tiled=False)), x),
        "allgather_axis1": per_rank(lambda a: comm.allgather(a, spec=CollectiveSpec(axis=1)), x),
        "gather": per_rank(lambda a: comm.gather(a, root=3), x),
        "scatter": per_rank(lambda a: comm.scatter(a, root=1), x),
        "alltoall": per_rank(lambda a: comm.alltoall(a), x),
        "alltoall_0_1": per_rank(lambda a: comm.alltoall(a, split_axis=0, concat_axis=1), x),
        "allgatherv": per_rank(lambda a: comm.allgatherv(a, (3, 1, 4, 2)), xv),
        "alltoallv": per_rank(lambda a: comm.alltoallv(a, (2, 1, 2, 1))[0], x),
        "scan_sum": per_rank(lambda a: comm.scan(a), x),
        "scan_max": per_rank(lambda a: comm.scan(a, op=ReduceOp.MAX), x),
        "scan_prod": per_rank(lambda a: comm.scan(a, op=ReduceOp.PROD), x),
        "exscan_sum": per_rank(lambda a: comm.exscan(a), x),
        "exscan_min": per_rank(lambda a: comm.exscan(a, op=ReduceOp.MIN), x),
        "send_recv": per_rank(lambda a: comm.send_recv(a, [(0, 2), (2, 1), (1, 0)]), x),
        "shift": per_rank(lambda a: comm.shift(a), x),
        "shift_nowrap": per_rank(lambda a: comm.shift(a, offset=-1, wrap=False), x),
        "immediate_allreduce": per_rank(lambda a: comm.immediate_allreduce(a).get(), x),
        "immediate_shift": per_rank(lambda a: comm.immediate_shift(a, 2).get(), x),
        "barrier": per_rank(lambda a: comm.barrier(), x),
    }
    tree = per_rank(lambda a, b: comm.allreduce({"a": a, "b": [b, a[:2]]}), x, ints)
    out["tree_a"], out["tree_b0"], out["tree_b1"] = tree["a"], tree["b"][0], tree["b"][1]
    cart = topology.cart_create(comm, (2, 2), (True, False), axis_names=("row", "col"))
    RC = P(("row", "col"))
    for dim in (0, 1):
        for disp in (1, -1):
            out[f"cart_shift_{dim}_{disp}"] = per_rank(
                lambda a: cart.shift_exchange(a, dim, disp).get(), x, c=cart, spec=RC)
    errs = {
        "bad_root": err(lambda: per_rank(lambda a: comm.broadcast(a, root=4), x)),
        "bad_reduce_root": err(lambda: per_rank(lambda a: comm.reduce(a, root=-1), x)),
        "bad_scatter": err(lambda: per_rank(lambda a: comm.reduce_scatter(a[:, :1].T), x)),
        "bad_counts": err(lambda: per_rank(lambda a: comm.allgatherv(a, (1, 2, 3)), xv)),
        "bad_padding": err(lambda: per_rank(lambda a: comm.allgatherv(a[:3], (3, 1, 4, 2)), xv)),
    }
    out.update({"err_" + k: np.array(v) for k, v in errs.items()})
    np.savez(work + "/jax.npz", **out)
    print("JAX_COLLECTIVES_OK")
""")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    np.savez(work / "inputs.npz",
             x=rng.uniform(0.5, 1.5, size=(WORLD, 8, 6)).astype(np.float32),
             ints=rng.choice(np.array([0, 1, 2, 3, 5], np.int32), size=(WORLD, 8, 6)),
             xv=rng.standard_normal((WORLD, 4, 6), dtype=np.float32))
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("collectives", WORLD, work)
    finish_jax(jax_proc, "JAX_COLLECTIVES_OK")
    return ranks, dict(np.load(work / "jax.npz"))


_OPS = ["allreduce_sum", "allreduce_max", "allreduce_min", "allreduce_prod", "allreduce_land",
        "allreduce_lor", "allreduce_lxor", "allreduce_band", "allreduce_bor", "allreduce_bxor",
        "broadcast", "reduce", "reduce_scatter", "allgather", "allgather_stacked",
        "allgather_axis1", "gather", "scatter", "alltoall", "alltoall_0_1", "allgatherv",
        "alltoallv", "scan_sum", "scan_max", "scan_prod", "exscan_sum", "exscan_min",
        "send_recv", "shift", "shift_nowrap", "immediate_allreduce", "immediate_shift",
        "barrier", "tree_a", "tree_b0", "tree_b1", "cart_shift_0_1", "cart_shift_0_-1",
        "cart_shift_1_1", "cart_shift_1_-1"]


@pytest.mark.parametrize("name", _OPS)
def test_collective_equals_the_reference(both, name):
    ranks, ref = both
    for r in range(WORLD):
        got, want = ranks[r][name], ref[name][r]
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (name, r, got.shape, got.dtype, want.shape, want.dtype)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=f"{name} r{r}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} r{r}")


@pytest.mark.parametrize("case", ["bad_root", "bad_reduce_root", "bad_scatter", "bad_counts",
                                  "bad_padding"])
def test_error_classes_equal_the_reference(both, case):
    ranks, ref = both
    want = str(ref[f"err_{case}"])
    assert want != "none"
    assert [str(r[f"err_{case}"]) for r in ranks] == [want] * WORLD


def test_cart_coordinates_fold_row_major(both):
    ranks, _ = both
    assert [tuple(r["coords"]) for r in ranks] == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
