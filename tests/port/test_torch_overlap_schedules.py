"""The decomposed ring schedules of ``core/overlap.py`` on 4 gloo ranks (one
process each) against the reference's on 4 virtual JAX devices, the same
per-rank inputs made with numpy from a seed, the two sides run at once: the
ring cases of ``tests/test_overlap.py`` (``ring_all_gather``, its
bidirectional form, ``ring_reduce_scatter``) on axes 0 and 1, the
reduce-scatter's error on an axis that does not divide,
``RingAllGatherFuture``'s ``get`` and ``then_matmul`` through
``comm.immediate_ring_allgather`` and its pvar, the ``immediate_*``
helpers, and the partitioned rings of ``tests/test_requests.py`` (with its
chunk-wise continuation) in two ``pready`` orders.

Gathers and exchanges are held exactly; reductions in fp32 within 1e-6
(the same sums in the same ring order), the fused product within 1e-5
(the blocks' matmuls summed in ring order on both sides); the two
``pready`` orders bit for bit."""

from __future__ import annotations

import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import overlap
from repro_torch.core.communicator import world
from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)

WORLD = 4

JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import core as mpx
    from repro.core import errors, overlap, tool

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    comm = mpx.world()
    assert comm.size() == 4, comm.size()
    W = P("world")

    def per_rank(fn, *arrays):
        body = lambda *a: jax.tree.map(lambda t: jnp.asarray(t)[None], fn(*[t[0] for t in a]))
        f = comm.spmd(body, in_specs=tuple(W for _ in arrays), out_specs=W)
        return jax.tree.map(np.asarray, f(*arrays))

    def err(fn):
        try:
            fn()
        except errors.Error as e:
            return e.klass.name
        return "none"

    x, y, y1, w, xf, p0, p1 = (jnp.asarray(inp[k]) for k in
                               ("x", "y", "y1", "w", "xf", "p0", "p1"))
    out = {}
    for a in (0, 1):
        out[f"gather{a}"] = per_rank(lambda t: overlap.ring_all_gather(comm, t, axis=a), x)
        out[f"bidir{a}"] = per_rank(
            lambda t: overlap.ring_all_gather_bidirectional(comm, t, axis=a), x)
    out["rs0"] = per_rank(lambda t: overlap.ring_reduce_scatter(comm, t, axis=0), y)
    out["rs1"] = per_rank(lambda t: overlap.ring_reduce_scatter(comm, t, axis=1), y1)
    before = tool.pvar_read().get("immediate_ring_allgather", 0)
    out["future_get"], out["then_matmul"] = per_rank(
        lambda t, wt, xt: (comm.immediate_ring_allgather(t, axis=1).get(),
                           comm.immediate_ring_allgather(wt).then_matmul(xt).get()), x, w, xf)
    out["pvar"] = np.full((4,), tool.pvar_read()["immediate_ring_allgather"] - before)
    out["imm_allgather"] = per_rank(lambda t: overlap.immediate_all_gather(comm, t).get(), x)
    out["imm_allreduce"] = per_rank(lambda t: overlap.immediate_all_reduce(comm, t).get(), x)
    out["imm_reduce_scatter"] = per_rank(
        lambda t: overlap.immediate_reduce_scatter(comm, t, axis=0).get(), y)
    out["imm_send_recv"] = per_rank(
        lambda t: overlap.immediate_send_recv(comm, t, [(0, 2), (2, 1), (1, 0)]).get(), x)
    for kind, fn, pay in (("rs", overlap.partitioned_ring_reduce_scatter, (y, p0)),
                          ("ag", overlap.partitioned_ring_all_gather, (x, p1))):
        def part(a0, a1, fn=fn):
            req = fn(comm, 2, continuation=lambda i, g: g.sum() + i)
            req.pready(1, a1)
            req.pready(0, a0)
            return tuple(req.wait())
        for i, r in enumerate(per_rank(part, *pay)):
            out[f"part_{kind}{i}"] = r
    out["err_rs"] = np.array(err(
        lambda: per_rank(lambda t: overlap.ring_reduce_scatter(comm, t, axis=0), y1)))
    np.savez(work + "/jax.npz", **out)
    print("JAX_OVERLAP_SCHEDULES_OK")
""")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("overlap_schedules")
    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.standard_normal((WORLD,) + shape, dtype=np.float32)

    xf = rng.standard_normal((8, 16 * WORLD), dtype=np.float32)
    np.savez(work / "inputs.npz", x=f32(4, 8), y=f32(8, 6), y1=f32(6, 8), w=f32(16, 8),
             xf=np.broadcast_to(xf, (WORLD,) + xf.shape), p0=f32(4, 3), p1=f32(2, 5))
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("overlap_schedules", WORLD, work)
    finish_jax(jax_proc, "JAX_OVERLAP_SCHEDULES_OK")
    return ranks, dict(np.load(work / "jax.npz")), dict(np.load(work / "inputs.npz"))


_EXACT = ["gather0", "gather1", "bidir0", "bidir1", "future_get", "imm_allgather",
          "imm_send_recv", "pvar"]
_SUMS = ["rs0", "rs1", "imm_allreduce", "imm_reduce_scatter"]


def _same_layout(name, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (name, got.shape, got.dtype, want.shape, want.dtype)


@pytest.mark.parametrize("name", _EXACT)
def test_gathers_and_exchanges_equal_the_reference(both, name):
    ranks, ref, _ = both
    for r in range(WORLD):
        _same_layout(name, ranks[r][name], ref[name][r])
        np.testing.assert_array_equal(ranks[r][name], ref[name][r], err_msg=f"{name} r{r}")


@pytest.mark.parametrize("name", _SUMS)
def test_reductions_equal_the_reference(both, name):
    ranks, ref, _ = both
    for r in range(WORLD):
        _same_layout(name, ranks[r][name], ref[name][r])
        np.testing.assert_allclose(ranks[r][name], ref[name][r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} r{r}")


def test_then_matmul_equals_the_reference_and_the_gathered_product(both):
    """``then_matmul`` fuses the gather into the product (the reference's
    ``all_gather_matmul``); it equals ``x @ gather(w)``."""

    ranks, ref, inputs = both
    for r in range(WORLD):
        got = ranks[r]["then_matmul"]
        _same_layout("then_matmul", got, ref["then_matmul"][r])
        np.testing.assert_allclose(got, ref["then_matmul"][r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, inputs["xf"][r] @ np.concatenate(inputs["w"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["rs", "ag"])
def test_partitioned_rings_equal_the_reference_in_any_pready_order(both, kind):
    ranks, ref, _ = both
    for r in range(WORLD):
        for i in (0, 1):
            a, b = ranks[r][f"part_{kind}{i}_a"], ranks[r][f"part_{kind}{i}_b"]
            assert a.tobytes() == b.tobytes(), (kind, i, r)
            _same_layout(kind, a, ref[f"part_{kind}{i}"][r])
            np.testing.assert_allclose(a, ref[f"part_{kind}{i}"][r], rtol=1e-6, atol=1e-6)


def test_reduce_scatter_on_an_axis_that_does_not_divide(both):
    ranks, ref, _ = both
    assert str(ref["err_rs"]) == "ERR_COUNT"
    assert [str(r["err_rs"]) for r in ranks] == ["ERR_COUNT"] * WORLD


def test_one_rank_returns_the_input():
    """On a world of one every ring returns its input (the reference's
    ``n == 1`` shortcut), and the future's fused product is the plain one."""

    comm = world(device_type="cpu")
    assert comm.size() == 1
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5), generator=gen)
    for fn in (overlap.ring_all_gather, overlap.ring_all_gather_bidirectional,
               overlap.ring_reduce_scatter):
        assert fn(comm, x, axis=1) is x
    w = torch.randn((5, 4), generator=gen)
    assert torch.equal(comm.immediate_ring_allgather(x).get(), x)
    np.testing.assert_allclose(comm.immediate_ring_allgather(w).then_matmul(x).get().numpy(),
                               (x @ w).numpy(), rtol=1e-6, atol=1e-6)
