"""The cart schedules under the pipeline plan against the reference:
``overlap.halo_exchange`` and ``overlap.pipeline_spmd`` on 4 gloo ranks
(one process each) beside the reference's ``PIPELINE_CODE``
(``tests/test_overlap.py``) on 4 virtual JAX devices, the two sides at
once: the boundary slices each rank receives (zeros beyond a line's edge)
and the microbatches drained in order, each scaled by every stage.
"""

from __future__ import annotations

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import finish_jax, run_ranks, start_jax  # noqa: E402

WORLD = 4
M = 3

JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import core as mpx
    from repro.core import overlap, topology

    work = sys.argv[1]
    xs = jnp.asarray(np.load(work + "/inputs.npz")["xs"])
    comm = mpx.world()
    S = comm.size()
    out = {}
    for label, periodic in (("line", False), ("ring", True)):
        cart = topology.cart_create(comm, (S,), (periodic,), tag="halo-" + label)

        def halo(x, cart=cart):
            lo, hi = overlap.halo_exchange(cart, x + cart.rank().astype(x.dtype),
                                           dim=0, axis=0, width=2).get()
            return jnp.stack([lo, hi])

        out["halo_" + label] = np.asarray(cart.spmd(halo, out_specs=P("cart0"))(
            jnp.zeros((4,), jnp.float32))).reshape(S, 2, 2)
    cart = topology.cart_create(comm, (S,), (False,), tag="pipeline")

    def pipe(xs):
        stage = jax.lax.axis_index("cart0").astype(jnp.float32)
        outs = overlap.pipeline_spmd(
            cart, stage_dim=0, num_microbatches=xs.shape[0],
            inject=lambda i: xs[i],
            stage_fn=lambda state, t: state * (stage + 1.0),
            extract=lambda i, state, is_last: jnp.where(is_last, state, 0.0),
        )
        return jnp.stack([jax.lax.psum(o, "cart0") for o in outs])

    out["pipeline"] = np.asarray(cart.spmd(pipe)(xs))
    np.savez(work + "/jax.npz", **out)
    print("JAX_PIPELINE_OK")
""")


@pytest.fixture(scope="module")
def schedules(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    xs = np.arange(1, M + 1, dtype=np.float32)[:, None] * np.ones((M, 4), np.float32)
    np.savez(work / "inputs.npz", xs=xs)
    jax_proc = start_jax(JAX_SIDE, work, n=WORLD)
    ranks = run_ranks("pipeline_schedule", WORLD, work)
    finish_jax(jax_proc, "JAX_PIPELINE_OK")
    return xs, ranks, dict(np.load(work / "jax.npz"))


@pytest.mark.parametrize("label", ["line", "ring"])
def test_halo_exchange_matches_reference(schedules, label):
    _, ranks, ref = schedules
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"halo_{label}"], ref[f"halo_{label}"][r])
        lo = r - 1 if r > 0 or label == "ring" else None
        hi = r + 1 if r < WORLD - 1 or label == "ring" else None
        np.testing.assert_array_equal(got[f"halo_{label}"][0],
                                      np.full(2, lo % WORLD if lo is not None else 0.0))
        np.testing.assert_array_equal(got[f"halo_{label}"][1],
                                      np.full(2, hi % WORLD if hi is not None else 0.0))


def test_pipeline_schedule_matches_reference(schedules):
    xs, ranks, ref = schedules
    factor = float(np.prod(np.arange(1, WORLD + 1)))
    for got in ranks:
        np.testing.assert_array_equal(got["pipeline"], ref["pipeline"])
        np.testing.assert_array_equal(got["pipeline"], xs * factor)
