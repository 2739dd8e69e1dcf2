"""The port's partitioned requests and gradient synchronisation against the
reference's (``tests/test_requests.py`` mirrored):

* ``PartitionedRequest``: results in index order whatever the ``pready``
  order, partitions issued in index order as the ready prefix grows, the
  reference's typed errors and its pvars;
* on 4 gloo ranks as a 2 x 2 grid ("outer", "inner") against 4 virtual
  JAX devices, the same per-rank inputs made with numpy from a seed:
  ``partitioned_allreduce`` with a chunk-wise continuation, partitions
  marked ready out of order,
  ``hierarchical_allreduce`` without and with int8 compression, and
  ``PartitionedGradSync`` in the reference test's three modes over two
  rounds (the second with the first's error-feedback residual), the ranks
  marking their buckets ready in different orders in one call (error
  feedback makes every leaf fp32, so that mode has one bucket), and
  ``sync_gradients`` in both orders and with the int8 stage alone over an
  fp32 and a bf16 bucket, ranks again in different orders.

Everything is held **bit for bit**.  Each reduction sums two ranks (a + b
is the same sum in either order): ``partitioned_allreduce`` runs over
``inner``, and the hierarchical form's stages over ``inner`` and ``outer``
(over all four ranks, gloo and XLA add in other orders).  The int8 stage
sums the dequantized shares in rank order 0, 1 on both sides, and the mean
scales by 1/4 or 1/2, exact in binary.  The reference's SPMD body runs
eagerly (``jit=False``): under ``jit`` XLA multiplies by the reciprocal of
127 where the quantize divides (ROADMAP C5), which moves some scales by an
ulp; eagerly it divides, as the port does.
"""

from __future__ import annotations

import itertools
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import tool as jtool
from repro.core.futures import PartitionedRequest as JRequest
from repro_torch.core import errors, tool
from repro_torch.core.futures import PartitionedRequest
from repro_torch.optim import PartitionedGradSync

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import GRAD_SYNC_MODES, finish_jax, run_ranks, start_jax  # noqa: E402

torch.set_num_threads(1)

WORLD = 4


# ---------------------------------------------------------------------------
# PartitionedRequest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", list(itertools.permutations(range(3))))
def test_pready_order_independence_and_index_order_issue(order):
    """Any ``pready`` order gives the results in index order, as the
    reference's; the port issues partition i once 0..i are ready."""

    issued = []

    def fn(i, x):
        issued.append(i)
        return x * (i + 1.0)

    req = PartitionedRequest(fn, 3).start()
    jreq = JRequest(lambda i, x: x * (i + 1.0), 3).start()
    prefix = []
    for i in order:
        req.pready(i, torch.tensor(2.0))
        jreq.pready(i, 2.0)
        prefix = [j for j in range(3) if all(k in order[:order.index(i) + 1]
                                              for k in range(j + 1))]
        assert issued == prefix
    assert [float(r) for r in req.wait()] == [float(r) for r in jreq.wait()] == [2.0, 4.0, 6.0]
    assert issued == [0, 1, 2]


def test_partitioned_protocol_errors_match_the_reference():
    with pytest.raises(errors.Error) as ei:
        PartitionedRequest(lambda i, x: x, 0)
    assert ei.value.klass == errors.ErrorClass.ERR_COUNT
    req = PartitionedRequest(lambda i, x: x, 2)
    for call, klass in ((lambda: req.pready(0, 1.0), errors.ErrorClass.ERR_REQUEST),
                        (lambda: req.start() and req.start(), errors.ErrorClass.ERR_REQUEST)):
        with pytest.raises(errors.Error) as ei:
            call()
        assert ei.value.klass == klass
    req.pready(0, torch.tensor(1.0))
    for call, klass in ((lambda: req.pready(0, 1.0), errors.ErrorClass.ERR_REQUEST),
                        (lambda: req.pready(5, 1.0), errors.ErrorClass.ERR_REQUEST),
                        (lambda: req.pready(-1, 1.0), errors.ErrorClass.ERR_REQUEST),
                        (lambda: req.parrived(2), errors.ErrorClass.ERR_REQUEST),
                        (req.wait, errors.ErrorClass.ERR_PENDING)):
        with pytest.raises(errors.Error) as ei:
            call()
        assert ei.value.klass == klass
    req.pready(1, torch.tensor(2.0))
    assert [float(r) for r in req.wait()] == [1.0, 2.0]
    req.start()  # persistent: reusable after wait
    assert not req.parrived(0)


def test_partition_future_waits_for_its_prefix():
    """A partition marked ready before an earlier one is not issued: its
    future raises ERR_PENDING until the prefix is ready, then holds its
    result, which a later round does not overwrite."""

    req = PartitionedRequest(lambda i, x: x + i, 2).start()
    second = req.pready(1, torch.tensor(5.0))
    assert not req.parrived(1)
    with pytest.raises(errors.Error) as ei:
        second.get()
    assert ei.value.klass == errors.ErrorClass.ERR_PENDING
    req = PartitionedRequest(lambda i, x: x + i, 2).start()
    second = req.pready(1, torch.tensor(5.0))
    first = req.pready(0, torch.tensor(5.0))
    assert req.parrived(0) and req.parrived(1)
    assert [float(r) for r in req.wait()] == [5.0, 6.0]
    req.start()
    req.pready(0, torch.tensor(7.0))
    assert float(first.get()) == 5.0 and float(second.get()) == 6.0


def test_partitioned_pvars_match_the_reference():
    names = ("partitioned_init", "partitioned_start", "partition_ready")
    for name in names:
        assert tool.PVARS[name] == jtool.PVARS[name]
    before = {n: tool.pvar_counters[n] for n in names}
    req = PartitionedRequest(lambda i, x: x, 2).start()
    req.pready(1, torch.tensor(0.0))
    req.pready(0, torch.tensor(0.0))
    req.wait()
    req.start()
    assert {n: tool.pvar_counters[n] - before[n] for n in names} == \
        {"partitioned_init": 1, "partitioned_start": 2, "partition_ready": 2}


@pytest.mark.parametrize("case", ["for_epoch"])
def test_unported_grad_sync_paths_raise(case):
    """The epoch-derived sync (``tests/test_epoch.py``'s last case): one
    per epoch, over the epoch's communicator; a shrink revokes it
    (``ERR_REVOKED``) and the successor builds its own, whose gradients
    reduce over the survivors (a world of one: the gradients themselves)."""

    from repro_torch.core.epoch import CommEpoch, TopologySpec
    from repro_torch.core.session import default_session

    world = default_session(device_type="cpu").group("repro://world")
    epoch = CommEpoch.create(world, TopologySpec((-1,), ("data",)), name="gs_" + case)
    sync = PartitionedGradSync.for_epoch(epoch)
    assert sync.inner is epoch.comm and PartitionedGradSync.for_epoch(epoch) is sync
    survivors = epoch.shrink([])
    with pytest.raises(errors.Error) as ei:
        PartitionedGradSync.for_epoch(epoch)
    assert ei.value.klass == errors.ErrorClass.ERR_REVOKED
    rebuilt = PartitionedGradSync.for_epoch(survivors)
    assert rebuilt is not sync and rebuilt.inner is survivors.comm
    grads = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3, dtype=torch.bfloat16)}
    synced, _ = rebuilt(grads)
    for k in grads:
        assert torch.equal(synced[k], grads[k])


# ---------------------------------------------------------------------------
# 4 gloo ranks against 4 virtual JAX devices
# ---------------------------------------------------------------------------

JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core import overlap
    from repro.core.communicator import Communicator
    from repro.core.descriptors import Compression
    from repro.optim.grad_sync import ErrorFeedbackState, PartitionedGradSync, sync_gradients

    MODES = %s
    work = sys.argv[1]
    inp = {k: jnp.asarray(v) for k, v in np.load(work + "/inputs.npz").items()}
    comm = Communicator.create((2, 2), ("outer", "inner"))
    inner, outer = comm.split("inner"), comm.split("outer")

    @comm.spmd(out_specs=P(("outer", "inner")), jit=False)
    def run():
        r = comm.rank()
        out = {"rank": r}
        req = inner.partitioned_allreduce(3, continuation=lambda i, y: y + i)
        for i in (2, 0, 1):
            req.pready(i, inp["pa"][r, i])
        for i, y in enumerate(req.wait()):
            out[f"partitioned_{i}"] = y
        for c in (Compression.NONE, Compression.INT8):
            out[f"hier_{c.value}"] = overlap.hierarchical_allreduce(
                inp["hx"][r], inner, outer, compression=c)

        def grads(i):
            return {"w": inp["w"][r, i], "b": inp["b"][r, i],
                    "h": inp["h"][r, i].astype(jnp.bfloat16)}

        for name, hier, int8 in MODES:
            sync = PartitionedGradSync(
                inner, outer if hier else None,
                compression=Compression.INT8 if int8 else Compression.NONE)
            ef = ErrorFeedbackState.init(grads(0)) if int8 else None
            for i in range(2):
                got, ef = sync(grads(i), ef)
                for k, v in got.items():
                    out[f"{name}_{i}_{k}"] = v.astype(jnp.float32)
                if int8:
                    for k, v in ef.residual.items():
                        out[f"{name}_{i}_residual_{k}"] = v
        for order in ((0, 1), (1, 0)):
            got, _ = sync_gradients(grads(0), inner, outer, pready_order=order)
            for k, v in got.items():
                out[f"order_{order[0]}{order[1]}_{k}"] = v.astype(jnp.float32)
        got, _ = sync_gradients(grads(1), inner, outer, compression=Compression.INT8)
        for k, v in got.items():
            out[f"int8_no_ef_{k}"] = v.astype(jnp.float32)
        return {k: jnp.asarray(v)[None] for k, v in out.items()}

    np.savez(work + "/jax.npz", **{k: np.asarray(v) for k, v in run().items()})
    print("JAX_GRAD_SYNC_OK")
""") % repr(GRAD_SYNC_MODES)


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """fp32 values that bf16 holds exactly, so that both packages cast them
    to the same bf16 numbers."""

    return (x.astype(np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("grad_sync")
    rng = np.random.default_rng(0)
    np.savez(work / "inputs.npz",
             pa=rng.standard_normal((WORLD, 3, 6), dtype=np.float32),
             hx=(3.0 * rng.standard_normal((WORLD, 1000))).astype(np.float32),
             w=rng.standard_normal((WORLD, 2, 37, 11), dtype=np.float32),
             b=(0.01 * rng.standard_normal((WORLD, 2, 300))).astype(np.float32),
             h=_bf16_exact(rng.standard_normal((WORLD, 2, 5, 7))))
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("grad_sync", WORLD, work)
    finish_jax(jax_proc, "JAX_GRAD_SYNC_OK")
    return ranks, dict(np.load(work / "jax.npz"))


_OUTPUTS = (["rank", "hier_none", "hier_int8"] + [f"partitioned_{i}" for i in range(3)]
            + [f"{name}_{i}_{k}" for name, _, _ in GRAD_SYNC_MODES for i in range(2)
               for k in "bhw"]
            + [f"hier_int8_ef_{i}_residual_{k}" for i in range(2) for k in "bhw"]
            + [f"order_{o}_{k}" for o in ("01", "10") for k in "bhw"]
            + [f"int8_no_ef_{k}" for k in "bhw"])


@pytest.mark.parametrize("name", _OUTPUTS)
def test_partitioned_forms_equal_the_reference(both, name):
    """Every output of every rank bit for bit the reference's (ranks 1 and
    2 marked their gradient buckets ready in the other order)."""

    ranks, ref = both
    for r in range(WORLD):
        got, want = ranks[r][name], ref[name][r]
        assert got.shape == want.shape, (name, r, got.shape, want.shape)
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{name} r{r}")


def test_int8_stage_compresses_and_feedback_carries(both):
    """The int8 stage is not the exact sum, error feedback leaves a residual
    under a quantum of its block, and the orders agree on every rank."""

    ranks, _ = both
    for r in ranks:
        assert not np.array_equal(r["hier_int8"], r["hier_none"])
        np.testing.assert_allclose(r["hier_int8"], r["hier_none"], atol=0.2, rtol=0)
        res = r["hier_int8_ef_0_residual_w"]
        assert np.any(res != 0) and np.abs(res).max() < np.abs(r["hier_int8_ef_0_w"]).max()
        for k in "bhw":
            np.testing.assert_array_equal(r[f"order_01_{k}"], r[f"order_10_{k}"])
