"""The port's elastic shrink and grow, end to end, against the reference's
(``tests/test_elastic_runtime.py``'s ``SHRINK_CODE``, ``GROW_CODE`` and
``RESHARD_CODE``): 4 gloo ranks as a (data 2, model 2) grid beside the
reference's same scenarios on 4 virtual JAX devices, from the same init
(the reference's, converted), the tiny dense model in fp32 and a frozen
``StepGuard.clock``.

* Shrink: rank 2 is evicted at step 5; the trainer revokes its epoch,
  shrinks to the 3 survivors, folds 2 of them onto (1, 2) (the third
  idles), restores step 4's manifest and trains to step 8.  The losses
  from the restore on equal, bit for bit, those of a fresh trainer restored
  from the same manifest on the same fold.
* Grow: rank 1 is evicted at step 5, and at step 8 the spare rank is
  admitted: the pool grows back to 4 and the grid to (2, 2), the joiners
  receiving the live state.  One step build per epoch on the ranks that
  train through all three.
* The reference's structural assertions on every rank (final step,
  evictions, joins, epoch, world size, builds, ``elastic:recovery_steps``,
  the manifests' ``{"epoch", "world_size"}`` tags), every step's loss
  within 1e-5 relative of the reference's, and the revoked epochs' process
  groups destroyed.
* Reshard: a checkpoint written on the 2 x 2 fabric restores onto a 1 x 2
  one, placed.
* After the grow, a fresh fabric laid out as the revoked (1, 2) fold
  trains: DTensor's cached sharding decisions never hand back a destroyed
  mesh (C18).
* On one rank, through the CUDA graph path (``graph_stub``): a grow by no
  members releases the old step's graph, builds and captures once more,
  and keeps the uninterrupted run's steps; evicting the only rank raises
  ``ERR_PROC_FAILED`` with the graph released.
"""

from __future__ import annotations

import json
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.models import api as japi

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import (  # noqa: E402
    ELASTIC_CFG,
    ELASTIC_SCENARIOS,
    finish_jax,
    finish_ranks,
    start_jax,
    start_ranks,
)

#: fp32 throughout: the two frameworks sum in other orders
LOSS_RTOL = 1e-5

JAX_SIDE = textwrap.dedent("""
    import json, sys, tempfile
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint import CheckpointManager
    from repro.configs.base import ModelConfig, ParallelConfig
    from repro.core import tool
    from repro.core.communicator import Communicator
    from repro.core.session import Session
    from repro.runtime.faults import FaultInjector
    from repro.runtime.trainer import Trainer, TrainerConfig

    CFG, SCENARIOS = %r, %r
    work = sys.argv[1]
    inputs = dict(np.load(work + "/inputs.npz"))
    cfg = ModelConfig(**CFG)

    def tcfg(ckpt, steps):
        return TrainerConfig(steps=steps, lr=1e-3, checkpoint_dir=ckpt,
                             checkpoint_every=2, log_every=1, seed=7)

    def comm_for(group, data):
        return Communicator.from_group(group, tag="repro://train", shape=(data, 2),
                                       axis_names=("data", "model"))

    def trainer(steps, comm, injector=None, ckpt=None):
        t = Trainer(cfg, ParallelConfig(), tcfg(ckpt or tempfile.mkdtemp(), steps), comm,
                    seq_len=32, global_batch=12, injector=injector, clock=lambda: 0.0)
        init = t.init_state

        def checked():
            params, opt_state = init()
            leaves = jax.tree_util.tree_flatten_with_path(params)[0]
            for path, leaf in leaves:
                key = "param/" + "/".join(str(k.key) for k in path)
                assert np.array_equal(np.asarray(leaf), inputs[key]), key
            return params, opt_state

        t.init_state = checked
        return t

    sess = Session.init()
    world = sess.group("repro://world")
    out = {}
    for name, (steps, evictions, admissions) in SCENARIOS.items():
        inj = FaultInjector()
        for step, r in evictions:
            inj.evict_rank(step, r)
        for step, count in admissions:
            inj.admit_rank(step, count)
        t = trainer(steps, comm_for(world, 2), inj)
        t0 = tool.pvar_read().get("trace:train_step", 0)
        r0 = tool.pvar_read().get("elastic:recovery_steps", 0)
        res = t.run()
        out[name] = {k: res[k] for k in ("final_step", "evictions", "joins", "restarts",
                                         "epoch", "world_size")}
        out[name]["traces"] = tool.pvar_read()["trace:train_step"] - t0
        out[name]["recovery_steps"] = tool.pvar_read()["elastic:recovery_steps"] - r0
        out[name]["steps"] = [m["step"] for m in res["metrics"]]
        out[name]["losses"] = [m["loss"] for m in res["metrics"]]
        out[name]["meta"] = {str(s): t.ckpt.manifest_meta(s) for s in t.ckpt.steps()}
        out[name]["mesh_data"] = t.comm.mesh.shape["data"]

    # RESHARD_CODE on 4 devices: (2, 2) -> (1, 2)
    ckpt = tempfile.mkdtemp()
    big = comm_for(world, 2)
    w = jax.device_put(jnp.arange(96, dtype=jnp.float32).reshape(12, 8),
                       NamedSharding(big.mesh, P("data", "model")))
    m1 = CheckpointManager(ckpt, async_save=False)
    m1.save(1, {"w": w, "b": jnp.float32(3.0)}, meta={"epoch": 0, "world_size": 4})
    m1.wait()
    small = comm_for(world.excl([1, 3]), 1)
    tmpl = jax.device_put(jnp.zeros((12, 8), jnp.float32),
                          NamedSharding(small.mesh, P("data", "model")))
    got, step = CheckpointManager(ckpt).restore(
        {"w": tmpl, "b": jnp.float32(0.0)},
        shardings={"w": NamedSharding(small.mesh, P("data", "model")), "b": None})
    out["reshard"] = {"meta": m1.manifest_meta(), "step": step,
                      "w": np.asarray(got["w"]).tolist(), "b": float(got["b"]),
                      "data": got["w"].sharding.mesh.shape["data"]}
    with open(work + "/jax.json", "w") as f:
        json.dump(out, f)
    print("JAX_ELASTIC_OK")
""" % (ELASTIC_CFG, ELASTIC_SCENARIOS))


def _param_entries(params) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    work = tmp_path_factory.mktemp("elastic")
    init = jax.jit(japi.build(jbase.ModelConfig(**ELASTIC_CFG)).init)(jax.random.PRNGKey(7))
    np.savez(work / "inputs.npz", work=str(work), **_param_entries(init))
    proc = start_jax(JAX_SIDE, work)
    ranks = finish_ranks(start_ranks("elastic", 4, work, timeout=300.0))
    finish_jax(proc, "JAX_ELASTIC_OK")
    with open(work / "jax.json") as f:
        return ranks, json.load(f)


def _int(x) -> int:
    return int(np.asarray(x))


def test_shrink_restores_onto_the_survivors_as_a_fresh_trainer_does(elastic):
    """SHRINK_CODE: the structure of the run on every rank, the manifests'
    tags, and the losses from the restore on equal the fresh trainer's,
    restored from the same manifest on the same fold, bit for bit."""

    ranks, ref = elastic
    want = ref["shrink"]
    assert (want["final_step"], want["evictions"], want["restarts"], want["epoch"],
            want["world_size"], want["traces"], want["recovery_steps"]) == (8, 1, 0, 1, 2, 2, 1)
    for r, out in enumerate(ranks):
        for key in ("final_step", "evictions", "restarts", "epoch", "world_size"):
            assert _int(out[f"shrink/{key}"]) == want[key], (r, key)
        assert list(out["shrink/comm_ranks"]) == [0, 1]    # the survivors' fold
        assert bool(out["shrink/member"]) is (r in (0, 1))
        # one step build per epoch the rank trains in; rank 2 is evicted,
        # rank 3 idles (the fold of 3 survivors onto (1, 2) leaves it over)
        assert _int(out["shrink/traces"]) == (2 if r in (0, 1) else 1), r
        assert _int(out["shrink/recovery_steps"]) == (1 if r in (0, 1) else 0), r
        assert list(out["shrink/retired"]) == [0]
        assert bool(out["shrink/destroyed_gone"])
        meta = {int(k): v for k, v in json.loads(str(out["shrink/meta"])).items()}
        assert meta[4] == {"epoch": 0, "world_size": 4} == ref["shrink"]["meta"]["4"]
        assert meta[8] == {"epoch": 1, "world_size": 2} == ref["shrink"]["meta"]["8"]
    for r in (0, 1):
        elastic_tail = dict(zip(ranks[r]["shrink/steps"][5:], ranks[r]["shrink/losses"][5:]))
        control_tail = {s: x for s, x in zip(ranks[r]["control/steps"],
                                             ranks[r]["control/losses"]) if s > 4}
        assert set(elastic_tail) == set(control_tail) == {5, 6, 7, 8}
        for s in (5, 6, 7, 8):
            assert elastic_tail[s] == control_tail[s], (s, elastic_tail, control_tail)


def test_grow_readmits_the_spare_and_folds_back(elastic):
    """GROW_CODE: evicted at 5, admitted at 8 — three epochs, the grid back
    at (2, 2) on every rank, one build per epoch on the ranks that train
    through all three, the joiners' state the survivors'."""

    ranks, ref = elastic
    want = ref["grow"]
    assert (want["final_step"], want["evictions"], want["joins"], want["epoch"],
            want["world_size"], want["traces"], want["mesh_data"]) == (10, 1, 1, 2, 4, 3, 2)
    for r, out in enumerate(ranks):
        for key in ("final_step", "evictions", "joins", "restarts", "epoch", "world_size"):
            assert _int(out[f"grow/{key}"]) == want[key], (r, key)
        assert bool(out["grow/member"]) and list(out["grow/comm_ranks"]) == [0, 1, 2, 3]
        assert _int(out["grow/traces"]) == (3 if r in (0, 2) else 2), r
        assert list(out["grow/retired"]) == [0, 1]
        assert bool(out["grow/destroyed_gone"])
        np.testing.assert_array_equal(out["grow/params"], ranks[0]["grow/params"])
    # the survivors' (1, 2) fold had its own groups, destroyed at the grow;
    # a fresh fabric laid out as that fold trains (DTensor's cached sharding
    # decisions name meshes by layout: they are cleared with the groups)
    assert _int(ranks[0]["grow/destroyed"]) > 0
    for r in (0, 2):
        assert np.isfinite(ranks[r]["after_revoke/loss"])
        assert float(ranks[r]["after_revoke/loss"]) == float(ranks[0]["after_revoke/loss"])
    # the joiners record the steps after their admission, as the others do
    for r in (1, 3):
        assert list(ranks[r]["grow/steps"][-2:]) == [9, 10]
        np.testing.assert_array_equal(ranks[r]["grow/losses"][-2:],
                                      ranks[0]["grow/losses"][-2:])


@pytest.mark.parametrize("name", list(ELASTIC_SCENARIOS))
def test_elastic_losses_hold_the_reference(elastic, name):
    """Every logged step's loss (replayed steps included) within 1e-5
    relative of the reference's same scenario on 4 virtual devices."""

    ranks, ref = elastic
    for r in (0,):
        out = ranks[r]
        assert list(out[f"{name}/steps"]) == ref[name]["steps"]
        np.testing.assert_allclose(out[f"{name}/losses"], ref[name]["losses"],
                                   rtol=LOSS_RTOL, atol=0)


def test_checkpoint_restores_onto_a_different_world_size(elastic):
    """RESHARD_CODE: written under (2, 2), restored onto the (1, 2) fold of
    two ranks, placed, equal to what was written; the manifest's tags."""

    ranks, ref = elastic
    want = ref["reshard"]
    w = np.arange(96, dtype=np.float32).reshape(12, 8)
    assert want["meta"] == {"epoch": 0, "world_size": 4} and want["data"] == 1
    np.testing.assert_array_equal(np.array(want["w"], np.float32), w)
    for r, out in enumerate(ranks):
        assert json.loads(str(out["reshard/meta"])) == want["meta"]
        if r in (0, 2):
            assert _int(out["reshard/step"]) == want["step"] == 1
            np.testing.assert_array_equal(out["reshard/w"], w)
            assert float(out["reshard/b"]) == want["b"] == 3.0
            assert _int(out["reshard/data"]) == want["data"]
        else:
            assert "reshard/w" not in out


# ---------------------------------------------------------------------------
# the transition on one rank, through the graph path (graph_stub)
# ---------------------------------------------------------------------------


def _one_rank_trainer(injector=None, **tcfg):
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    return Trainer(ModelConfig(**ELASTIC_CFG), ParallelConfig(),
                   TrainerConfig(steps=4, lr=1e-3, log_every=1, seed=7, **tcfg), device="cpu",
                   seq_len=32, global_batch=4, injector=injector, clock=lambda: 0.0)


def test_transition_releases_the_graph_and_captures_once_more(monkeypatch):
    """``chip_smoke.py``'s ``elastic`` phase on the CPU: a grow by no
    members before step 3 revokes the epoch (``ERR_REVOKED``), releases its
    step's graph, builds the successor's step once (it runs start 1 eagerly
    and captures at start 2) and the steps stay bit for bit the
    uninterrupted run's; the eager trainer's too."""

    import graph_stub

    from repro_torch.core import errors, tool
    from repro_torch.runtime.faults import FaultInjector

    graph_stub.install(monkeypatch)
    whole = _one_rank_trainer()
    want = [(m["loss"], m["grad_norm"]) for m in whole.run()["metrics"]]
    assert whole._request.captured == 1
    eager = _one_rank_trainer(persistent=False)
    assert [(m["loss"], m["grad_norm"]) for m in eager.run()["metrics"]] == want
    assert eager._request is None

    moved = _one_rank_trainer(FaultInjector().admit_rank(2))
    seen = {}

    def grow(count, params, opt_state):
        seen["epoch"], seen["request"] = moved.epoch, moved._request
        return moved._admit((), params, opt_state)

    moved._grow = grow
    builds = tool.pvar_read()["trace:train_step"]
    result = moved.run()
    assert tool.pvar_read()["trace:train_step"] - builds == 2
    assert result["epoch"] == 1 and result["world_size"] == 1 and result["joins"] == 0
    with pytest.raises(errors.RevokedError):
        seen["epoch"].comm
    old = seen["request"]
    assert old._graph is None and old.captured == 1
    assert moved._request is not old and moved._request.captured == 1
    assert moved.retired == [seen["epoch"]] and seen["epoch"].destroyed == []
    assert [(m["loss"], m["grad_norm"]) for m in result["metrics"]] == want


def test_evicting_the_only_rank_leaves_no_graph(monkeypatch):
    import graph_stub

    from repro_torch.core import errors
    from repro_torch.runtime.faults import FaultInjector

    graph_stub.install(monkeypatch)
    t = _one_rank_trainer(FaultInjector().evict_rank(2, 0))
    with pytest.raises(errors.ProcFailedError):
        t.run()
    assert t.epoch.revoked and t._request.captured == 1 and t._request._graph is None
