"""The ring over placed weights on gloo ranks against the reference on
virtual devices, and a dropped ``Trainer`` freed without a ``gc`` pass.

* Ring prefill (``tests/test_ring_attention.py``'s ``SERVER_RING`` model
  and prompts): a ``Server`` with ``ring_attention`` on a 1 x 2 and a 2 x 2
  grid places its parameters under ``param_specs`` (the reference's
  server's shardings on the same grid); on the reference's weights, placed
  so, its greedy tokens equal the reference's ring server's on the same
  grid, exactly (fp32 at temperature 0), and its prefill cache is placed
  under ``cache_specs``.
* The ring plan's state (``TRAINER_RING``'s model at seq 96, global batch
  8, ``ParallelPlan(ring=2)`` on 2 x 2 ranks): parameters and moments
  placed as the reference's ``_param_pspecs`` and ``_state_shardings``
  place them; 3 steps from the reference's init take its losses and grad
  norms within 1e-5 relative (fp32: the placement only reorders sums);
  ``placed`` set false is refused (``ERR_UNSUPPORTED_OPERATION``); the
  eager step (``persistent=False``) takes them bit for bit; the last
  step's checkpoint, written from the 4 ranks' fragments, restores on one
  rank and in the reference's manager.  Through an eviction and an
  admission the placed ring state re-folds (2, 2) → (1, 2) → (2, 2).
* phi4-mini's smoke model under ``--plan ring=4`` and ``tensor=4`` on a
  1 x 4 grid trains as the one-rank data plan does (within 2e-2, bf16);
  in fp32, from the reference's init, the two plans' trainers take the
  reference's losses and grad norms on 4 virtual devices within 1e-5, and
  the ring server on 1 x 4 its greedy tokens exactly.
* Two ranks with other hash salts serve the placed ring on 1 x 2 alike,
  the phi4-like model and zamba2's (ROADMAP C21; the zamba2 pair hangs
  without ``local._stable_placement_hashes``).
* A ``Trainer`` dropped after its captured step (the graph path through
  ``graph_stub``) leaves no reference to itself, its step request or its
  parameters, with the cyclic collector off, in a fresh Python (the first
  import of ``torch._dynamo`` is what used to pin it).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.models import api as japi
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.configs import base as tbase
from repro_torch.core import errors
from repro_torch.core.futures import flatten
from repro_torch.runtime.trainer import Trainer, TrainerConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import (  # noqa: E402
    FOUR_MODEL_RANKS,
    RING_SERVE_CFG,
    TRAIN_PLANS,
    finish_jax,
    finish_ranks,
    run_ranks,
    start_jax,
    start_ranks,
    train_plan_cfg,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
RTOL = 1e-5
GRIDS = ((1, 2), (2, 2))


def _param_entries(params) -> dict:
    return {"param/" + "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


JAX_SIDE = textwrap.dedent("""
    import dataclasses
    import sys
    import jax
    import numpy as np
    from repro.configs.base import ModelConfig, ParallelConfig, ParallelPlan
    from repro.core._compat import make_mesh
    from repro.launch.mesh import make_host_communicator
    from repro.runtime.server import Request, Server, ServerConfig
    from repro.runtime.trainer import Trainer, TrainerConfig

    work = sys.argv[1]

    def specs(tree):
        out = []
        for leaf in jax.tree_util.tree_leaves(tree):
            spec = tuple(leaf.sharding.spec) + (None,) * (leaf.ndim - len(leaf.sharding.spec))
            out.append(repr(tuple(None if a is None else
                                  ((a,) if isinstance(a, str) else tuple(a)) for a in spec)))
        return np.array(out)

    out = {}
    cfg = ModelConfig(**RING_SERVE_CFG)
    prompts = [np.arange(1, 33, dtype=np.int32), np.arange(5, 29, dtype=np.int32)]
    for dims in GRIDS:
        tag = "x".join(map(str, dims))
        mesh = make_mesh(dims, ("data", "model"))
        for name, pcfg in (("ring", dataclasses.replace(ParallelConfig(), ring_attention=True)),
                           ("base", ParallelConfig())):
            server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=4), mesh)
            out[f"{tag}/{name}/tokens"], _ = server.generate(
                [Request(tokens=p.copy()) for p in prompts])
            out[f"{tag}/{name}/specs"] = specs(server.params)
    seq, batch, plan, model = TRAIN_PLANS["ring"]
    tcfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                       head_dim=16, d_ff=128, dtype="float32", **model)
    t = Trainer(tcfg, ParallelConfig(), TrainerConfig(steps=3, log_every=1,
                                                      plan=ParallelPlan(**plan)),
                make_host_communicator(), seq_len=seq, global_batch=batch, clock=lambda: 0.0)
    params, opt_state = t.init_state()
    pshard, oshard = t._state_shardings(params, opt_state)
    out["train/param_specs"] = specs(params)
    out["train/moment_specs"] = specs((opt_state.mu, opt_state.nu))
    res = t.run()
    out["train/losses"] = np.array([m["loss"] for m in res["metrics"]])
    out["train/grad_norms"] = np.array([m["grad_norm"] for m in res["metrics"]])
    out["train/dims"] = np.array([t.mesh.shape[a] for a in t.comm.axis_names])
    np.savez(work + "/jax.npz", **out)
    print("JAX_RING_PLACED_OK")
""").replace("RING_SERVE_CFG", repr(RING_SERVE_CFG)).replace(
    "GRIDS", repr(GRIDS)).replace("TRAIN_PLANS", repr(TRAIN_PLANS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's side beside the port's ranks: the two grids' ring
    servers (2 and 4 ranks) and the placed ring trainer (4 ranks)."""

    root = tmp_path_factory.mktemp("ring_placed")
    jax_proc = start_jax(JAX_SIDE, root)
    serve_params = japi.build(jbase.ModelConfig(**RING_SERVE_CFG)).init(jax.random.PRNGKey(0))
    started = {}
    for dims in GRIDS:
        work = root / ("serve_" + "x".join(map(str, dims)))
        work.mkdir()
        np.savez(work / "inputs.npz", dims=np.array(dims),
                 prompt0=np.arange(1, 33, dtype=np.int32),
                 prompt1=np.arange(5, 29, dtype=np.int32), **_param_entries(serve_params))
        started[dims] = start_ranks("ring_placed_serve", int(np.prod(dims)), work)
    train_init = jax.tree_util.tree_map(np.asarray, japi.build(jbase.ModelConfig(
        **dataclasses.asdict(train_plan_cfg("ring")))).init(jax.random.PRNGKey(0)))
    work = root / "train"
    work.mkdir()
    np.savez(work / "inputs.npz", ckpt_dir=str(work / "ckpt"), **_param_entries(train_init))
    train = start_ranks("ring_placed_train", 4, work, timeout=300.0)
    served = {dims: finish_ranks(s) for dims, s in started.items()}
    trained = finish_ranks(train)
    elastic = root / "elastic"
    elastic.mkdir()
    np.savez(elastic / "inputs.npz", ckpt_dir=str(elastic / "ckpt"),
             **_param_entries(train_init))
    trained = (trained, finish_ranks(start_ranks("ring_placed_elastic", 4, elastic,
                                                 timeout=300.0)))
    finish_jax(jax_proc, "JAX_RING_PLACED_OK")
    return dict(np.load(root / "jax.npz")), served, trained, work, train_init


@pytest.mark.parametrize("dims", GRIDS, ids=["1x2", "2x2"])
def test_placed_ring_server_matches_the_references(runs, dims):
    ref, served, _, _, _ = runs
    tag = "x".join(map(str, dims))
    np.testing.assert_array_equal(ref[f"{tag}/ring/tokens"], ref[f"{tag}/base/tokens"])
    for r in served[dims]:
        for name in ("ring", "base"):
            assert bool(r[f"{name}/placed"])
            assert list(r[f"{name}/specs"]) == list(ref[f"{tag}/{name}/specs"])
            np.testing.assert_array_equal(r[f"{name}/tokens"], ref[f"{tag}/ring/tokens"])
        # the decode runs on the cache placed under cache_specs (k, v: batch
        # over data, heads over model; the position replicated)
        specs = list(r["ring/cache_specs"])
        assert specs[:2] == ["(None, ('data',), None, ('model',), None)"] * 2, specs


def test_placed_ring_trainer_holds_the_references(runs):
    ref, _, (trained, _), _, _ = runs
    for r in trained:
        assert tuple(r["dims"]) == (2, 2) == tuple(ref["train/dims"])
        assert bool(r["ring_attention"]) and bool(r["placed"])
        assert int(r["unplaced_refused"]) == int(errors.ErrorClass.ERR_UNSUPPORTED_OPERATION)
        assert list(r["param_specs"]) == list(ref["train/param_specs"])
        assert list(r["moment_specs"]) == list(ref["train/moment_specs"])
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(r[key], ref[f"train/{key}"], rtol=RTOL, atol=0)
            np.testing.assert_array_equal(r[f"eager/{key}"], r[key])
        np.testing.assert_array_equal(r["params"], trained[0]["params"])


def test_placed_ring_checkpoint_restores_on_one_rank_and_in_the_reference(runs):
    _, _, (trained, _), work, init = runs
    directory = str(work / "ckpt")
    t = Trainer(train_plan_cfg("ring"), tbase.ParallelConfig(), TrainerConfig(steps=1),
                device="cpu", seq_len=16, global_batch=2)
    params, opt_state = t.init_state()
    got, step = TManager(directory).restore({"params": params, "opt": opt_state})
    assert step == 3
    flat = torch.cat([p.detach().reshape(-1) for p in flatten(got["params"])[0]]).numpy()
    np.testing.assert_array_equal(flat, trained[0]["params"])

    from repro.optim import AdamW as JAdamW

    template = {"params": jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), init)}
    template["opt"] = JAdamW().init(template["params"])
    jgot, jstep = JManager(directory).restore(template)
    assert jstep == 3
    jflat = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree_util.tree_leaves(jgot["params"])])
    np.testing.assert_array_equal(jflat, trained[0]["params"])


def test_placed_ring_state_shrinks_and_grows(runs):
    """Rank 1 evicted before step 3 (the survivors fold one ring of 2 on
    (1, 2), the third idles, the step-2 manifest restored onto it), one
    rank admitted before step 5 (back to (2, 2), the live state placed
    again): the run ends on (2, 2) with placed state, equal on every rank,
    and the restored step 3 repeats the first step 3 bit for bit."""

    _, _, (trained, elastic), _, _ = runs
    for r in elastic:
        assert int(r["final_step"]) == 6 and int(r["epoch"]) == 2
        assert int(r["world_size"]) == 4 and tuple(r["dims"]) == (2, 2)
        assert int(r["evictions"]) == 1 and int(r["joins"]) == 1 and bool(r["placed"])
        np.testing.assert_array_equal(r["params"], elastic[0]["params"])
        assert np.isfinite(r["losses"]).all()
    steps, losses = list(elastic[0]["steps"]), elastic[0]["losses"]
    assert steps == [1, 2, 3, 3, 4, 5, 6]
    assert losses[2] == losses[3]
    np.testing.assert_array_equal(losses[:3], trained[0]["losses"])


#: (program, the two ranks' ``PYTHONHASHSEED``): a pair that hung an
#: earlier version of the placed ring server, and one that hangs zamba2's
#: placed ring server without the stable placement hashes (each rank
#: waiting in another collective: one in the shared MLP's down
#: projection, the other in the next layer's norm)
HASH_SALTS = (("ring_placed_serve", 1, 2), ("zamba2_ring", 172, 173))


@pytest.mark.parametrize("program,salt0,salt1", HASH_SALTS, ids=["ring_placed", "zamba2"])
def test_ranks_with_other_hash_salts_pick_the_same_strategies(tmp_path, program, salt0, salt1):
    """ROADMAP C21: a placed ring server on 1 x 2 with another
    ``PYTHONHASHSEED`` on each rank serves, and both ranks return the
    tokens of the same server without the ring (phi4-like) or in one
    process (zamba2's smoke model)."""

    envs = [{"PYTHONHASHSEED": str(salt0)}, {"PYTHONHASHSEED": str(salt1)}]
    prompts = [np.arange(1, 33, dtype=np.int32), np.arange(5, 29, dtype=np.int32)]
    if program == "ring_placed_serve":
        params = japi.build(jbase.ModelConfig(**RING_SERVE_CFG)).init(jax.random.PRNGKey(0))
        np.savez(tmp_path / "inputs.npz", dims=np.array((1, 2)), prompt0=prompts[0],
                 prompt1=prompts[1], **_param_entries(params))
        ranks = run_ranks(program, 2, tmp_path, envs=envs)
        np.testing.assert_array_equal(ranks[0]["ring/tokens"], ranks[1]["ring/tokens"])
        np.testing.assert_array_equal(ranks[0]["ring/tokens"], ranks[0]["base/tokens"])
        return
    from repro_torch.runtime import server as tserver

    np.savez(tmp_path / "inputs.npz", prompt0=prompts[0], prompt1=prompts[1])
    ranks = run_ranks(program, 2, tmp_path, envs=envs)
    cfg = dataclasses.replace(tbase.get_smoke_config("zamba2_7b"), dtype="float32")
    one = tserver.Server(cfg, tbase.get_parallel("zamba2_7b"),
                         tserver.ServerConfig(max_batch=2, max_new_tokens=4), device="cpu")
    want, _ = one.generate([tserver.Request(tokens=p.copy()) for p in prompts])
    for r in ranks:
        np.testing.assert_array_equal(r["ring"], want)


@pytest.mark.parametrize("plan", ["ring=4", "tensor=4"])
def test_placed_plans_on_one_row_of_four_ranks(tmp_path, plan):
    """phi4-mini's bf16 smoke model (a tied embedding split four ways, 4
    query heads over 2 key/value heads) under the ring and tensor plans on
    a 1 x 4 grid, through the train CLI: the losses and grad norms of the
    one-rank data plan on the same batches, within 2e-2 relative (bf16).
    Over four model ranks the embedding rows' gradient came back as a
    partial sum, which DTensor could not carry back to the lookup; and the
    key/value heads, whole on every rank and read in part, kept only this
    rank's part of their gradient (the grad norm was 0.73 of the one
    rank's)."""

    from repro_torch.launch import train as tlaunch

    argv = ["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "64", "--log-every", "1"]
    np.savez(tmp_path / "inputs.npz", argv=np.array(argv + ["--plan", plan]))
    ranks = run_ranks("train_cli", 4, tmp_path)
    _, one = tlaunch.run(argv)
    for r in ranks:
        assert tuple(r["dims"]) == (1, 4) and bool(r["placed"])
        np.testing.assert_allclose(r["losses"], [m["loss"] for m in one["metrics"]], rtol=2e-2)
        np.testing.assert_allclose(r["grad_norms"], [m["grad_norm"] for m in one["metrics"]],
                                   rtol=2e-2)


FOUR_JAX_SIDE = textwrap.dedent("""
    import dataclasses
    import sys
    import numpy as np
    from repro.configs import base
    from repro.configs.base import ParallelPlan
    from repro.core._compat import make_mesh
    from repro.launch.mesh import make_host_communicator
    from repro.runtime.server import Request, Server, ServerConfig
    from repro.runtime.trainer import Trainer, TrainerConfig

    work = sys.argv[1]
    arch = "phi4_mini_3_8b"
    cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="float32")
    pcfg = base.get_parallel(arch)
    seq, batch, steps = FOUR_MODEL_RANKS
    out = {}
    for name, plan in (("ring", ParallelPlan(ring=4)), ("tensor", ParallelPlan(tensor=4))):
        t = Trainer(cfg, pcfg, TrainerConfig(steps=steps, log_every=1, plan=plan),
                    make_host_communicator(), seq_len=seq, global_batch=batch,
                    clock=lambda: 0.0)
        res = t.run()
        out[f"{name}/losses"] = np.array([m["loss"] for m in res["metrics"]])
        out[f"{name}/grad_norms"] = np.array([m["grad_norm"] for m in res["metrics"]])
        out[f"{name}/dims"] = np.array([t.mesh.shape[a] for a in t.comm.axis_names])
    server = Server(cfg, dataclasses.replace(pcfg, ring_attention=True),
                    ServerConfig(max_batch=2, max_new_tokens=4),
                    make_mesh((1, 4), ("data", "model")))
    out["serve/tokens"], _ = server.generate(
        [Request(tokens=np.arange(1, 33, dtype=np.int32)),
         Request(tokens=np.arange(5, 29, dtype=np.int32))])
    np.savez(work + "/jax.npz", **out)
    print("JAX_ONE_ROW_OF_FOUR_OK")
""").replace("FOUR_MODEL_RANKS", repr(FOUR_MODEL_RANKS))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The reference on 4 virtual devices beside the port's 4 gloo ranks,
    each on a 1 x 4 grid: the ring and tensor plans' trainers, fp32, and
    the ring server."""

    root = tmp_path_factory.mktemp("four_model_ranks")
    jax_proc = start_jax(FOUR_JAX_SIDE, root)
    cfg = dataclasses.replace(jbase.get_smoke_config("phi4_mini_3_8b"), dtype="float32")
    init = japi.build(cfg).init(jax.random.PRNGKey(0))
    np.savez(root / "inputs.npz", prompt0=np.arange(1, 33, dtype=np.int32),
             prompt1=np.arange(5, 29, dtype=np.int32), **_param_entries(init))
    ranks = run_ranks("four_model_ranks", 4, root, timeout=300.0)
    finish_jax(jax_proc, "JAX_ONE_ROW_OF_FOUR_OK")
    return dict(np.load(root / "jax.npz")), ranks


@pytest.mark.parametrize("plan", ["ring", "tensor"])
def test_placed_plans_on_one_row_of_four_ranks_hold_the_reference(four, plan):
    """The fp32 witness for the four-model-rank repairs (ROADMAP C20): the
    ring and tensor plans on 1 x 4, from the reference's init, take its
    trainer's losses and grad norms within 1e-5 relative, so no part of a
    gradient is lost where the vocabulary splits four ways and the
    key/value heads are read in part."""

    ref, ranks = four
    for r in ranks:
        assert tuple(r[f"{plan}/dims"]) == (1, 4) == tuple(ref[f"{plan}/dims"])
        assert bool(r[f"{plan}/placed"])
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(r[f"{plan}/{key}"], ref[f"{plan}/{key}"], rtol=RTOL,
                                       atol=0)


def test_placed_ring_server_on_one_row_of_four_ranks_matches_the_reference(four):
    """The ring server on 1 x 4, fp32 at temperature 0, on the reference's
    weights placed under ``param_specs``: its greedy tokens are exactly the
    reference's placed ring server's on the same grid."""

    ref, ranks = four
    for r in ranks:
        assert bool(r["serve/placed"])
        np.testing.assert_array_equal(r["serve/tokens"], ref["serve/tokens"])


DROPPED = textwrap.dedent("""
    import gc
    import sys
    import weakref
    gc.disable()
    import torch
    sys.path.insert(0, sys.argv[1])
    import graph_stub
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.core import futures
    from repro_torch.core.futures import flatten
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    futures._capturable = lambda leaf: isinstance(leaf, torch.Tensor)
    futures._graph_capture = graph_stub.stub_capture
    torch.set_num_threads(1)
    cfg = ModelConfig(name="tiny", family="dense", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, dtype="float32")
    t = Trainer(cfg, ParallelConfig(remat="full"), TrainerConfig(steps=3, log_every=1),
                device="cpu", seq_len=16, global_batch=2, clock=lambda: 0.0)
    t.run()
    assert t._request.captured == 1, t._request.captured
    refs = {"trainer": weakref.ref(t), "request": weakref.ref(t._request),
            "graph": weakref.ref(t._request._graph),
            "param": weakref.ref(flatten(t.params)[0][0])}
    del t
    alive = sorted(k for k, r in refs.items() if r() is not None)
    print("ALIVE", alive)
""")


def test_dropped_trainer_is_freed_without_a_gc_pass():
    """Step 0 of the four-card run's repair: nothing of a dropped trainer
    outlives it, with the cyclic collector disabled from the start."""

    out = subprocess.run([sys.executable, "-c", DROPPED, str(Path(__file__).resolve().parent)],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ALIVE []" in out.stdout, out.stdout + out.stderr[-3000:]
