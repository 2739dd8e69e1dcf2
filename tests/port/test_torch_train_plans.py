"""The ring and pipeline plans of the port's ``Trainer`` on 4 gloo ranks
against the reference's ``Trainer`` on 4 virtual devices and the port's
data plan on one rank, from the reference's init.

* The ring plan (data 2, ring 2; the reference's ``TRAINER_RING`` model,
  seq 96, global batch 8): each eligible layer shards its sequence over the
  ring kernel, whose gradient recomputes through the plain ring.
* The pipeline plan (data 2, stage 2, micro 2; the model of the
  reference's pipeline trainer test, seq 64, global batch 8): the layer
  stack split over the stages, microbatches streamed through
  ``pipeline_spmd``.

Both train 3 steps.  Losses and grad norms hold within 1e-5 relative of
the reference's same plan and of the port's data plan (fp32 throughout:
the plans only reorder sums); the pipeline's parameters after the last
step hold within 1e-5 of the data plan's, and its checkpoint, written from
the 4 ranks' fragments, restores on one rank and in the reference's
manager.  On the card the trainer refuses to capture a step with these
exchanges (``ERR_UNSUPPORTED_OPERATION`` at the step's build, naming
``persistent=False``); through the eager step (``persistent=False``) both
plans take the persistent step's losses bit for bit.  The CLI
builds the reference's plans from ``--plan`` and the
``--pipeline-stages``/``--ring-attention`` aliases.
"""

from __future__ import annotations

import dataclasses
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.models import api as japi
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core.futures import flatten
from repro_torch.launch import train as tlaunch
from repro_torch.runtime.trainer import Trainer, TrainerConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import (  # noqa: E402
    TRAIN_PLANS,
    finish_jax,
    start_jax,
    start_ranks,
    finish_ranks,
    train_plan_cfg,
)

torch.set_num_threads(1)

RTOL = 1e-5


def _jcfg(name: str):
    return jbase.ModelConfig(**dataclasses.asdict(train_plan_cfg(name)))


def _param_entries(prefix: str, params) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[prefix + "param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


JAX_SIDE = textwrap.dedent("""
    import sys
    import jax
    import numpy as np
    from repro.configs.base import ModelConfig, ParallelConfig, ParallelPlan
    from repro.launch.mesh import make_host_communicator
    from repro.runtime.trainer import Trainer, TrainerConfig

    work = sys.argv[1]
    plans = {PLANS}
    out = {}
    for name, (seq, batch, plan, model) in plans.items():
        cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                          num_heads=4, head_dim=16, d_ff=128, dtype="float32", **model)
        t = Trainer(cfg, ParallelConfig(), TrainerConfig(steps=3, log_every=1,
                                                         plan=ParallelPlan(**plan)),
                    make_host_communicator(), seq_len=seq, global_batch=batch,
                    clock=lambda: 0.0)
        res = t.run()
        out[name + "/losses"] = np.array([m["loss"] for m in res["metrics"]])
        out[name + "/grad_norms"] = np.array([m["grad_norm"] for m in res["metrics"]])
        out[name + "/dims"] = np.array([t.mesh.shape[a] for a in t.comm.axis_names])
    np.savez(work + "/jax.npz", **out)
    print("JAX_TRAIN_PLANS_OK")
""").replace("{PLANS}", repr(TRAIN_PLANS))


def _one_rank(name: str, params, steps: int = 3, plan=None, pcfg=None):
    """The port's ``Trainer`` on one rank from ``params`` (the data plan,
    unless ``plan``/``pcfg`` say otherwise); (result, trainer)."""

    seq, batch, _, _ = TRAIN_PLANS[name]
    t = Trainer(train_plan_cfg(name), pcfg or tbase.ParallelConfig(),
                TrainerConfig(steps=steps, log_every=1, plan=plan), device="cpu", seq_len=seq,
                global_batch=batch, clock=lambda: 0.0)
    t.init_state = lambda: t.place_state(params_from_jax(params, "cpu"))
    return t.run(), t


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_plans")
    inits, inputs = {}, {"ckpt_dir": str(work / "ckpt")}
    for name in TRAIN_PLANS:
        inits[name] = jax.tree_util.tree_map(
            np.asarray, japi.build(_jcfg(name)).init(jax.random.PRNGKey(0)))
        inputs.update(_param_entries(name + "/", inits[name]))
    np.savez(work / "inputs.npz", **inputs)
    jax_proc = start_jax(JAX_SIDE, work)
    started = start_ranks("train_plans", 4, work, timeout=300.0)
    one = {name: _one_rank(name, inits[name]) for name in TRAIN_PLANS}
    ranks = finish_ranks(started)
    finish_jax(jax_proc, "JAX_TRAIN_PLANS_OK")
    return ranks, dict(np.load(work / "jax.npz")), one, work


@pytest.mark.parametrize("name", list(TRAIN_PLANS))
def test_plan_on_four_ranks_holds_the_reference_and_the_data_plan(plans, name):
    ranks, ref, one, _ = plans
    data_metrics = one[name][0]["metrics"]
    for r in ranks:
        assert tuple(r[f"{name}/dims"]) == (2, 2) == tuple(ref[f"{name}/dims"])
        axes = ("data", "model") if name == "ring" else ("data", "stage")
        assert tuple(r[f"{name}/axes"]) == axes
        assert tuple(r[f"{name}/periods"]) == ((False, True) if name == "ring"
                                               else (False, False))
        assert bool(r[f"{name}/ring_attention"]) is (name == "ring")
        assert bool(r[f"{name}/placed"])   # the ring's state placed as the pipeline's
        for key, metric in (("losses", "loss"), ("grad_norms", "grad_norm")):
            got = r[f"{name}/{key}"]
            np.testing.assert_allclose(got, ref[f"{name}/{key}"], rtol=RTOL, atol=0)
            np.testing.assert_allclose(got, [m[metric] for m in data_metrics],
                                       rtol=RTOL, atol=0)
        np.testing.assert_array_equal(r[f"{name}/params"], ranks[0][f"{name}/params"])
        # on the card its exchanges would be captured in a CUDA graph: refused,
        # naming the eager step as the way; the eager step trains the same
        assert str(r[f"{name}/card_error"]) == "ERR_UNSUPPORTED_OPERATION"
        assert "persistent=False" in str(r[f"{name}/card_message"])
        assert bool(r[f"{name}/eager_request"])
        np.testing.assert_array_equal(r[f"{name}/eager_losses"], r[f"{name}/losses"])


def test_pipeline_parameters_hold_the_data_plan(plans):
    ranks, _, one, _ = plans
    trainer = one["pipeline"][1]
    want = torch.cat([p.detach().reshape(-1) for p in flatten(trainer.params)[0]]).numpy()
    got = ranks[0]["pipeline/params"]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_pipeline_checkpoint_restores_on_one_rank_and_in_the_reference(plans):
    ranks, _, one, work = plans
    directory = str(work / "ckpt")
    trainer = one["pipeline"][1]
    template_params, template_opt = trainer.init_state()
    got, step = TManager(directory).restore({"params": template_params, "opt": template_opt})
    assert step == 3
    flat = torch.cat([p.detach().reshape(-1) for p in flatten(got["params"])[0]]).numpy()
    np.testing.assert_array_equal(flat, ranks[0]["pipeline/params"])
    import jax.numpy as jnp

    from repro.optim import AdamW as JAdamW

    cfg = _jcfg("pipeline")
    jparams = jax.eval_shape(lambda: japi.build(cfg).init(jax.random.PRNGKey(0)))
    template = {"params": jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jparams)}
    template["opt"] = JAdamW().init(template["params"])
    jgot, jstep = JManager(directory).restore(template)
    assert jstep == 3
    jflat = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree_util.tree_leaves(jgot["params"])])
    np.testing.assert_array_equal(jflat, ranks[0]["pipeline/params"])


@pytest.mark.parametrize("argv, want", [
    (["--plan", "stage=2,micro=2"], dict(stage=2, microbatches=2)),
    (["--plan", "ring=2"], dict(ring=2)),
    (["--plan", "data=2,stage=2,micro=2"], dict(data=2, stage=2, microbatches=2)),
    (["--pipeline-stages", "2"], dict(stage=2, microbatches=2)),
    (["--pipeline-stages", "2", "--pipeline-microbatches", "4"], dict(stage=2, microbatches=4)),
    (["--ring-attention", "2"], dict(ring=2)),
    ([], None),
])
def test_cli_builds_the_reference_plans(argv, want):
    """``resolve_plan`` of the port's CLI and of the reference's give the
    same plan (on 4 devices; the data axis fills the rest)."""

    import argparse

    from repro.launch import train as jlaunch

    args = tlaunch._parser().parse_args(["--arch", "phi4_mini_3_8b"] + argv)
    got = tlaunch.resolve_plan(args, None, 4)
    ref = jlaunch.resolve_plan(argparse.Namespace(**vars(args)), None, 4)
    if want is None:
        assert got is None and ref is None
        return
    expect = tbase.ParallelPlan(**{"data": 4 // (want.get("stage", 1) * want.get("ring", 1)),
                                   **want})
    assert got == expect
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_cli_plans_that_do_not_fold_on_one_rank():
    """On one rank ``--ring-attention 2`` and ``--plan stage=2,micro=2`` do
    not fold (``ERR_DIMS``, as the reference's)."""

    from repro_torch.core import errors

    for flags in (["--ring-attention", "2"], ["--plan", "stage=2,micro=2"]):
        with pytest.raises(errors.Error) as ei:
            tlaunch.run(["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu",
                         "--steps", "1", "--batch", "2", "--seq", "16"] + flags)
        assert ei.value.klass is errors.ErrorClass.ERR_DIMS
