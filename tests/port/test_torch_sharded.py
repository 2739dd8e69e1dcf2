"""Placed (DTensor) serving, training and checkpoints across gloo ranks
against the reference: the port's ``Server`` and ``Trainer`` on a 2 x 2
(data, model) grid of processes, their parameters, caches and optimizer
state under ``repro_torch.sharding.rules``, hold what the reference's
compute on the same weights (GSPMD computes the same values on any fold,
so the reference runs here on one device).

* Serving: greedy tokens equal, and the prefill's fp32 logits within 2e-4,
  for the dense (phi4-mini), MLA + MoE (deepseek-v2, ``shard_experts``) and
  SSM (mamba2) smoke models; the sequence-sharded merged decode within
  2e-3 of the reference's plain decode, and with the int8 cache within
  0.35 (the tolerances of ``tests/test_distributed_paths.py``).
* Training: the tiny dense model under fsdp and tensor 2 takes the
  reference trainer's losses and grad norms within 1e-4 relative with fp32
  moments; with int8 moments it is held as ``test_torch_trainer.py``
  holds the one-rank int8 run (``_int8_trajectory_held``).
* Checkpoints: a checkpoint written from the 4 ranks' fragments restores
  on one rank and in the reference's manager; the reference's restores
  into the 4 ranks' placed state.
* ``all_gather_matmul``, ``matmul_reduce_scatter`` and
  ``merge_partial_attention`` on gloo ranks against the reference's cases
  (``tests/test_overlap.py``) and function.
"""

from __future__ import annotations

import dataclasses
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
from repro.launch.mesh import make_host_communicator as j_comm
from repro.launch.mesh import make_host_mesh
from repro.models import api as japi
from repro.runtime import server as jserver
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.core.futures import flatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_trainer import _int8_trajectory_held  # noqa: E402
from torch_ranks import (  # noqa: E402
    SHARDED_ARCHS,
    finish_jax,
    finish_ranks,
    run_ranks,
    start_jax,
    start_ranks,
)

torch.set_num_threads(1)

_TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32")


def _param_entries(prefix: str, params) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[prefix + "param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded_serve")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=(16,), dtype=np.int32) for _ in range(2)]
    inputs = {"prompt0": prompts[0], "prompt1": prompts[1]}
    ref = {}
    scfg = jserver.ServerConfig(max_batch=2, max_new_tokens=4)
    servers = {}
    for arch in SHARDED_ARCHS:
        cfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
        servers[arch] = jserver.Server(cfg, jbase.get_parallel(arch), scfg, j_comm())
        inputs.update(_param_entries(arch + "/", servers[arch].params))
    np.savez(work / "inputs.npz", **inputs)
    # the ranks serve on the reference's weights while the reference runs
    started = start_ranks("sharded_serve", 4, work)
    for arch, server in servers.items():
        cfg, pcfg = server.cfg, server.pcfg
        ref[arch + "/tokens"], _ = server.generate(
            [jserver.Request(tokens=p.copy()) for p in prompts])
        bundle = japi.build(cfg)
        toks = jnp.asarray(np.stack(prompts))
        logits, cache = bundle.prefill(server.params, {"tokens": toks}, pcfg, None,
                                       extra_capacity=4)
        ref[arch + "/prefill"] = np.asarray(logits)
        nxt = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1).astype(jnp.int32)[:, None]
        dec, _ = bundle.decode(server.params, cache, nxt, pcfg, None)
        ref[arch + "/decode"] = np.asarray(dec)
    return ref, finish_ranks(started)


def test_placed_server_tokens_and_logits_equal_the_references(served):
    ref, ranks = served
    for arch in SHARDED_ARCHS:
        for r in ranks:
            np.testing.assert_array_equal(r[arch + "/tokens"], ref[arch + "/tokens"], arch)
            np.testing.assert_allclose(r[arch + "/prefill"], ref[arch + "/prefill"],
                                       atol=2e-4, rtol=2e-4, err_msg=arch)
            np.testing.assert_allclose(r[arch + "/decode"], ref[arch + "/decode"],
                                       atol=2e-4, rtol=2e-4, err_msg=arch)


def test_sequence_sharded_merged_decode_holds_the_reference(served):
    ref, ranks = served
    arch = "phi4_mini_3_8b"
    for r in ranks:
        for tag, tol in (("merge/", 2e-3), ("int8/", 0.35)):
            np.testing.assert_allclose(r[f"{arch}/{tag}decode"], ref[arch + "/decode"],
                                       atol=tol, rtol=tol, err_msg=tag)
        np.testing.assert_array_equal(r[f"{arch}/merge/tokens"], ref[arch + "/tokens"])


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference trainer's 4 steps (fp32 and int8 moments) on the tiny
    model, and the port's on 2 x 2 ranks under (data 2, tensor 2)."""

    work = tmp_path_factory.mktemp("sharded_train")
    cfg = jbase.ModelConfig(**_TINY)
    ref, init = {}, {}
    for moments in ("float32", "int8"):
        pcfg = jbase.ParallelConfig(remat="full", moment_dtype=moments)
        jt = JTrainer(cfg, pcfg, JTrainerConfig(steps=4, lr=1e-3, warmup_steps=2, log_every=1),
                      make_host_mesh(), seq_len=32, global_batch=4, clock=lambda: 0.0)
        seen = {}
        base_init, base_span = jt.init_state, jt._run_span

        def capture_init(base_init=base_init, seen=seen):
            params, opt_state = base_init()
            seen["init"] = jax.tree_util.tree_map(np.array, params)
            return params, opt_state

        def capture_span(*args, base_span=base_span, seen=seen):
            out = base_span(*args)
            seen["params"] = jax.tree_util.tree_map(np.array, out[0])
            return out

        jt.init_state, jt._run_span = capture_init, capture_span
        res = jt.run()
        ref[moments] = dict(losses=[m["loss"] for m in res["metrics"]],
                            grad_norms=[m["grad_norm"] for m in res["metrics"]],
                            params=jax.tree_util.tree_leaves(seen["params"]))
        init = seen["init"]
    np.savez(work / "inputs.npz", ckpt_dir=str(work / "ckpt"), **_param_entries("", init))
    return ref, run_ranks("sharded_train", 4, work), work


def test_placed_training_holds_the_reference_trainer(trained):
    ref, ranks, _ = trained
    for r in ranks:
        assert bool(r["float32/placed"]) and tuple(r["float32/shape"]) == (2, 2)
        np.testing.assert_allclose(r["float32/losses"], ref["float32"]["losses"],
                                   rtol=1e-4, atol=0)
        np.testing.assert_allclose(r["float32/grad_norms"], ref["float32"]["grad_norms"],
                                   rtol=1e-4)
        flat = np.concatenate([p.ravel() for p in ref["float32"]["params"]])
        assert np.abs(r["float32/params"] - flat).max() < 1e-3
        j = ref["int8"]
        sizes = [p.size for p in j["params"]]
        parts = [x.reshape(p.shape) for x, p in
                 zip(np.split(r["int8/params"], np.cumsum(sizes)[:-1]), j["params"])]
        _int8_trajectory_held(list(r["int8/losses"]), j["losses"], list(r["int8/grad_norms"]),
                              j["grad_norms"], parts, j["params"])
    np.testing.assert_array_equal(ranks[0]["float32/params"], ranks[3]["float32/params"])


def _tiny_state_template():
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    t = Trainer(ModelConfig(**_TINY), ParallelConfig(), TrainerConfig(steps=1), device="cpu",
                seq_len=32, global_batch=4)
    params, opt_state = t.init_state()
    return {"params": params, "opt": opt_state}


def test_checkpoint_from_four_ranks_restores_on_one_and_in_the_reference(trained):
    _, ranks, work = trained
    directory = str(work / "ckpt")
    got, step = TManager(directory).restore(_tiny_state_template())
    assert step == 4
    leaves = flatten(got["params"])[0]
    flat = torch.cat([p.detach().reshape(-1) for p in leaves]).numpy()
    np.testing.assert_array_equal(flat, ranks[0]["float32/params"])
    # the manifest holds the ranks' fragments of a split leaf
    import json
    import os

    with open(os.path.join(directory, "step_00000004", "manifest.json")) as f:
        records = json.load(f)["arrays"]
    assert len(records["params/layers/layer/mlp/w_gate"]["fragments"]) == 4
    assert len(records["opt/step"]["fragments"]) == 1
    cfg = jbase.ModelConfig(**_TINY)
    from repro.optim import AdamW as JAdamW

    jparams = jax.eval_shape(lambda: japi.build(cfg).init(jax.random.PRNGKey(0)))
    template = {"params": jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jparams)}
    template["opt"] = JAdamW().init(template["params"])
    jgot, jstep = JManager(directory).restore(template)
    assert jstep == 4
    jflat = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree_util.tree_leaves(jgot["params"])])
    np.testing.assert_array_equal(jflat, ranks[0]["float32/params"])


def test_reference_checkpoint_restores_into_four_ranks(tmp_path):
    from repro.optim import AdamW as JAdamW

    cfg = jbase.ModelConfig(**_TINY)
    params = jax.jit(japi.build(cfg).init)(jax.random.PRNGKey(3))
    opt = JAdamW(lr=1e-2)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state = jax.jit(opt.update)(grads, jax.jit(opt.init)(params), params)
    jstate = {"params": params, "opt": state}
    JManager(str(tmp_path / "ckpt"), async_save=False).save(2, jstate, extra={"step": 2})
    np.savez(tmp_path / "inputs.npz", ckpt_dir=str(tmp_path / "ckpt"))
    ranks = run_ranks("sharded_restore", 4, tmp_path)
    want = np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(
                               {"params": params, "opt": (state.step, state.mu, state.nu)})])
    for r in ranks:
        assert int(r["step"]) == 2 and bool(r["placed"])
        np.testing.assert_array_equal(np.sort(r["values"]), np.sort(want))


# ---------------------------------------------------------------------------
# the overlap schedules and the merge
# ---------------------------------------------------------------------------


OVERLAP_JAX = textwrap.dedent("""
    import sys
    import jax
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core import overlap
    from repro.core._compat import shard_map
    from repro.core.communicator import Communicator

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
        comm = Communicator(mesh, ("x",))

        def body(o, m, l):
            return overlap.merge_partial_attention(o[0], m[0], l[0], comm)[None]

        spec = P("x")
        out[f"merge{n}"] = np.asarray(shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                                                out_specs=spec)(
            inp[f"o{n}"], inp[f"m{n}"], inp[f"l{n}"]))
    np.savez(work + "/jax.npz", **out)
    print("JAX_MERGE_OK")
""")


def _partials(n: int, rng) -> tuple:
    """Per shard of a KV sequence split n ways: the normalised output o
    (b, q, h, d), the running max m and the normaliser l (b, h, q)."""

    b, q, h, d, k = 2, 1, 3, 8, 5
    scores = rng.standard_normal((n, b, h, q, k)).astype(np.float32) * 3
    values = rng.standard_normal((n, b, k, h, d)).astype(np.float32)
    m = scores.max(-1)
    p = np.exp(scores - m[..., None])
    l_ = p.sum(-1)
    o = np.einsum("nbhqk,nbkhd->nbqhd", p, values) / np.swapaxes(l_, -1, -2)[..., None]
    return o.astype(np.float32), m, l_.astype(np.float32)


@pytest.fixture(scope="module")
def overlapped(tmp_path_factory):
    work = tmp_path_factory.mktemp("overlap")
    rng = np.random.default_rng(0)
    inputs = {}
    for n in (2, 4):
        inputs[f"o{n}"], inputs[f"m{n}"], inputs[f"l{n}"] = _partials(n, rng)
    np.savez(work / "inputs.npz", **inputs)
    proc = start_jax(OVERLAP_JAX, work)
    ranks = run_ranks("overlap", 4, work)
    finish_jax(proc, "JAX_MERGE_OK")
    return dict(np.load(work / "jax.npz")), ranks


def test_merge_partial_attention_equals_the_references(overlapped):
    """The port's merge on 2 and 4 gloo ranks against the reference's
    function on the same numpy partials (4 virtual devices)."""

    ref, ranks = overlapped
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["merge4"], ref["merge4"][r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["merge2"], ref["merge2"][r % 2], rtol=1e-6, atol=1e-6)


def test_all_gather_matmul_and_matmul_reduce_scatter_equal_the_plain_products(overlapped):
    """``tests/test_overlap.py``'s cases: the fused ring products equal the
    gather-then-matmul and the allreduce-then-slice on every rank."""

    _, ranks = overlapped
    for out in ranks:
        np.testing.assert_allclose(out["agmm"], out["agmm_plain"], atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(out["mmrs"], out["mmrs_plain"], atol=1e-3, rtol=1e-3)


def test_sp_plan_places_the_query_blocks_over_model(overlapped):
    """The ``sp`` plan's constraint (the reference's ``q_block_axis`` in
    its chunked form): on DTensor inputs the output comes back with its
    sequence split over ``model``, and equal to the plain attention."""

    _, ranks = overlapped
    for out in ranks:
        np.testing.assert_allclose(out["sp"], out["sp_plain"], atol=1e-5, rtol=1e-5)
        assert list(out["sp_placements"]) == ["R", "S(1)"]
