"""The port's dry run (``repro_torch.launch.dryrun``, ``specs.py``,
``steps.py``) against the reference's (``repro.launch.dryrun``) and against
itself, and the tuner's serving weight term (ROADMAP C22).

* specs: for every arch x ``SHAPES`` entry on ``pod_16x16`` and
  ``multipod_2x16x16``, fp32 and int8 moments, each leaf's global shape and
  dtype and its local shape under the port's specs equal the reference's
  ``ShapeDtypeStruct``s and ``NamedSharding.shard_shape`` (the reference on
  512 virtual devices in one subprocess); ``model_flops``, ``params`` and
  ``active_params`` exactly.
* the counterparts of ``tests/test_dryrun_integration.py``: six archs'
  train and decode cells traced on a fake (2, 4) CPU grid.
* against itself: a smoke dense prefill's flops against a closed form; the
  fake trace's peak against ``MemTracker``'s peak of the same step run for
  real; collectives on a fake (2, 2) grid against a real 4-rank gloo run of
  the step under the same counting mode; each kernel's fake implementation
  and flop formula on fake CUDA tensors, launching nothing; the artifact
  helpers and the CLI's error record.
* C22: with the reference's constants every term of ``score_plan`` but a
  serving plan's weights and peak equals the reference's, and those equal
  the reckoning of ``tune_reckoning.c22_score``; qwen1.5-32b's ``d4`` is
  charged its whole weights and prefill, and ``serve --plan auto`` on four
  cards does not pick it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import tool as jtool
from repro_torch.configs import base as tbase
from repro_torch.core import tool as ttool
from repro_torch.core.futures import flatten
from repro_torch.launch import dryrun, specs
from repro_torch.optim import AdamW
from repro_torch.sharding import rules
from torch_ranks import finish_ranks, start_ranks
from tune_reckoning import c22_score, tpu_constants  # noqa: F401 (fixture)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
GRIDS = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}


def _env(**extra) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **extra}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    return env


# -- specs: every arch x shape on both production grids -------------------------

JAX_SPECS = textwrap.dedent("""
    import json
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import base
    from repro.launch import specs
    from repro.optim import AdamW

    devs = np.array(jax.devices())
    out = {}
    for mp in (False, True):
        shape = (2, 16, 16) if mp else (16, 16)
        axes = ("pod", "data", "model") if mp else ("data", "model")
        mesh = Mesh(devs[: int(np.prod(shape))].reshape(shape), axes)
        for arch in base.ARCHITECTURES:
            for sname, shp in base.SHAPES.items():
                if not base.shape_applicable(base.get_config(arch), shp)[0]:
                    continue
                for moments in (("float32", "int8") if shp.kind == "train" else ("float32",)):
                    pcfg = base.get_parallel(arch, multi_pod=mp)
                    pcfg.moment_dtype = moments
                    kind, kw, sh = specs.input_specs(
                        arch, sname, mesh, pcfg, opt=AdamW(lr=1e-4, moment_dtype=moments))
                    cell = {}
                    for name in kw:
                        leaves = jax.tree.leaves(kw[name])
                        shards = jax.tree.leaves(
                            sh[name], is_leaf=lambda x: isinstance(x, NamedSharding))
                        cell[name] = sorted(
                            [list(l.shape), str(l.dtype), list(s.shard_shape(l.shape))]
                            for l, s in zip(leaves, shards))
                    out[f"{arch}|{sname}|{int(mp)}|{moments}"] = cell
    print("SPECS " + json.dumps(out))
""")


def _popen(args: list, **env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(**env), cwd=str(ROOT))


def _finish(proc: subprocess.Popen, marker: str, timeout: float = 600) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, f"rc={proc.returncode}\n{out[-2000:]}\n{err[-4000:]}"
    line = next(x for x in out.splitlines() if x.startswith(marker))
    return line[len(marker):]


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """Every subprocess of this file, started together when the first test
    that needs one runs: the reference's specs on 512 virtual devices, the
    integration cells in three processes, and the fake and the real 2 x 2
    runs of one train step."""

    work = tmp_path_factory.mktemp("dryrun_counts")
    np.savez(work / "inputs.npz", seed=np.array(0))
    started = {
        "specs": _popen(["-c", JAX_SPECS],
                        XLA_FLAGS="--xla_force_host_platform_device_count=512",
                        JAX_PLATFORMS="cpu"),
        "cells": [_popen(["-c", INTEGRATION, json.dumps(INTEGRATION_ARCHS[i::3])])
                  for i in range(3)],
        "fake": _popen(["-m", "repro_torch.launch.dryrun", "--arch", "phi4_mini_3_8b",
                        "--shape", "train_32", "--batch", "4", "--grid", "2x2", "--device",
                        "cpu", "--smoke", "--artifacts", str(work)]),
        "real": start_ranks("dryrun_counts", 4, work),
        "work": work,
    }
    yield started
    for proc in [started["specs"], started["fake"], *started["cells"]]:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def reference_specs(background):
    return json.loads(_finish(background["specs"], "SPECS "))


def _port_cell(arch: str, sname: str, multi_pod: bool, moments: str) -> dict:
    mesh_shape = GRIDS[multi_pod]
    pcfg = tbase.get_parallel(arch, multi_pod=multi_pod)
    pcfg.moment_dtype = moments
    _, (structs, sp) = specs.cell_structs(arch, sname, mesh_shape, pcfg,
                                          opt=AdamW(lr=1e-4, moment_dtype=moments))
    cell = {}
    for name, tree in structs.items():
        leaves = flatten(tree)[0]
        spec_leaves = [sp[name]] if name == "token" else rules.spec_leaves(sp[name])
        assert len(leaves) == len(spec_leaves), (name, len(leaves), len(spec_leaves))
        cell[name] = sorted(
            [list(x.shape), str(x.dtype).replace("torch.", ""),
             list(specs.shard_shape(tuple(x.shape), s, mesh_shape))]
            for x, s in zip(leaves, spec_leaves))
    return cell


@pytest.mark.parametrize("arch", jbase.ARCHITECTURES)
def test_cell_specs_equal_the_references(reference_specs, arch):
    cells = 0
    for key, want in reference_specs.items():
        a, sname, mp, moments = key.split("|")
        if a != arch:
            continue
        cells += 1
        assert _port_cell(a, sname, bool(int(mp)), moments) == want, key
    # every applicable shape on both grids, the train shapes twice
    assert cells >= 2 * (len(jbase.SHAPES) - 1) + 2


@pytest.mark.parametrize("arch", jbase.ARCHITECTURES)
def test_model_flops_and_param_counts_are_the_references(arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for name, shape in tbase.SHAPES.items():
        js = jbase.SHAPES[name]
        tokens = js.global_batch * (js.seq_len if js.kind != "decode" else 1)
        want = (6 if js.kind == "train" else 2) * jcfg.active_param_count() * tokens
        assert dryrun.model_flops(tcfg, shape) == want, name


# -- the counterparts of test_dryrun_integration.py ------------------------------

INTEGRATION = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    out = {}
    for arch, micro in json.loads(sys.argv[1]):
        over = {"microbatches": micro} if micro > 1 else {}
        for shape in ("train_64", "decode_64"):
            if shape == "decode_64" and arch == "seamless_m4t_large_v2":
                continue
            rec = dryrun.run_cell(arch, shape, False, over, "", device="cpu", grid="2x4",
                                  batch=4, smoke=True)
            out[f"{arch}|{micro}|{shape}"] = {
                "status": rec["status"], "flops": rec["roofline"]["hlo_flops"],
                "coll": rec["roofline"]["collectives"]["total_operand_bytes"],
                "peak": rec["memory"]["peak_bytes_per_device"]}
    print("CELLS " + json.dumps(out))
""")

INTEGRATION_ARCHS = [("gemma2_9b", 1), ("deepseek_v2_236b", 1), ("mamba2_2_7b", 1),
                     ("zamba2_7b", 1), ("paligemma_3b", 1), ("grok_1_314b", 2)]


@pytest.fixture(scope="module")
def integration_cells(background):
    out: dict = {}
    for proc in background["cells"]:
        out.update(json.loads(_finish(proc, "CELLS ")))
    return out


@pytest.mark.parametrize("arch,micro", INTEGRATION_ARCHS)
def test_dryrun_path_small_grid(integration_cells, arch, micro):
    """Train (FSDP and the gradient sync make collectives on a (2, 4) grid)
    and decode, each traced: ``status: ok``, flops and collective bytes."""

    for shape in ("train_64", "decode_64"):
        rec = integration_cells[f"{arch}|{micro}|{shape}"]
        assert rec["status"] == "ok" and rec["flops"] > 0 and rec["peak"] > 0, (shape, rec)
        assert rec["coll"] > 0, (shape, rec)


# -- against itself -----------------------------------------------------------------


def test_smoke_dense_prefill_flops_are_the_closed_form():
    cfg = tbase.get_smoke_config("phi4_mini_3_8b")
    B, S = 2, 64
    rec = dryrun.run_cell("phi4_mini_3_8b", f"prefill_{S}", False, {}, "", device="cpu",
                          grid="1x1", batch=B, smoke=True)
    T, d, h, hk, hd, ff = (B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.d_ff)
    per_layer = (
        2 * T * d * (h + 2 * hk) * hd      # q, k, v projections
        + 2 * T * h * hd * d               # output projection
        + 2 * 2 * B * h * S * S * hd       # q kᵀ and p v over the whole causal square
        + 3 * 2 * T * d * ff               # gated MLP: gate, up, down
    )
    logits = 2 * B * d * cfg.padded_vocab  # the last token's
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["roofline"]["hlo_flops"] == cfg.num_layers * per_layer + logits
    assert rec["model_flops"] == 2 * cfg.active_param_count() * T


def _real_like(tree, gen: torch.Generator):
    """Real tensors shaped as the stand-ins of ``tree``: small normals for
    floating leaves, zeros for integer ones."""

    leaves, treedef = flatten(tree)
    out = []
    for x in leaves:
        if x.dtype.is_floating_point:
            out.append((torch.randn(tuple(x.shape), generator=gen) * 0.02).to(x.dtype))
        else:
            out.append(torch.zeros(tuple(x.shape), dtype=x.dtype))
    from repro_torch.core.futures import unflatten

    return unflatten(treedef, out)


@pytest.mark.parametrize("shape", ["train_32", "prefill_32"])
def test_fake_peak_is_the_real_steps_peak(shape):
    """One rank: the dry run's ``MemTracker`` peak over fake stand-ins
    equals its peak over the same step run for real on the CPU."""

    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import steps

    arch, B = "phi4_mini_3_8b", 2
    rec = dryrun.run_cell(arch, shape, False, {}, "", device="cpu", grid="1x1", batch=B,
                          smoke=True)
    cfg = tbase.get_smoke_config(arch)
    pcfg = tbase.get_parallel(arch)
    kind, (structs, _) = specs.cell_structs(arch, dryrun.shape_config(shape, B),
                                            {"data": 1, "model": 1}, pcfg, cfg=cfg)
    gen = torch.Generator().manual_seed(0)
    real = {name: _real_like(tree, gen) for name, tree in structs.items()}
    if kind == "train":
        for leaf in flatten(real["params"])[0]:
            leaf.requires_grad_(True)
    args = steps.example_args(kind, real)
    step = steps.make_step(kind, cfg, pcfg, AdamW(lr=1e-4, moment_dtype=pcfg.moment_dtype))
    tracker = MemTracker()
    tracker.track_external(*specs._leaves(args))
    with tracker:
        step(*args)
    peak = tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    assert rec["status"] == "ok"
    assert rec["memory"]["peak_bytes_per_device"] == peak > 0


def test_collectives_on_a_fake_grid_are_a_real_runs(background):
    """The same placed train step on a fake (2, 2) grid and on 4 real gloo
    ranks, counted by the same mode: equal collectives by kind, equal
    operand bytes."""

    work = background["work"]
    proc = background["fake"]
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    ranks = finish_ranks(background["real"])
    rec = json.loads((work / "phi4_mini_3_8b__train_32__grid_2x2.json").read_text())
    fake = rec["roofline"]["collectives"]
    real = json.loads(str(ranks[0]["collectives"]))
    assert fake["count"] and fake["count"] == real["count"]
    assert fake["operand_bytes"] == real["operand_bytes"]
    assert all(json.loads(str(r["collectives"])) == real for r in ranks)


def test_kernels_trace_on_fake_cuda_tensors_without_launching():
    """Each kernel's wrapper on fake CUDA tensors goes through its custom
    op's fake implementation (the outputs' shapes) and its flop and bytes
    formulas, and no launch is counted."""

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.quant import kernel as qk
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.registry import attention_tiles
    from repro_torch.kernels.ring_attention import kernel as rk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import api

    before = (fk.LAUNCHES, sk.LAUNCHES, dict(qk.LAUNCHES), rk.LAUNCHES)
    with api.fake_mode() as mode, dryrun.DispatchCount() as counted:
        cuda = torch.device("cuda")
        q = torch.empty(2, 1024, 8, 64, dtype=torch.bfloat16, device=cuda)
        kv = torch.empty(2, 1024, 2, 64, dtype=torch.bfloat16, device=cuda)
        o = fops.flash_attention(q, kv, kv, causal=True)
        x = torch.empty(2, 256, 4, 32, device=cuda)
        dt = torch.empty(2, 256, 4, device=cuda)
        A = torch.empty(4, device=cuda)
        Bm = torch.empty(2, 256, 1, 16, device=cuda)
        y, state = sops.ssd_scan_with_state(x, dt, A, Bm, Bm, chunk=128)
        rows = torch.empty(64, 256, dtype=torch.bfloat16, device=cuda)
        qq, s = qops.quantize_int8_rows(rows)
        back = qops.dequantize_int8_rows(qq, s, torch.bfloat16)
        qh = torch.empty(2, 8, 512, 64, dtype=torch.bfloat16, device=cuda)
        kh = torch.empty(2, 2, 512, 64, dtype=torch.bfloat16, device=cuda)
        m = torch.empty(2, 8, 512, 1, device=cuda)
        l_ = torch.empty(2, 8, 512, 1, device=cuda)
        acc = torch.empty(2, 8, 512, 64, device=cuda)
        info = torch.zeros(3, dtype=torch.int32, device=cuda)
        carry = rk.ring_step_fwd(qh, kh, kh, m, l_, acc, info=info)
    assert mode is not None
    assert tuple(o.shape) == (2, 1024, 8, 64) and o.device.type == "cuda"
    assert tuple(y.shape) == (2, 256, 4, 32) and tuple(state.shape) == (2, 4, 32, 16)
    assert qq.dtype == torch.int8 and tuple(s.shape) == (64, 1) and back.dtype == torch.bfloat16
    assert carry[2] is acc
    assert counted.kernels == {"repro_torch.flash_attention_fwd": 1,
                               "repro_torch.ssd_scan_fwd": 1,
                               "repro_torch.quantize_int8_rows": 1,
                               "repro_torch.dequantize_int8_rows": 1,
                               "repro_torch.ring_step_fwd": 1}
    flash = attention_tiles(1024, 1024, True) * 2 * 8 * 2 * 512 * 512 * (64 + 64)
    ssd = 2 * 4 * 2 * (2 * 128 * 128 * 16 + 2 * 128 * 128 * 32 + 4 * 128 * 16 * 32)
    ring = 1 * 2 * 8 * 2 * 512 * 512 * (64 + 64)    # offsets unknown: every tile
    assert attention_tiles(1024, 1024, True) == 3
    assert counted.flops == flash + ssd + 2 * 64 * 256 + 64 * 256 + ring
    assert counted.bytes > 0
    assert (fk.LAUNCHES, sk.LAUNCHES, dict(qk.LAUNCHES), rk.LAUNCHES) == before


def test_artifact_helpers_are_the_references(tmp_path, monkeypatch):
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry   # sets XLA_FLAGS on import

    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    for args in [("gemma2_9b", "train_4k", False, ""), ("qwen1_5_32b", "decode_32k", True, "x")]:
        assert dryrun.artifact_path(*args).name == jdry.artifact_path(*args).name
        assert dryrun.artifact_path(*args).parent.name == "dryrun_torch"
    assert dryrun.ARTIFACTS == tbase_calibration_dir()
    p = tmp_path / "a.json"
    for text, over, tag in [(None, {}, ""), ("{torn", {}, ""),
                            (json.dumps({"overrides": {"remat": "none"}, "tag": ""}), {}, ""),
                            (json.dumps({"overrides": {}, "tag": "t"}), {}, "t"),
                            (json.dumps({"overrides": {}, "tag": ""}), {}, "t")]:
        if text is None:
            p.unlink(missing_ok=True)
        else:
            p.write_text(text)
        assert dryrun._cell_done(p, over, tag) == jdry._cell_done(p, over, tag), text


def tbase_calibration_dir():
    from repro_torch.tune import score

    return score.CALIBRATION_DIR


def test_untraceable_cell_is_an_error_record_and_exit_1(tmp_path, capsys):
    rc = dryrun.main(["--arch", "phi4_mini_3_8b", "--shape", "train_32", "--batch", "4",
                      "--grid", "1x1", "--device", "cpu", "--smoke",
                      "--overrides", json.dumps({"not_a_field": 1}),
                      "--artifacts", str(tmp_path)])
    assert rc == 1 and "status: error" in capsys.readouterr().out
    rec = json.loads((tmp_path / "phi4_mini_3_8b__train_32__grid_1x1.json").read_text())
    assert rec["status"] == "error" and "not_a_field" in rec["error"]
    from repro_torch.tune import score

    assert score.load_calibration("phi4_mini_3_8b", "train_32", tmp_path) == {}


def test_calibration_reads_a_dry_run_artifact(tmp_path):
    rec = dryrun.run_cell("phi4_mini_3_8b", "train_32", False, {}, "", device="cpu",
                          grid="1x1", batch=2, smoke=True)
    assert rec["status"] == "ok" and 0 < rec["useful_flop_ratio"] < 1
    path = dryrun.artifact_path("phi4_mini_3_8b", "train_32", False, "", artifacts=tmp_path)
    path.write_text(json.dumps(rec))
    from repro_torch.tune import score

    got = score.load_calibration("phi4_mini_3_8b", "train_32", tmp_path)
    assert got["flops_scale"] == 1.0 / rec["useful_flop_ratio"]
    assert got["source"] == path.name


# -- C22: the serving weight term ------------------------------------------------------


SERVING = [("qwen1_5_32b", ("prefill_4096", 4096, 2, "prefill")),
           ("phi4_mini_3_8b", "prefill_32k"), ("gemma2_9b", "decode_32k"),
           ("grok_1_314b", "decode_32k"), ("mamba2_2_7b", "long_500k")]


@pytest.mark.parametrize("arch,shape", SERVING + [("gemma2_9b", "train_4k")])
def test_c22_serving_weights_are_charged_as_the_server_holds_them(tpu_constants, arch, shape):
    from repro.tune import score as jscore
    from repro_torch.tune import score as tscore

    def shp(b):
        return b.SHAPES[shape] if isinstance(shape, str) else b.ShapeConfig(*shape)

    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    is_train = shp(jbase).kind == "train"
    checked = 0
    for devices in (1, 4, 16, 256):
        for plan in tbase.legal_plans(tcfg, shp(tbase), devices, tbase.plan_space(arch)):
            jplan = jbase.ParallelPlan(**dataclasses.asdict(plan))
            got = tscore.score_plan(tcfg, shp(tbase), plan).as_dict()
            ref = jscore.score_plan(jcfg, shp(jbase), jplan).as_dict()
            want = c22_score(jcfg, shp(jbase), jplan).as_dict()
            # every term but the HBM traffic, the peak and a data-only
            # serving plan's compute (C28) is the reference's; those are the
            # reckoning's (``tune_reckoning``)
            whole = not is_train and plan.stage == plan.ring == plan.tensor == 1
            for k in ("bubble_s", "wire_s", "launch_s") + (() if whole else ("compute_s",)):
                assert got[k] == ref[k], (plan.slug(), k)
            assert got == want, plan.slug()
            if is_train:
                assert got == ref, plan.slug()
            checked += 1
    assert checked > 0


def test_c28_data_only_serving_is_charged_the_whole_batch_on_every_rank(tpu_constants):
    """qwen1.5-32b served at 2 x 4096 on four cards: ``d4`` runs the whole
    batch on each card, so its compute is four times the reference's (which
    splits the batch) and its activations' traffic that of the whole
    batch; ``d2_r2``, placed, keeps the reference's compute."""

    from repro.tune import score as jscore
    from repro_torch.tune import score as tscore

    cfg, shape = tbase.get_config("qwen1_5_32b"), tbase.ShapeConfig("prefill_4096", 4096, 2,
                                                                     "prefill")
    jcfg, jshape = jbase.get_config("qwen1_5_32b"), jbase.ShapeConfig("prefill_4096", 4096, 2,
                                                                       "prefill")
    d4 = tscore.score_plan(cfg, shape, tbase.ParallelPlan(data=4))
    ref = jscore.score_plan(jcfg, jshape, jbase.ParallelPlan(data=4))
    tokens = 2 * 4096
    assert d4.compute_s == pytest.approx(4 * ref.compute_s, rel=1e-12)
    traffic = tokens * cfg.d_model * cfg.num_layers * 2.0 * 2
    weights = 2 * cfg.param_count()
    assert d4.memory_s * ttool.HBM_BANDWIDTH == pytest.approx(weights + traffic, rel=1e-12)
    placed = tbase.ParallelPlan(data=2, ring=2)
    assert tscore.score_plan(cfg, shape, placed).compute_s == jscore.score_plan(
        jcfg, jshape, jbase.ParallelPlan(data=2, ring=2)).compute_s


def test_c22_qwen_d4_is_charged_its_whole_weights():
    """qwen1.5-32b served at 2 x 4096 on four cards: ``d4`` holds the 70.4
    GB of weights whole on each card (20.3 GB before the repair), and its
    prefill the whole batch's KV cache twice (the layers' entries and their
    stack): 2 x 8192 tokens x 64 layers x 40 heads x 128 x (k, v) x bf16."""

    from repro_torch import tune

    cfg = tbase.get_config("qwen1_5_32b")
    shape = tbase.ShapeConfig("prefill_4096", 4096, 2, "prefill")
    d4 = tune.score_plan(cfg, shape, tbase.ParallelPlan(data=4))
    weights = 2 * cfg.param_count()
    cache = 2 * 4096 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2 * 2
    assert weights > 70e9
    assert d4.peak_bytes == weights + 2 * cache
    t4 = tune.score_plan(cfg, shape, tbase.ParallelPlan(tensor=4))
    assert t4.peak_bytes < d4.peak_bytes - 0.7 * weights


def test_c22_qwen_serve_auto_on_four_cards_is_not_d4():
    """``serve --plan auto``'s search for qwen1.5-32b at 2 x 4096 on four
    H100s: ``d4`` is over the card and does not win; the winner splits the
    weights and fits."""

    from repro_torch import tune

    cfg = tbase.get_config("qwen1_5_32b")
    shape = tbase.ShapeConfig("prefill_4096", 4096, 2, "prefill")
    got = tune.search(cfg, shape, 4, space=tbase.plan_space("qwen1_5_32b"),
                      default_remat=tbase.get_parallel("qwen1_5_32b").remat)
    d4 = tune.score_plan(cfg, shape, tbase.ParallelPlan(data=4))
    assert not d4.fits and d4.peak_bytes > ttool.HBM_BYTES
    assert got.plan.slug() != "d4" and got.plan.data < 4
    assert got.score.fits and got.score.peak_bytes < ttool.HBM_BYTES
