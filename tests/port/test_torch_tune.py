"""The port's tuner (``repro_torch.tune``) against the reference's
(``repro.tune``).

* With the port's hardware constants set to the reference's TPU values, the
  two give equal winners, equal top-5 tables and an equal ``Score``, field
  by field, in exact float equality (the arithmetic is the same), or the
  same error class, for every arch of ``ARCHITECTURES`` x every ``SHAPES``
  entry x devices (1, 2, 4, 8, 16, 64, 256, 512) x slices (1, 2), in both
  search modes.
* With the port's own constants (an H100's), its winners are those the
  reference's formula gives under the same constants: phi4-mini's training
  at b 2 x 2048 on one card and b 4 x 2048 on four, qwen1.5-32b's prefill
  at 2 x 4096 on four, gemma2-9b's ``train_4k`` on eight.
* The counterparts of ``tests/test_tune.py``'s scoring and search cases,
  the 7-device ``TopologyError``, ``fold_group`` on a two-slice session
  and the registered pset with its pvar; the port's slices (a device's
  ``slice_index``, else the hosts of a multi-host world); the calibration
  loader and ``predicted_vs_measured``; the CLI's output.
* ``serve`` and ``train --plan auto --smoke --device cpu`` (smoke phi4-mini
  in fp32) on one rank in this process and on 4 gloo ranks against the
  reference's CLIs on 4 virtual JAX devices, the port on the reference's
  weights: the tuned slug the reference's, the tokens exactly, the losses
  within the trainer parity's fp32 tolerance (1e-4 relative,
  ``test_torch_trainer.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.configs import base as jbase
from repro.core import tool as jtool
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.runtime import server as jserver
from repro.runtime import trainer as jtrainer
from repro_torch import tune as ttune
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core import errors
from repro_torch.core import session as tsession
from repro_torch.core import tool as ttool
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.runtime import server as tserver
from repro_torch.runtime import trainer as ttrainer
from repro_torch.tune import __main__ as tmain
from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)

CONSTANTS = ("PEAK_FLOPS_BF16", "HBM_BANDWIDTH", "ICI_BANDWIDTH", "DCN_BANDWIDTH", "HBM_BYTES",
             "COLLECTIVE_LAUNCH_S")
DEVICES = (1, 2, 4, 8, 16, 64, 256, 512)
TRAIN_RTOL = 1e-4
WORLD = 4


@pytest.fixture()
def tpu_constants(monkeypatch):
    """The port's hardware model set to the reference's (TPU) values."""

    for name in CONSTANTS:
        monkeypatch.setattr(ttool, name, getattr(jtool, name))


@pytest.fixture()
def h100_constants(monkeypatch):
    """The reference's hardware model set to the port's (H100) values."""

    for name in CONSTANTS:
        monkeypatch.setattr(jtool, name, getattr(ttool, name))


def _search(module, base, arch, shape, devices, slices, mode):
    try:
        return module.search(base.get_config(arch), base.SHAPES[shape], devices,
                             space=base.plan_space(arch), slices=slices, mode=mode,
                             default_remat=base.get_parallel(arch).remat)
    except Exception as e:  # the verdict is the error's class, compared below
        return type(e).__name__


@pytest.mark.parametrize("mode", ["exhaustive", "coordinate"])
@pytest.mark.parametrize("arch", jbase.ARCHITECTURES)
def test_search_equals_the_reference_under_its_constants(tpu_constants, arch, mode):
    cells = 0
    for shape in jbase.SHAPES:
        for devices in DEVICES:
            for slices in (1, 2):
                want = _search(jtune, jbase, arch, shape, devices, slices, mode)
                got = _search(ttune, tbase, arch, shape, devices, slices, mode)
                cell = (arch, shape, devices, slices, mode)
                if isinstance(want, str):
                    assert got == want, cell
                    continue
                cells += 1
                assert got.plan.slug() == want.plan.slug(), cell
                assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan), cell
                assert got.table == want.table, cell
                assert got.score.as_dict() == want.score.as_dict(), cell
                assert (got.n_candidates, got.n_scored) == (want.n_candidates, want.n_scored)
    assert cells > 0


# the motivating cells under the H100's constants: (arch, shape, devices,
# winner); with the measured 92.7 µs a collective, the data plan's gradient
# all-reduce (4 buckets) beats the ring of 4's 96 launches a step on four cards
H100_CELLS = [
    ("phi4_mini_3_8b", ("train_2048", 2048, 2, "train"), 1, "d1_gb2_rm-none"),
    ("phi4_mini_3_8b", ("train_2048", 2048, 4, "train"), 4, "d4_gb4_rm-none"),
    ("qwen1_5_32b", ("prefill_4096", 4096, 2, "prefill"), 4, "d4"),
    ("gemma2_9b", "train_4k", 8, "d8_mb8_gb4_rm-none"),
]


@pytest.mark.parametrize("arch,shape,devices,winner", H100_CELLS)
def test_h100_winners_are_the_reference_formulas(h100_constants, arch, shape, devices, winner):
    def shp(base):
        return base.SHAPES[shape] if isinstance(shape, str) else base.ShapeConfig(*shape)

    got = ttune.search(tbase.get_config(arch), shp(tbase), devices,
                       space=tbase.plan_space(arch), default_remat=tbase.get_parallel(arch).remat)
    want = jtune.search(jbase.get_config(arch), shp(jbase), devices,
                        space=jbase.plan_space(arch), default_remat=jbase.get_parallel(arch).remat)
    assert got.plan.slug() == want.plan.slug() == winner
    assert got.score.as_dict() == want.score.as_dict() and got.table == want.table
    assert got.score.fits


def test_hardware_model_is_the_h100s():
    """The H100 SXM's datasheet values and the card's memory; none of the
    reference's TPU figures is left."""

    assert ttool.PEAK_FLOPS_BF16 == 989e12 and ttool.HBM_BANDWIDTH == 3.35e12
    assert ttool.ICI_BANDWIDTH == 450e9 and ttool.DCN_BANDWIDTH == 50e9
    assert 80e9 < ttool.HBM_BYTES < 86e9
    for name in CONSTANTS:
        assert getattr(ttool, name) != getattr(jtool, name), name
    assert ttool.COLLECTIVE_KINDS == jtool.COLLECTIVE_KINDS
    for kind in ttool.COLLECTIVE_KINDS + ("other",):
        for n in (0, 1, 2, 3, 8):
            assert ttool._wire_factor(kind, n) == jtool._wire_factor(kind, n)


def test_reference_constants_in_the_score_module_are_the_references():
    from repro.tune import score as jscore
    from repro_torch.tune import score as tscore

    for name in ("REMAT_FLOP_MULT", "REMAT_RESIDENCY", "RING_OVERLAP", "PIPELINE_OVERLAP",
                 "TENSOR_OVERLAP"):
        assert getattr(tscore, name) == getattr(jscore, name), name


# -- tests/test_tune.py's scoring and search cases ----------------------------


def _gemma():
    return tbase.get_config("gemma2_9b")


def test_score_plan_is_deterministic_and_memory_aware():
    cfg, shape = _gemma(), tbase.SHAPES["train_4k"]
    lean = tbase.ParallelPlan(data=8, microbatches=8, grad_buckets=4, remat="full")
    fat = tbase.ParallelPlan(data=8, remat="none")
    a, b = ttune.score_plan(cfg, shape, lean), ttune.score_plan(cfg, shape, lean)
    assert a == b
    assert a.step_s > 0 and a.peak_bytes > 0
    assert a.peak_bytes < ttune.score_plan(cfg, shape, fat).peak_bytes


def test_exhaustive_search_is_the_brute_force_minimum():
    cfg, shape = _gemma(), tbase.SHAPES["train_4k"]
    space = tbase.plan_space("gemma2_9b")
    result = ttune.search(cfg, shape, 8, space=space, mode="exhaustive")
    best = min(ttune.score_plan(cfg, shape, p).step_s
               for p in tbase.legal_plans(cfg, shape, 8, space))
    assert result.score.step_s == best
    again = ttune.search(cfg, shape, 8, space=space, mode="exhaustive")
    assert again.plan == result.plan and again.score == result.score


def test_coordinate_search_never_beats_exhaustive_and_scores_less():
    cfg, shape = _gemma(), tbase.SHAPES["train_4k"]
    space = tbase.plan_space("gemma2_9b")
    best = ttune.search(cfg, shape, 256, space=space, mode="exhaustive")
    greedy = ttune.search(cfg, shape, 256, space=space, mode="coordinate")
    assert greedy.score.step_s >= best.score.step_s
    assert greedy.n_scored < best.n_scored
    with pytest.raises(errors.ArgError, match="unknown search mode"):
        ttune.search(cfg, shape, 8, space=space, mode="simulated-annealing")


def test_search_rejects_empty_cell():
    with pytest.raises(errors.TopologyError, match="no legal plan"):
        ttune.search(_gemma(), tbase.SHAPES["train_4k"], 7, space=tbase.plan_space("gemma2_9b"))


# -- slices, fold_group and the registered pset --------------------------------


class _FakeDev:
    def __init__(self, i, slice_index):
        self.id = i
        self.slice_index = slice_index
        self.process_index = 0
        self.platform = "fake"

    def __repr__(self):
        return f"dev{self.id}@s{self.slice_index}"


def _two_slice_sessions():
    from repro.core.session import Session as JSession

    return (tsession.Session([_FakeDev(i, i // 4) for i in range(8)]),
            JSession([_FakeDev(i, i // 4) for i in range(8)]))


@pytest.mark.parametrize("plan", [dict(data=4, ring=2, dcn_axis="data"),
                                  dict(data=4, ring=2, dcn_axis="model"), dict(data=8)])
def test_fold_group_splits_dcn_axis_per_slice(plan):
    tsess, jsess = _two_slice_sessions()
    assert sorted(p for p in tsess.psets() if "slice" in p) == [
        "repro://slice/0", "repro://slice/1"]
    got = ttune.fold_group(tsess, tbase.ParallelPlan(**plan))
    want = jtune.fold_group(jsess, jbase.ParallelPlan(**plan))
    assert [d.id for d in got.devices] == [d.id for d in want.devices]
    if plan.get("dcn_axis") == "model":
        assert [d.slice_index for d in got.devices] == [0, 1] * 4


def test_fold_group_rejects_indivisible_dcn_axis():
    tsess, _ = _two_slice_sessions()
    with pytest.raises(errors.TopologyError, match="does not split"):
        ttune.fold_group(tsess, tbase.ParallelPlan(data=2, tensor=3, dcn_axis="model"))
    with pytest.raises(errors.GroupError, match="needs 16 devices"):
        ttune.fold_group(tsess, tbase.ParallelPlan(data=16))


def test_tune_registers_cart_pset():
    tsess, jsess = _two_slice_sessions()
    before = ttool.pvar_read().get("tune:winner_registered", 0)
    result = ttune.tune("gemma2_9b", "train_4k", 8, session=tsess, calibrate=False,
                        space=tbase.plan_space("gemma2_9b"))
    want = jtune.tune("gemma2_9b", "train_4k", 8, session=jsess, calibrate=False,
                      space=jbase.plan_space("gemma2_9b"))
    assert result.plan.cart_pset in tsess.psets()
    assert ttool.pvar_read().get("tune:winner_registered", 0) == before + 1
    assert len(tsess.pset(result.plan.cart_pset)) == result.plan.total_devices
    assert [d.id for d in tsess.pset(result.plan.cart_pset)] == \
        [d.id for d in jsess.pset(want.plan.cart_pset)]
    for name in ("tune:candidates", "tune:scored", "tune:winner_registered"):
        assert ttool.PVARS[name] == jtool.PVARS[name]


def test_slices_are_the_hosts_of_a_multi_host_world(monkeypatch):
    """Without a ``slice_index``, a world over two hosts of 4 ranks has one
    slice a host; a world on one host has none."""

    cpu = torch.device("cpu")
    members = [tsession.RankDevice(r, cpu) for r in range(8)]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    sess = tsession.Session(members)
    assert sess.pset("repro://slice/0") == tuple(members[:4])
    assert sess.pset("repro://slice/1") == tuple(members[4:])
    assert sess.pset("repro://slice/1") == sess.pset("repro://host/1")
    with pytest.raises(errors.ArgError):
        sess.register_pset("repro://slice/2", members[:1])   # a builtin namespace
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert not [p for p in tsession.Session(members).psets() if "slice" in p]


# -- calibration, predicted_vs_measured, the CLI -------------------------------


def test_calibration_reads_the_ports_own_artifacts(tmp_path):
    from repro.tune import score as jscore
    from repro_torch.tune import score as tscore

    assert tscore.CALIBRATION_DIR.name == "dryrun_torch"
    assert ttune.load_calibration("gemma2_9b", "train_4k") == {}
    (tmp_path / "gemma2_9b__train_4k__pod_16x16.json").write_text(
        json.dumps({"status": "ok", "useful_flop_ratio": 0.8}))
    got = tscore.load_calibration("gemma2_9b", "train_4k", tmp_path)
    assert got == jscore.load_calibration("gemma2_9b", "train_4k", tmp_path)
    assert got["flops_scale"] == 1.25


def test_predicted_vs_measured_is_the_references(tpu_constants):
    from repro.tune import score as jscore
    from repro_torch.tune import score as tscore

    record = {"status": "ok", "chips": 8,
              "roofline": {"compute_s": 2.5, "collective_wire_s": 0.125}}
    args = ("gemma2_9b", "train_4k")
    want = jscore.predicted_vs_measured(jbase.get_config(args[0]), jbase.SHAPES[args[1]],
                                        jbase.ParallelPlan(data=8), record)
    got = tscore.predicted_vs_measured(tbase.get_config(args[0]), tbase.SHAPES[args[1]],
                                       tbase.ParallelPlan(data=8), record)
    assert got == want
    assert tscore.predicted_vs_measured(tbase.get_config(args[0]), tbase.SHAPES[args[1]],
                                        tbase.ParallelPlan(data=8), {"status": "ok"}) is None


@pytest.mark.parametrize("flags", [[], ["--json"], ["--mode", "coordinate", "--top", "3"]])
def test_cli_prints_what_the_references_prints(tpu_constants, capsys, flags):
    from repro.tune import __main__ as jmain

    argv = ["--arch", "gemma2_9b", "--shape", "train_4k", "--devices", "8", "--slices", "1",
            "--no-register"] + flags
    assert jmain.main(argv) == 0
    want = capsys.readouterr().out
    assert tmain.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_cli_registers_the_winner_on_the_cpu_world(capsys):
    """On the CPU world of one the winner of a one-device cell is
    registered; without ``--device cpu`` a machine with no card raises."""

    assert tmain.main(["--arch", "phi4_mini_3_8b", "--shape", "prefill_32k",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "winner : d1" in out and "(not registered)" not in out
    assert "repro://cart/1" in tsession.default_session(device_type="cpu").psets()
    if not torch.cuda.is_available():
        with pytest.raises(errors.SessionError):
            tmain.main(["--arch", "phi4_mini_3_8b", "--shape", "prefill_32k"])


# -- serve and train --plan auto -----------------------------------------------


SERVE_ARGV = ["--arch", "phi4_mini_3_8b", "--smoke", "--requests", "4", "--prompt-len", "16",
              "--new-tokens", "4", "--plan", "auto"]
TRAIN_ARGV = ["--arch", "phi4_mini_3_8b", "--smoke", "--steps", "3", "--batch", "4",
              "--seq", "32", "--log-every", "1", "--plan", "auto"]


def _fp32_smoke(monkeypatch, base):
    smoke = base.get_smoke_config
    monkeypatch.setattr(base, "get_smoke_config",
                        lambda arch: dataclasses.replace(smoke(arch), dtype="float32"))


def _cell(argv, kind):
    seq = int(argv[argv.index("--prompt-len" if kind == "prefill" else "--seq") + 1])
    batch = int(argv[argv.index("--requests" if kind == "prefill" else "--batch") + 1])
    return (f"{kind}_{seq}", seq, batch, kind)


def _reference_slug(argv, kind, devices):
    cfg = dataclasses.replace(jbase.get_smoke_config("phi4_mini_3_8b"), dtype="float32")
    return jtune.tune("phi4_mini_3_8b", jbase.ShapeConfig(*_cell(argv, kind)), devices,
                      config=cfg, space=jbase.plan_space("phi4_mini_3_8b"),
                      register=False).plan.slug()


def test_serve_plan_auto_on_one_rank(monkeypatch):
    """The reference's CLI and the port's, on the reference's weights: the
    same tuned slug, printed the same, and the same tokens."""

    _fp32_smoke(monkeypatch, jbase)
    _fp32_smoke(monkeypatch, tbase)
    seen = {}
    generate = jserver.Server.generate

    def record(self, reqs):
        tokens, stats = generate(self, reqs)
        seen["params"] = jax.tree_util.tree_map(np.asarray, self.params)
        seen["tokens"] = np.asarray(tokens)
        return tokens, stats

    monkeypatch.setattr(jserver.Server, "generate", record)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jserve.main(SERVE_ARGV) == 0
    want_line = out.getvalue().splitlines()[0]
    port_generate = tserver.Server.generate

    def on_reference_weights(self, reqs):
        self.params = params_from_jax(seen["params"], "cpu")
        return port_generate(self, reqs)

    monkeypatch.setattr(tserver.Server, "generate", on_reference_weights)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        server, tokens, _ = tserve.run(SERVE_ARGV + ["--device", "cpu"])
    assert out.getvalue().splitlines()[0] == want_line
    assert want_line.startswith(f"autotuned plan: {_reference_slug(SERVE_ARGV, 'prefill', 1)} ")
    assert tuple(server.comm.shape) == (1, 1)
    np.testing.assert_array_equal(tokens, seen["tokens"])


def test_train_plan_auto_on_one_rank(monkeypatch, caplog):
    """The reference's CLI and the port's from the reference's init: the
    same tuned plan (its remat in force), the losses and grad norms within
    ``TRAIN_RTOL``."""

    _fp32_smoke(monkeypatch, jbase)
    _fp32_smoke(monkeypatch, tbase)
    seen = {}
    init, run = jtrainer.Trainer.init_state, jtrainer.Trainer.run

    def record_init(self):
        params, opt_state = init(self)
        seen["params"] = jax.tree_util.tree_map(np.array, params)
        return params, opt_state

    def record_run(self):
        result = run(self)
        seen["metrics"], seen["plan"] = result["metrics"], self.tcfg.plan
        return result

    monkeypatch.setattr(jtrainer.Trainer, "init_state", record_init)
    monkeypatch.setattr(jtrainer.Trainer, "run", record_run)
    monkeypatch.setattr(ttrainer.Trainer, "init_state",
                        lambda self: self.place_state(params_from_jax(seen["params"], "cpu")))
    with caplog.at_level(logging.INFO, logger="repro.launch"), \
            contextlib.redirect_stdout(io.StringIO()):
        assert jtrain.main(TRAIN_ARGV) == 0
        trainer, result = ttrain.run(TRAIN_ARGV + ["--device", "cpu"])
    lines = [r.getMessage() for r in caplog.records if "autotuned plan" in r.getMessage()]
    assert len(lines) == 2 and lines[0] == lines[1], lines
    assert dataclasses.asdict(trainer.plan) == dataclasses.asdict(seen["plan"])
    assert trainer.plan.slug() == _reference_slug(TRAIN_ARGV, "train", 1)
    assert trainer.pcfg.remat == seen["plan"].remat
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in result["metrics"]],
                                   [m[key] for m in seen["metrics"]], rtol=TRAIN_RTOL)


JAX_SIDE = textwrap.dedent("""
    import contextlib, dataclasses, io, sys
    import jax
    import numpy as np
    from repro.configs import base
    from repro.launch import serve, train
    from repro.runtime import server, trainer

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    assert len(jax.devices()) == 4
    smoke = base.get_smoke_config
    base.get_smoke_config = lambda arch: dataclasses.replace(smoke(arch), dtype="float32")
    seen = {}
    generate, init, run = server.Server.generate, trainer.Trainer.init_state, trainer.Trainer.run

    def record(self, reqs):
        tokens, stats = generate(self, reqs)
        seen["serve"] = jax.tree_util.tree_map(np.asarray, self.params)
        seen["tokens"] = np.asarray(tokens)
        return tokens, stats

    def record_init(self):
        params, opt_state = init(self)
        seen["train"] = jax.tree_util.tree_map(np.array, params)
        return params, opt_state

    def record_run(self):
        result = run(self)
        seen["metrics"], seen["plan"] = result["metrics"], self.tcfg.plan.slug()
        return result

    server.Server.generate, trainer.Trainer.init_state = record, record_init
    trainer.Trainer.run = record_run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main([str(a) for a in inp["serve_argv"]])
        train.main([str(a) for a in inp["train_argv"]])
    entries = {f"{k}/param/" + "/".join(str(p.key) for p in path): np.asarray(leaf)
               for k in ("serve", "train")
               for path, leaf in jax.tree_util.tree_flatten_with_path(seen[k])[0]}
    np.savez(work + "/jax.npz", tokens=seen["tokens"], serve_line=out.getvalue().splitlines()[0],
             train_plan=seen["plan"], losses=[m["loss"] for m in seen["metrics"]],
             grad_norms=[m["grad_norm"] for m in seen["metrics"]], **entries)
    print("JAX_TUNE_CLI_OK")
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's CLIs on 4 virtual devices first (their weights and
    results), then the port's on 4 gloo ranks on those weights."""

    work = tmp_path_factory.mktemp("tune_cli")
    np.savez(work / "inputs.npz", serve_argv=np.array(SERVE_ARGV),
             train_argv=np.array(TRAIN_ARGV))
    finish_jax(start_jax(JAX_SIDE, work), "JAX_TUNE_CLI_OK")
    ref = dict(np.load(work / "jax.npz"))
    np.savez(work / "inputs.npz", serve_argv=np.array(SERVE_ARGV + ["--device", "cpu"]),
             train_argv=np.array(TRAIN_ARGV + ["--device", "cpu"]),
             **{k: v for k, v in ref.items() if "/param/" in k})
    return run_ranks("tune_cli", WORLD, work), ref


def test_serve_plan_auto_on_four_ranks(four_ranks):
    ranks, ref = four_ranks
    slug = _reference_slug(SERVE_ARGV, "prefill", WORLD)
    assert str(ref["serve_line"]).startswith(f"autotuned plan: {slug} ")
    for r in ranks:
        assert str(r["serve_line"]) == str(ref["serve_line"])
        np.testing.assert_array_equal(r["tokens"], ref["tokens"])


def test_train_plan_auto_on_four_ranks(four_ranks):
    ranks, ref = four_ranks
    assert str(ref["train_plan"]) == _reference_slug(TRAIN_ARGV, "train", WORLD)
    for r in ranks:
        assert str(r["train_plan"]) == str(ref["train_plan"])
        assert tuple(r["dims"]) == (WORLD, 1) and bool(r["placed"])
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=TRAIN_RTOL)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"], rtol=TRAIN_RTOL)
