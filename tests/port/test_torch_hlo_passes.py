"""The analyzer's layer 2 (``repro_torch.analysis.hlo``) and the recorded
program it reads (``repro_torch.core.hloanalysis``, ``PersistentRequest.
compiled`` / ``as_text`` / ``cost_analysis``), held against the reference's
passes over XLA's compiled modules (``repro.analysis.hlo``).

The reference side runs as ``tests/test_analysis_hlo.py`` runs it: one
SPMD program on 4 virtual JAX devices in a subprocess.  The port side runs
4 gloo ranks (``torch_ranks.py hlo_passes``), each holding its own program;
every case below says whose.

* (a) the reference test's programs — an all-reduce, a one-step ring
  permute and an all-gather of the (32, 16) fp32 array each of the 4
  holds (the reference's ``spmd`` replicates its input): on every rank
  ``stats_dict`` (counts, operand and wire bytes) and every pass's verdict,
  on its passing and its failing side, equal the reference's (the wire
  bytes of ``dist.*`` collectives held ROADMAP C29);
* (b) ``comm.allreduce_init(x)`` lowers as ``comm.allreduce`` and as raw
  ``dist.all_reduce`` on the same group (the zero-overhead claim), its
  program recorded before its first start without a start counted;
* (c) one forward ``ring_attention`` on a ring of 4: ``n − 1`` permutes of
  the stacked KV, no all-gather, ``1/n`` of the KV on the wire a step (every
  rank sends once a step on a periodic ring);
* (d) the pipeline plan's step (data 2, stage 2): permutes on every rank
  (stage 0 sends activations, stage 1 gradients), no all-to-all, as
  ``tests/test_trainer.py`` holds the reference's;
* (e) ``moe_neighbor`` over the radius-1 expert graph: no all-to-all,
  permutes, sparse against the full graph, as ``tests/test_topology.py``;
* (f) ``PassResult`` and ``pvar_invariant``, in both packages;
* (g) ``cost_analysis()`` of the two-layer smoke train step equals the dry
  run's count of that step; the program is recorded at one start only, a
  failed recording leaves none, and text that is not a program is refused.
"""

from __future__ import annotations

import json
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import hlo as jhlo
from repro_torch.analysis import hlo as thlo
from repro_torch.configs import base as tbase
from repro_torch.core import errors, hloanalysis, tool
from repro_torch.core.futures import PersistentRequest, flatten, unflatten
from repro_torch.launch import dryrun, specs, steps
from repro_torch.optim import AdamW
from torch_ranks import finish_ranks, start_jax, start_ranks

torch.set_num_threads(1)

WORLD = 4

REFERENCE = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, "tests/port")
    import jax, jax.numpy as jnp
    from repro import core as mpx
    from repro.analysis import hlo as hlo_passes
    from torch_ranks import hlo_verdicts

    comm = mpx.world()
    N, name, lax = comm.size(), comm.axis_names[0], jax.lax
    x = jax.ShapeDtypeStruct((8 * N, 16), jnp.float32)

    def compile_(fn):
        return jax.jit(comm.spmd(fn, jit=False)).lower(x).compile()

    psum = compile_(lambda v: lax.psum(v, name))
    ring = compile_(lambda v: lax.ppermute(v, name, [(i, (i + 1) % N) for i in range(N)]))
    gather = compile_(lambda v: lax.all_gather(v, name))
    parity = hlo_passes.identical_lowering(comm.allreduce_init(x),
                                           compile_(lambda v: comm.allreduce(v)))
    print("HLO_REF " + json.dumps({
        "table": hlo_verdicts(hlo_passes, psum, ring, gather, N),
        "parity": [parity.name, parity.ok, parity.detail]}))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's programs on 4 virtual devices and the port's on 4
    gloo ranks, started together."""

    work = tmp_path_factory.mktemp("hlo_passes")
    rng = np.random.default_rng(0)
    inputs = {"x": rng.standard_normal((WORLD, 8 * WORLD, 16)).astype(np.float32)}
    for t in "qkv":     # (b, s, h, d): 16 rows a rank, one key block
        inputs[f"ring_{t}"] = rng.standard_normal((1, 16 * WORLD, 2, 8)).astype(np.float32)
    inputs["router"] = rng.standard_normal((16, 2 * WORLD)).astype(np.float32)
    for name, shape in (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16))):
        inputs[name] = (rng.standard_normal((2 * WORLD, *shape)) * 0.2).astype(np.float32)
    inputs["moe_x"] = rng.standard_normal((4 * WORLD, 16)).astype(np.float32)
    np.savez(work / "inputs.npz", **inputs)
    jax_proc = start_jax(REFERENCE + "\n", work, n=WORLD)
    started = start_ranks("hlo_passes", WORLD, work, timeout=240)
    ranks = finish_ranks(started)
    out, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0 and "HLO_REF " in out, f"{out}\n{err[-4000:]}"
    line = next(x for x in out.splitlines() if x.startswith("HLO_REF "))
    return json.loads(line[len("HLO_REF "):]), [
        {k: json.loads(str(v)) if v.dtype.kind == "U" else v for k, v in r.items()}
        for r in ranks]


# -- (a) the reference test's three programs -------------------------------------


@pytest.mark.parametrize("rank", range(WORLD))
def test_reference_programs_give_the_references_rows_and_verdicts(runs, rank):
    """Every rank's ``stats_dict`` of the all-reduce, the ring permute and
    the all-gather, and every pass's verdict and evidence, equal the
    reference's SPMD module's (the wire bytes of ``dist.*`` collectives
    read 0 before ROADMAP C29's repair)."""

    reference, ranks = runs
    want, got = json.loads(reference["table"]), ranks[rank]["verdicts"]
    assert got["stats"] == want["stats"]
    assert got["stats"]["psum"] == {"counts": {"all-reduce": 1}, "operand_bytes": 2048.0,
                                    "wire_bytes": 2048.0 * 2 * 3 / 4}
    assert got["verdicts"] == want["verdicts"]
    # every pass fails somewhere and holds somewhere
    sides = {}
    for name, (_, ok, *_rest) in got["verdicts"].items():
        sides.setdefault(name.split(":")[0], set()).add(ok)
    assert sides == {p: {True, False} for p in (
        "no_collective", "collective_count", "permute_count", "identical_lowering",
        "wire_fraction_below", "neighbor_sparsity", "ring_schedule", "pvar_invariant")}


# -- (b) persistent against immediate and raw --------------------------------------


def test_persistent_allreduce_lowers_as_the_immediate_and_raw_all_reduce(runs):
    reference, ranks = runs
    assert reference["parity"][1] is True
    for r in ranks:
        parity = r["parity"]
        assert parity["immediate"] == reference["parity"]
        assert parity["raw"][1] is True and parity["raw"][2] == parity["immediate"][2]
        assert parity["gather"][1] is False
        # recorded on owned zeros before any start: no start counted
        assert r["parity_starts"].tolist() == [0, 0]


# -- (c) the ring, (d) the pipeline, (e) the MoE graph ----------------------------


def test_ring_attention_is_n_minus_one_permutes_of_one_kv_shard(runs):
    for r in runs[1]:
        ring = r["ring"]
        assert ring["schedule"] == ["ring-schedule", True, {
            "permutes": WORLD - 1, "expected_permutes": WORLD - 1, "kv_allgathers": 0,
            "per_step_wire_fraction": 1.0 / WORLD}]
        assert ring["schedule_wrong_n"][1] is False
        assert ring["stats"]["counts"] == {"collective-permute": WORLD - 1}


def test_pipeline_stage_traffic_is_permutes_with_no_all_to_all(runs):
    stages = []
    for r in runs[1]:
        p = r["pipeline"]
        assert p["counts"].get("collective-permute", 0) > 0, p
        assert p["no_alltoall"][1] is True, p
        assert p["recorded_once"] and p["starts"] == 2
        stages.append(p["stage"])
    assert sorted(stages) == [0, 0, 1, 1]


def test_moe_neighbor_at_radius_one_stays_sparse(runs):
    for r in runs[1]:
        moe = r["moe"]
        assert moe["no_alltoall"][1] is True, moe
        assert moe["counts"].get("collective-permute", 0) > 0, moe
        assert moe["sparsity"][1] is True and moe["sparsity"][2]["fraction"] < 1.0, moe


# -- (f) PassResult and pvar_invariant ----------------------------------------------


@pytest.mark.parametrize("passes", [jhlo, thlo], ids=["reference", "port"])
def test_pass_result_protocol_and_pvar_invariant(passes):
    good = passes.PassResult("p", True, {"x": 1})
    bad = passes.PassResult("p", False, {"x": 2})
    assert good and not bad
    assert "ok" in str(good) and "FAIL" in str(bad)
    counters = {"trace:train_step": 1}
    assert passes.pvar_invariant(counters, "trace:train_step", 1).ok
    r = passes.pvar_invariant(counters, "trace:train_step", 2)
    assert not r.ok and r.detail["got"] == 1
    assert not passes.pvar_invariant({}, "trace:train_step", 1).ok
    assert str(thlo.PassResult("p", True, {"x": 1})) == str(jhlo.PassResult("p", True, {"x": 1}))


# -- (g) the cost of a step, and recording once -------------------------------------


def test_cost_analysis_of_a_smoke_step_is_the_dry_runs_count():
    """The two-layer smoke phi4-mini train step (b 2 x 32) as a persistent
    request on real tensors: ``cost_analysis()`` (recorded on owned zeros)
    equals the dry run's count of the same step on fake stand-ins."""

    arch, shape = "phi4_mini_3_8b", "train_32"
    rec = dryrun.run_cell(arch, shape, False, {}, "", device="cpu", grid="1x1", batch=2,
                          smoke=True)
    cfg, pcfg = tbase.get_smoke_config(arch), tbase.get_parallel(arch)
    assert cfg.num_layers == 2
    opt = AdamW(lr=1e-4, moment_dtype=pcfg.moment_dtype)
    kind, (structs, _) = specs.cell_structs(arch, dryrun.shape_config(shape, 2),
                                            {"data": 1, "model": 1}, pcfg, opt=opt, cfg=cfg)
    real = {}
    for name, tree in structs.items():
        leaves, treedef = flatten(tree)
        real[name] = unflatten(treedef, [torch.zeros(tuple(x.shape), dtype=x.dtype)
                                         for x in leaves])
    for leaf in flatten(real["params"])[0]:
        leaf.requires_grad_(True)
    req = steps.make_persistent_step(kind, cfg, pcfg, steps.example_args(kind, real), opt)
    cost = req.cost_analysis()
    assert rec["status"] == "ok" and req.starts == 0
    assert cost == {"flops": rec["roofline"]["hlo_flops"],
                    "bytes accessed": rec["roofline"]["hlo_bytes"]}
    assert req.compiled.kernels() == {}      # the CPU runs the kernels' plain versions


def test_program_is_recorded_at_one_start_only(monkeypatch):
    """An eager request records at its first start and never after; one
    asked for its program first records on owned zeros (a run of the step
    that is no start) and not at its starts."""

    recorded = []
    real = hloanalysis.record

    def counting(fn, *args, **kwargs):
        recorded.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(hloanalysis, "record", counting)
    calls = []

    def step(x):
        calls.append(x)
        return x * 2.0 + 1.0

    req = PersistentRequest(step, (torch.ones(4),))
    for i in range(3):
        req.start(torch.full((4,), float(i))).get()
    assert len(recorded) == 1 and len(calls) == 3
    program = req.compiled
    assert [op.op for op in program.ops] == ["aten.mul.Tensor", "aten.add.Tensor"]
    assert req.compiled is program and len(recorded) == 1

    asked = PersistentRequest(step, (torch.ones(4),))
    before = tool.pvar_read().get("persistent_start", 0)
    text = asked.as_text()
    assert len(recorded) == 2 and len(calls) == 4 and torch.equal(calls[-1], torch.zeros(4))
    assert asked.starts == 0 and tool.pvar_read().get("persistent_start", 0) == before
    asked.start(torch.ones(4)).get()
    asked.start(torch.ones(4)).get()
    assert len(recorded) == 2 and asked.as_text() == text == program.as_text()


def test_failed_recording_raises_and_leaves_no_program(monkeypatch):
    def broken(*args, **kwargs):
        raise ValueError("formula")

    req = PersistentRequest(lambda x: x + 1.0, (torch.ones(2),))
    monkeypatch.setattr(hloanalysis, "_op", broken)
    with pytest.raises(errors.Error) as ei:
        req.as_text()
    assert ei.value.klass is errors.ErrorClass.ERR_OTHER and "formula" in str(ei.value)
    assert req._program is None
    monkeypatch.undo()
    assert thlo.no_collective(req).ok and req.compiled.ops


@pytest.mark.parametrize("text", [
    "", "%0 = aten.mm.default(f32[2,2]) -> (f32[2,2]) flops=16 bytes=48",
    "# repro_torch program: 2 ops\n%0 = aten.mm.default(f32[2,2]) -> (f32[2,2]) flops=16 bytes=48",
    "# repro_torch program: 1 ops\nHloModule jit_f"])
def test_text_that_is_not_a_whole_program_is_refused(text):
    for read in (hloanalysis.analyze_hlo, tool.parse_hlo_collectives, thlo.stats_dict):
        with pytest.raises(errors.Error) as ei:
            read(text)
        assert ei.value.klass is errors.ErrorClass.ERR_ARG
    with pytest.raises(errors.Error):
        thlo.collective_stats(lambda: None)


def test_program_text_reads_back_as_recorded():
    """A program's text gives back its ops' flops and bytes, and a
    collective line its bytes over its group."""

    x, w = torch.randn(8, 16), torch.randn(16, 32, dtype=torch.bfloat16)
    program = thlo.record_program(lambda a, b: (a.to(b.dtype) @ b).sum(), x, w)
    cost = hloanalysis.analyze_hlo(program.as_text())
    assert cost.flops == 2 * 8 * 16 * 32 == sum(op.flops for op in program.ops)
    assert cost.bytes == sum(op.bytes for op in program.ops) > 0
    line = ("# repro_torch program: 1 ops\n%0 = c10d.allgather_.default(bf16[32,16] "
            "bf16[8,16]) -> (bf16[32,16]) kind=all-gather group=4 operand=bf16[8,16] "
            "result=bf16[32,16]")
    st = tool.parse_hlo_collectives(line)
    assert (dict(st.count), st.total_operand_bytes, st.total_wire_bytes) == (
        {"all-gather": 1}, 256.0, 1024 * 3 / 4)
    # two programs one after another read as one (a persistent collective's buckets)
    assert thlo.stats_dict(line + "\n" + line)["counts"] == {"all-gather": 2}
