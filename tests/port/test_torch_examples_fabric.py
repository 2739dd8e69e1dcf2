"""The port's examples against the reference's scripts, part 4: the
fabrics (``disaggregated_serve``, ``pipeline_expert_train``,
``long_context_train``), each on 4 gloo ranks beside the reference's on 4
virtual devices, from the reference's weights.

A recorded program is one rank's (``core/hloanalysis.py``): a stage
boundary counts a ``collective-permute`` at the rank that sends, where the
reference's one SPMD program holds each boundary's permute once for every
device.  So the pipeline's permutes are held as the sum over the stages of
one data row (stage 0 sends the activations, stage 1 the gradients), and
all-reduces, which the port issues a gradient leaf at a time where XLA
combines them, are not compared.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import example_runs as ex  # noqa: E402

from repro_torch.analysis import lint  # noqa: E402

#: test_torch_trainer.py's bound on the loss trajectory
LOSS_RTOL = 1e-4

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32")


def _ranks(name: str) -> int:
    n = lint._lint_ranks(ex.ROOT / "examples_torch" / f"{name}.py")
    assert n == 4
    return n


def test_disaggregated_serve_parity_and_transfer(tmp_path):
    """Prefill on ranks 0-1, decode on ranks 2-3: the tokens equal the
    single-group baseline's (the script's own check) and the reference's;
    the transfer's pages and bytes, the groups' sizes and each rank's RMA
    pvars (the reference's line)."""

    runs = ex.run("disaggregated_serve", _ranks("disaggregated_serve"), tmp_path,
                  hooks={"params": ex.reference_params(TINY)})
    assert runs.findings == []
    (base,) = runs.ref["serve"]   # the baseline's (the reference checks its own parity)
    parity = ex.line(runs.ref_lines, "token-for-token parity")
    assert parity == "token-for-token parity with the single-group baseline: OK (4, 12)"
    ref_stats = _stats(runs.ref_lines)
    for res, lines in zip(runs.port, runs.port_lines):
        assert res["parity"] and ex.line(lines, "token-for-token parity") == parity
        np.testing.assert_array_equal(res["tokens"], base)
        for prefix in ("overlapping devices", "decode pset:", "prefill pset:"):
            assert ex.line(lines, prefix) == ex.line(runs.ref_lines, prefix)
        port_stats = _stats(lines)
        # "KV 72.0 KiB in 4 pages", the devices of each group
        assert port_stats[1].split("(")[0] == ref_stats[1].split("(")[0]
        assert port_stats[0].split(" on ")[1] == ref_stats[0].split(" on ")[1]
        assert port_stats[2].split(" on ")[1] == ref_stats[2].split(" on ")[1]
        assert res["stats"]["kv_pages"] == 4
        assert ex.line(lines, "pvars:") == ex.line(runs.ref_lines, "pvars:")
        assert {k: v for k, v in res["pvars"].items() if v} == {
            "rma_fence": 2, "rma_rput": 4, "trace:kv_transfer": 1}


def _stats(lines: list[str]) -> list[str]:
    """The disaggregated run's stats line, split at its bars."""

    (found,) = [s for s in lines if s.startswith("prefill ") and " | " in s]
    return found.split("|")


def test_pipeline_expert_train_matches_the_reference(tmp_path):
    """The pipeline demo on a (data 2, stage 2) cart: the topology, one
    trace and ten starts, the losses, and the stage boundaries' permutes
    (the sum over one data row's stages) with no all-to-all; the expert
    demo over the radius-1 graph: rank 0's neighbours, the output, the
    dropped fraction and the two ``neighbor_alltoallv`` calls."""

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.base import ModelConfig
    from repro.models import mlp as jmlp

    n = _ranks("pipeline_expert_train")
    moe_cfg = ModelConfig(**{**TINY, "family": "moe", "num_experts": 2 * n, "moe_top_k": 2,
                             "moe_d_ff": 96})
    moe = jmlp.init_moe(jax.random.PRNGKey(0), moe_cfg, jnp.float32)
    tokens = jax.random.normal(jax.random.PRNGKey(1), (8 * n, moe_cfg.d_model))

    hooks = {"params": ex.reference_params(TINY),
             "moe_params": {k: torch.from_numpy(np.array(v)) for k, v in moe.items()},
             "tokens": torch.from_numpy(np.array(tokens))}
    runs = ex.run("pipeline_expert_train", n, tmp_path, hooks=hooks)
    assert runs.findings == []
    (ref,) = runs.ref["train"]
    ref_counts = ast.literal_eval(ex.line(runs.ref_lines, "step collectives:")
                                  .split(": ", 1)[1].split(" (")[0])
    permutes = [res["pipeline"]["collectives"].get("collective-permute", 0)
                for res in runs.port]
    for res, lines in zip(runs.port, runs.port_lines):
        pipe, expert = res["pipeline"], res["expert"]
        assert pipe["dims"] == [2, 2]
        for prefix in ("pipeline topology", "expert graph", "dispatched"):
            assert ex.line(lines, prefix) == ex.line(runs.ref_lines, prefix)
        assert (pipe["traces"], pipe["persistent_starts"]) == (1, 10)
        assert ex.line(lines, "trained to step").split("—")[1] == \
            ex.line(runs.ref_lines, "trained to step").split("—")[1]
        assert pipe["steps"] == ref["steps"] and pipe["final_step"] == 10
        np.testing.assert_allclose(pipe["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)
        assert "all-to-all" not in pipe["collectives"]
        assert expert["neighbor_alltoallv"] == 2 and expert["out_shape"] == [32, 64]
    # ranks 0, 1 are data row 0's stages 0 and 1 (likewise 2, 3)
    assert permutes[0] + permutes[1] == permutes[2] + permutes[3] == \
        ref_counts["collective-permute"]
    assert "all-to-all" not in ref_counts


def test_long_context_train_ring_parity_and_losses(tmp_path):
    """The ring's parity with the dense reference on a ring of 4, then 3
    steps at 1,024 tokens a sequence under ``ParallelPlan(ring=4)`` on a
    (1, 4) cart: the reference's losses."""

    runs = ex.run("long_context_train", _ranks("long_context_train"), tmp_path,
                  hooks={"params": ex.reference_params(TINY)})
    assert runs.findings == []
    (ref,) = runs.ref["train"]
    parity = ex.line(runs.ref_lines, "parity:")
    assert parity == "parity: ring(4) == dense reference at S=128"
    for res, lines in zip(runs.port, runs.port_lines):
        assert res["parity"] and ex.line(lines, "parity:") == parity
        assert res["dims"] == [1, 4] and res["steps"] == ref["steps"] == [1, 2, 3]
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)
        # the reference prints a (2, 4) cart on any device count (ROADMAP C34)
        assert ex.line(lines, "trained 1024-token").replace("(1, 4)", "(2, 4)").split(
            ": final")[0] == ex.line(runs.ref_lines, "trained 1024-token").split(": final")[0]
