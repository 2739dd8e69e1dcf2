"""The port's examples against the reference's scripts, part 3: the
examples over process sets and epochs (``session_train_serve``,
``elastic_train``), and the straggler verdicts their runs showed to be
each rank's own (ROADMAP C31, C32).

Each runs the reference's script on ``n`` virtual devices beside the
port's on ``n`` gloo ranks (``n`` the script's ``# lint-ranks``), both in
fp32 from the reference's initial weights (``example_runs``): the losses
within ``test_torch_trainer.py``'s 1e-4 relative, steps, evictions,
hot-joins, epochs and world sizes equal, tokens equal at temperature 0,
and the analyzer's checkers find nothing in the port's recorded run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import example_runs as ex  # noqa: E402

from repro_torch.analysis import lint  # noqa: E402

#: test_torch_trainer.py's bound on the loss trajectory
LOSS_RTOL = 1e-4


def _ranks(name: str) -> int:
    return lint._lint_ranks(ex.ROOT / "examples_torch" / f"{name}.py")


def test_session_train_serve_on_disjoint_sets(tmp_path):
    """4 ranks: the train set (ranks 0-1) trains 10 steps on a (2, 1) fold,
    the serve set (ranks 2-3) serves 4 prompts, with no rank in both; the
    trainer's losses and the server's tokens are the reference's on its 2 +
    2 devices."""

    n = _ranks("session_train_serve")
    assert n == 4
    cfg = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
               num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32")
    runs = ex.run("session_train_serve", n, tmp_path,
                  hooks={"params": ex.reference_params(cfg)}, dtype="float32")
    assert runs.findings == []
    (ref_train,), (ref_tokens,) = runs.ref["train"], runs.ref["serve"]
    overlap = "overlapping devices: 0 (expect 0 with >1 device)"
    assert ex.line(runs.ref_lines, "overlapping devices") == overlap
    for rank, (res, lines) in enumerate(zip(runs.port, runs.port_lines)):
        assert ex.line(lines, "overlapping devices") == overlap
        assert (res["train_size"], res["serve_size"], res["overlap"]) == (2, 2, 0)
        if rank < 2:
            assert "tokens" not in res
            assert res["final_step"] == ref_train["final_step"] == 10
            np.testing.assert_allclose(res["losses"], ref_train["losses"], rtol=LOSS_RTOL,
                                       atol=0)
            assert ex.line(lines, "trained to step") == ex.line(runs.ref_lines,
                                                                "trained to step")
        else:
            assert "losses" not in res
            assert res["shape"] == [4, 8]
            np.testing.assert_array_equal(res["tokens"], ref_tokens)
            assert ex.line(lines, "served").endswith("on 2 devices")


def test_elastic_train_shrinks_and_grows_as_the_reference(tmp_path):
    """8 ranks on a (4, 2) fabric, rank 2 evicted at step 5 and a spare
    admitted at step 8: epoch 2, world size 8, one eviction, one hot-join,
    no restart, and the survivors' losses, as the reference's on 8
    devices.  ROADMAP C30: the (4, 2) fabric's placed step at a global
    batch of 12 (rows that do not split over all 8 ranks) raised in the
    MLP's product before ``mlp.mlp`` reduced its input's pending sum."""

    n = _ranks("elastic_train")
    assert n == 8
    cfg = dict(name="tiny", family="dense", num_layers=1, d_model=32, num_heads=2,
               num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, dtype="float32")
    runs = ex.run("elastic_train", n, tmp_path,
                  hooks={"params": ex.reference_params(cfg, seed=7)}, dtype="float32")
    assert runs.findings == []
    (ref,) = runs.ref["train"]
    summary = ex.line(runs.ref_lines, "finished step 10")
    assert summary == ("finished step 10 on epoch 2 (world size 8): 1 eviction(s), "
                       "1 hot-join(s), 0 job restarts")
    for rank, (res, lines) in enumerate(zip(runs.port, runs.port_lines)):
        assert ex.line(lines, "finished step 10") == summary
        for key in ("final_step", "epoch", "world_size", "evictions", "joins", "restarts"):
            assert res[key] == ref[key], (rank, key)
        if rank == 0:
            assert res["steps"] == ref["steps"]
            np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)


def test_c31_c32_straggler_verdicts_are_the_epochs(tmp_path):
    """ROADMAP C31: each rank is a process with its own clock; one rank
    whose step looked slow restored alone while the other went on (the
    elastic example hung on a loaded host).  Both ranks now take the
    epoch's verdict and restore together.  C32: an epoch's first start
    (the eager warm-up that records the step's program) is known work, as
    the reference's ahead-of-time compile is, and no straggler: a shrink
    and a grow, each first start 100x a step, end with no restart."""

    from torch_ranks import run_ranks

    np.savez(tmp_path / "inputs.npz", work=np.array(str(tmp_path)))
    ranks = run_ranks("straggler", 2, tmp_path, timeout=150)
    for out in ranks:
        assert int(out["agree/final_step"]) == 10 and int(out["agree/restarts"]) == 1
        assert int(out["first_start/final_step"]) == 10
        assert int(out["first_start/restarts"]) == 0
        assert (int(out["first_start/evictions"]), int(out["first_start/joins"])) == (1, 1)
        assert int(out["first_start/world_size"]) == 2
