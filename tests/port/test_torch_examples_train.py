"""The port's examples against the reference's scripts, part 2: the
training examples (``fault_tolerant_train``, ``train_lm``).

Each runs the reference's script on ``n`` virtual devices beside the
port's on ``n`` gloo ranks (``n`` the script's ``# lint-ranks``), both in
fp32 from the reference's initial weights (``example_runs``): the losses
within ``test_torch_trainer.py``'s 1e-4 relative, steps, recoveries,
evictions, hot-joins, epochs and world sizes equal, tokens equal at
temperature 0, and the analyzer's checkers find nothing in the port's
recorded run.
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


def _held(port: dict, ref: dict, keys: tuple[str, ...]) -> None:
    for key in keys:
        assert port[key] == ref[key], (key, port[key], ref[key])
    assert port["steps"] == ref["steps"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)


def test_fault_tolerant_train_recovers_as_the_reference(tmp_path):
    """Two injected failures (steps 17 and 28), each restoring the newest
    checkpoint and replaying, on 2 ranks: the recoveries, the final step
    and the logged losses of every step the run kept."""

    cfg = dict(name="demo", family="dense", num_layers=2, d_model=128, num_heads=4,
               num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=4_096,
               tie_embeddings=True, dtype="float32")
    runs = ex.run("fault_tolerant_train", _ranks("fault_tolerant_train"), tmp_path,
                  hooks={"params": ex.reference_params(cfg)}, dtype="float32")
    assert runs.findings == []
    (ref,) = runs.ref["train"]
    prefix = "finished step 40 after 2 recoveries"
    for res, lines in zip(runs.port, runs.port_lines):
        assert ex.line(lines, prefix) == ex.line(runs.ref_lines, prefix)
        assert (res["final_step"], res["restarts"]) == (40, 2)
        _held(res, ref, ("final_step", "restarts"))


def test_train_lm_small_matches_the_reference(tmp_path):
    """``--small`` (the ~14M model) for 20 steps, logged at 10 and 20: the
    loss falls in both and the two trajectories agree."""

    namespace = __import__("runpy").run_path(str(ex.ROOT / "examples" / "train_lm.py"))
    cfg = {**_fields(namespace["model_small"]()), "dtype": "float32"}
    argv = ("--small", "--steps", "20")
    runs = ex.run("train_lm", _ranks("train_lm"), tmp_path,
                  argv=(*argv, "--checkpoint-dir", str(tmp_path / "port_ckpt")),
                  ref_argv=(*argv, "--checkpoint-dir", str(tmp_path / "ref_ckpt")),
                  hooks={"params": ex.reference_params(cfg)}, dtype="float32")
    assert runs.findings == []
    (ref,) = runs.ref["train"]
    assert ref["steps"] == [10, 20]
    for res, lines in zip(runs.port, runs.port_lines):
        assert ex.line(lines, "model:") == ex.line(runs.ref_lines, "model:")
        assert res["final_step"] == 20 and res["losses"][-1] < res["losses"][0]
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL, atol=0)
        assert ex.line(lines, "steps: 20").split("loss:")[0] == \
            ex.line(runs.ref_lines, "steps: 20").split("loss:")[0]


def _fields(cfg) -> dict:
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
