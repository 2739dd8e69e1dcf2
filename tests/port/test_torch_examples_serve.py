"""The port's examples against the reference's scripts, part 1: the
paper's listings, the file I/O and the serving examples (``examples/`` and
``examples_torch/``: ``quickstart``, ``async_checkpoint``,
``serve_batched``, ``continuous_batching_serve``).

Each test runs the reference's script in a fresh JAX process with ``n``
virtual devices and the port's on ``n`` gloo ranks with ``--device cpu``
and the script's ``# lint-args``, where ``n`` is the script's ``#
lint-ranks`` (``example_runs.run``).  Lines that do not depend on the
weights' draw are held equal; tokens are held equal at temperature 0 with
the reference's weights (converted); each script's own parity line must
print on every rank.  The port's run is recorded as the lint records a
target, and the analyzer's checkers must find nothing in it: with these
tests, ``python -m repro_torch.analysis.lint examples_torch/ --strict``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import example_runs as ex  # noqa: E402

from repro_torch.analysis import lint  # noqa: E402


def _ranks(name: str) -> int:
    return lint._lint_ranks(ex.ROOT / "examples_torch" / f"{name}.py")


def test_quickstart_listings_on_eight_ranks(tmp_path):
    """Listing 1's allreduced ``Particle``, Listing 2's chained broadcasts
    and the fork/join, on 8 ranks as on the reference's 8 devices."""

    n = _ranks("quickstart")
    assert n == 8
    runs = ex.run("quickstart", n, tmp_path)
    assert runs.findings == []
    for lines, res in zip(runs.port_lines, runs.port):
        for prefix in ("world:", "position:", "Listing 2", "task graph"):
            assert ex.line(lines, prefix) == ex.line(runs.ref_lines, prefix)
        assert res["position"] == [8.0] * 3 and res["velocity"] == [28.0] * 3
        assert res["mass"] == 8.0 and res["listing2"] == 3 and res["task_graph"] == 128.0
    assert ex.line(runs.ref_lines, "position:") == (
        "position: [8. 8. 8.]  velocity: [28. 28. 28.]  mass: 8.0")


def test_quickstart_on_a_world_of_one():
    """ROADMAP C33: the reference's script raises ``ERR_ROOT`` below three
    devices (Listing 2 broadcasts from roots 1 and 2); the port's takes each
    root modulo the world, so one card runs both listings."""

    import runpy

    main = runpy.run_path(str(ex.ROOT / "examples_torch" / "quickstart.py"))["main"]
    res = main(["--device", "cpu"])
    assert res["world"] == 1 and res["listing2"] == 3 and res["task_graph"] == 100.0
    assert res["position"].tolist() == [1.0] * 3 and float(res["mass"]) == 1.0


def test_async_checkpoint_io_lines(tmp_path):
    runs = ex.run("async_checkpoint", _ranks("async_checkpoint"), tmp_path)
    assert runs.findings == []
    (res,), (lines,) = runs.port, runs.port_lines
    for prefix in ("restored step", "paged view round-trip", "when_all + then", "ok"):
        assert ex.line(lines, prefix) == ex.line(runs.ref_lines, prefix)
    assert res["names"] == ["a", "b", "c"] and res["restored_step"] == 1
    assert (res["fragments"], res["groups"]) == (8, 2)
    # the torn save's typed failure: the port's buckets are chunks of a
    # dtype ("float32.0"; the reference has one request a dtype, "float32")
    port_torn = ex.line(lines, "torn save surfaced")
    ref_torn = ex.line(runs.ref_lines, "torn save surfaced")
    assert port_torn.replace("bucket float32.0", "bucket float32") == ref_torn
    assert ex.line(lines, "async save issued").startswith("async save issued in")


def test_serve_batched_tokens_at_temperature_zero(tmp_path):
    """gemma2's smoke model, 4 prompts of 64 tokens, 24 new, on the
    reference's weights in fp32 (``example_runs``: in bf16 8 of the 96
    tokens flip): the same tokens on every rank as the reference's at
    temperature 0."""

    from repro.configs import base as jbase

    n = _ranks("serve_batched")
    cfg = jbase.get_smoke_config("gemma2_9b")
    params = ex.reference_params({**_fields(cfg), "dtype": "float32"})
    runs = ex.run("serve_batched", n, tmp_path, argv=("--temperature", "0"),
                  hooks={"params": params}, dtype="float32")
    assert runs.findings == []
    (ref_tokens,) = runs.ref["serve"]
    for res, lines in zip(runs.port, runs.port_lines):
        assert res["shape"] == [4, 24]
        np.testing.assert_array_equal(res["tokens"], ref_tokens)
        for prefix in ("arch=", "first sequence:"):
            assert ex.line(lines, prefix) == ex.line(runs.ref_lines, prefix)


def test_continuous_batching_serve_matches_the_reference_engine(tmp_path):
    """The engine's stats, every request's generated tokens and the
    script's own oracle parity, on the reference's weights."""

    from repro.configs.base import ModelConfig

    cfg = dict(name="demo", family="dense", num_layers=2, d_model=64, num_heads=4,
               num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, dtype="float32")
    assert ModelConfig(**cfg)
    runs = ex.run("continuous_batching_serve", _ranks("continuous_batching_serve"), tmp_path,
                  hooks={"params": ex.reference_params(cfg)})
    assert runs.findings == []
    ref_requests = [s.strip() for s in runs.ref_lines if s.strip().startswith("request ")]
    assert len(ref_requests) == 6
    for res, lines in zip(runs.port, runs.port_lines):
        assert res["parity"]
        assert ex.line(lines, "parity:") == ex.line(runs.ref_lines, "parity:")
        assert ex.line(lines, "6 requests in") == ex.line(runs.ref_lines, "6 requests in")
        assert [s.strip() for s in lines if s.strip().startswith("request ")] == ref_requests


EXAMPLES = sorted(p.stem for p in (ex.ROOT / "examples_torch").glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name):
    """No fallback: without ``--device cpu`` on a machine with no card,
    every example raises ``ERR_SESSION`` (as the port's CLIs)."""

    import runpy

    import torch

    from repro_torch.core import errors

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    main = runpy.run_path(str(ex.ROOT / "examples_torch" / f"{name}.py"))["main"]
    with pytest.raises(errors.SessionError):
        main([])


def _fields(cfg) -> dict:
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
