"""The repairs of ROADMAP C26 and C27 on placed grids.

* C26: torch 2.11's DTensor cannot carry some ops at the production
  grids' placements (a flatten of a split head dim in the decode
  attention's, the cross-attention's and the SSD decode step's einsums;
  ``aten.roll``; ``index_add`` with split indices), where torch 2.13's can.
  Each rewritten function runs on 2 x 2 gloo ranks, on DTensors placed as
  the models place them, and must be its former form on the same DTensors
  bit for bit, and the plain function on whole tensors (within 1e-6 where
  the shards' matmuls add in another order).  The serving and training
  parity tests (``test_torch_sharded.py``, ``test_torch_moe.py``) hold the
  models that run them against the reference.
* C27: the placed prefill held its FSDP-gathered weights whole, and its
  KV entries twice (each layer's and their stack).  The smoke model at 32
  layers, d 256, 2 x 128, bf16 traced by the dry run on a fake 2 x 2 grid
  must hold at most 0.6 times the whole batch's cache of activations a
  rank (3.04 before the repair, the gathered model's included); on 1 x 1
  and 4 x 1 (whole weights) no more than before (2.02).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from torch_ranks import finish_ranks, start_ranks

ROOT = Path(__file__).resolve().parents[2]

#: activations a rank traced over the whole batch's cache: the bound on 2 x
#: 2, and on the grids of whole weights the figure before the repair
C27_BOUND = 0.6
C27_BEFORE_WHOLE = 2.02

C27_CELL = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import base
    from repro_torch.launch import dryrun

    smoke = base.get_smoke_config
    base.get_smoke_config = lambda arch: dataclasses.replace(
        smoke(arch), num_layers=32, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512)
    grid = sys.argv[1]
    rec = dryrun.run_cell("qwen1_5_32b", "prefill_128", False, {}, "", device="cpu",
                          grid=grid, batch=2, smoke=True)
    cfg = base.get_smoke_config("qwen1_5_32b")
    cache = 2 * 2 * 128 * cfg.num_kv_heads * cfg.head_dim * 2 * cfg.num_layers
    print("C27 " + json.dumps({"status": rec["status"], "cache": cache,
                               "activation": rec["memory"]["peak_by_category"]["Activation"]}))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank program and the three dry-run cells, started together."""

    work = tmp_path_factory.mktemp("placed_repairs")
    np.savez(work / "inputs.npz", seed=np.array(0))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    cells = {grid: subprocess.Popen([sys.executable, "-c", C27_CELL, grid],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=env, cwd=str(ROOT))
             for grid in ("2x2", "1x1", "4x1")}
    started = {"ranks": start_ranks("placed_repairs", 4, work), "cells": cells}
    yield started
    for proc in cells.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ranks(runs):
    return finish_ranks(runs["ranks"])


@pytest.fixture(scope="module")
def c27(runs):
    out = {}
    for grid, proc in runs["cells"].items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        assert proc.returncode == 0, f"{grid}: rc={proc.returncode}\n{stderr[-4000:]}"
        line = next(x for x in stdout.splitlines() if x.startswith("C27 "))
        out[grid] = json.loads(line[4:])
    return out


def _held(got, old, plain, rtol=1e-6):
    """The rewritten function's result is its former form's bit for bit
    and the plain function's."""

    np.testing.assert_array_equal(got, old)
    np.testing.assert_allclose(got, plain, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("hk", [4, 2, 1])
def test_c26_decode_attention_on_local_shards(ranks, hk):
    """(The former form on DTensors is compared where torch 2.13 carries
    it: with 4 kv heads, none to repeat across the split.)"""

    for r in ranks:
        new, old, plain = r[f"decode{hk}"]
        _held(new, old, plain)
        np.testing.assert_array_equal(new, ranks[0][f"decode{hk}"][0])
        got, was = r[f"decode{hk}_placements"]
        assert got == "(Shard(dim=0), Shard(dim=2))", (got, was)


@pytest.mark.parametrize("what", ["cross_y", "cross_dh", "cross_dk", "cross_dv"])
def test_c26_cross_attention_and_its_gradients_on_local_shards(ranks, what):
    for r in ranks:
        new, old, plain = r[what]
        _held(new, old, plain, rtol=1e-5)


@pytest.mark.parametrize("groups", [2, 1])
def test_c26_ssd_decode_step_on_local_shards(ranks, groups):
    """(The former form on DTensors is compared where torch 2.13 carries
    it: one group, whole on every model rank.)"""

    for r in ranks:
        for part in ("y", "state"):
            new, old, plain = r[f"ssd{groups}_{part}"]
            _held(new, old, plain)
        got, state = r[f"ssd{groups}_placements"]
        assert got == state   # the new state keeps the cache's layout


@pytest.mark.parametrize("rows", ["aux_both", "aux_data"])
def test_c26_moe_counts_over_split_rows(ranks, rows):
    for r in ranks:
        new, old, plain = r[rows]
        _held(new, old, plain)


@pytest.mark.parametrize("shift", [0, 5])
def test_c26_roll_as_a_concatenation(ranks, shift):
    for r in ranks:
        new, old, plain_new, plain_old = r[f"roll{shift}"]
        np.testing.assert_array_equal(new, old)
        np.testing.assert_array_equal(plain_new, plain_old)
        np.testing.assert_array_equal(new, plain_old)
        got, was = r[f"roll{shift}_placements"]
        assert got == was


@pytest.mark.parametrize("case", ["0", "3", "_seq"])
def test_c27_entries_written_into_the_stacked_cache(ranks, case):
    """Without headroom, with 3 slots of it, and entries whose sequence is
    split (stacked and padded as a whole: the headroom is left to pad)."""

    for r in ranks:
        for got, want in r[f"stack{case}"]:
            np.testing.assert_array_equal(got, want)
        left, got_pl, want_pl, got_local, want_local = r[f"stack{case}_meta"]
        assert int(left) == (3 if case == "_seq" else 0)
        if case != "_seq":
            assert got_pl == want_pl and got_local == want_local


def test_c27_placed_prefill_holds_a_share_of_the_cache(c27):
    ratios = {g: c["activation"] / c["cache"] for g, c in c27.items()}
    assert all(c["status"] == "ok" for c in c27.values()), c27
    assert ratios["2x2"] <= C27_BOUND, ratios
    assert ratios["1x1"] <= C27_BEFORE_WHOLE and ratios["4x1"] <= C27_BEFORE_WHOLE, ratios
