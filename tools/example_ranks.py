#!/usr/bin/env python3
"""The port's examples that need a world of four, across four cards:
``examples_torch/long_context_train.py`` (the ring's parity check on a ring
of 4, then ``ParallelPlan(ring=4)`` training, both through the ring-step
kernel on a real ring) and ``examples_torch/elastic_train.py`` (a (2, 2)
fabric that loses rank 2 at step 5 and grows back at step 8), each
started as a user starts it, ``torch.distributed.run --standalone
--nproc-per-node 4``, one card a rank over NCCL:

    python3 tools/example_ranks.py                 # four cards
    python3 tools/example_ranks.py --device cpu    # four gloo ranks

Needs four CUDA devices and ``nvcc`` (or ``--device cpu``); run on demand,
apart from ``chip_smoke.py``, whose ``examples`` phase runs the examples a
world of one can run.  Each rank zeroes the kernels' launch counts before
its script and reads them after (each rank's lines and counts go to
files of its own under ``artifacts/example_ranks/``); every rank must exit 0, print the
script's own check lines and (on the card) launch the kernels the script
runs.  Writes each script's wall time, every rank's printed lines and
launches, and the card's name and power limit to
``artifacts/example_ranks.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import runpy
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
#: (script, lines every rank prints, kernels every rank launches on the card)
SCRIPTS = (
    ("long_context_train", ("parity: ring(4) == dense reference at S=128",
                            "trained 1024-token sequences on a (1, 4) (data, ring) cart"),
     ("ring_step_fwd",)),
    ("elastic_train", ("finished step 10 on epoch 2 (world size 4): 1 eviction(s), "
                       "1 hot-join(s), 0 job restarts",), ("flash_attention_fwd",)),
)
LIMIT_S = 600
OUT = ROOT / "artifacts" / "example_ranks"


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank-script", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _rank_main(args) -> int:
    """One rank: the script under ``runpy`` with its counts zeroed before
    and read after; its printed lines to a file of its own."""

    import chip_smoke

    rank = int(os.environ["RANK"])
    mods = chip_smoke._kernel_modules()
    for m in mods:
        m.reset_launches()
    script = ROOT / "examples_torch" / f"{args.rank_script}.py"
    sys.argv = [str(script)] + (["--device", "cpu"] if args.device == "cpu" else [])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(script), run_name="__main__")
    (OUT / f"{args.rank_script}_rank{rank}.log").write_text(buf.getvalue())
    (OUT / f"{args.rank_script}_rank{rank}.json").write_text(
        json.dumps({"rank": rank, "launches": chip_smoke._launches()}))
    return 0


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    args = _args(argv)
    if "RANK" in os.environ:
        return _rank_main(args)
    import chip_smoke

    if args.device == "cuda":
        mods = chip_smoke._kernel_modules()
        from repro_torch.kernels import nvcc

        # once, before the ranks load the libraries
        nvcc.build_all(m.LIBRARY for m in mods)
    OUT.mkdir(parents=True, exist_ok=True)
    for stale in OUT.glob("*_rank*"):
        stale.unlink()
    result = {"card": _card() if args.device == "cuda" else "", "device": args.device,
              "world": WORLD, "scripts": {}}
    chip_smoke.log(result["card"])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for name, lines, kernels in SCRIPTS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={WORLD}", __file__, "--device", args.device,
             "--rank-script", name],
            capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=LIMIT_S)
        wall = time.perf_counter() - t0
        chip_smoke.check(proc.returncode == 0, f"{name}: exit {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-5000:]}")
        ranks = [json.loads((OUT / f"{name}_rank{r}.json").read_text()) for r in range(WORLD)]
        for r in ranks:
            r["lines"] = (OUT / f"{name}_rank{r['rank']}.log").read_text().splitlines()
            for want in lines:
                chip_smoke.check(any(want in s for s in r["lines"]),
                                 f"{name} rank {r['rank']}: no line with {want!r}")
            if args.device == "cuda":
                for k in kernels:
                    chip_smoke.check(r["launches"][k] > 0,
                                     f"{name} rank {r['rank']}: {k} never launched")
        result["scripts"][name] = {"wall_s": wall, "ranks": ranks}
        chip_smoke.log_row({"script": name, "wall_s": wall,
                            "launches": [r["launches"] for r in ranks]})
        for r in ranks:
            chip_smoke.log(f"rank {r['rank']}: " + " | ".join(r["lines"][-3:]))
    (ROOT / "artifacts" / "example_ranks.json").write_text(json.dumps(result, indent=1))
    chip_smoke.log(json.dumps({"ok": True, "card": result["card"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
