#!/usr/bin/env python3
"""Disaggregated serving across cards: ``DisaggregatedServer`` on four
ranks, one card each over NCCL, where ``chip_smoke.py`` runs it on one.

    python3 tools/disaggregate_ranks.py            # starts 4 ranks (torchrun)
    python3 tools/disaggregate_ranks.py --device cpu --smoke --prompt-len 16
                                                   # the same on 4 gloo ranks

Needs four CUDA devices and ``nvcc`` (or ``--device cpu``); run on demand,
apart from ``chip_smoke.py``.  Every rank serves the full phi4-mini (or its
smoke config) from the launcher's seed and prompts (2 requests, 16 new
tokens, 4 pages of KV) through a single-group ``Server`` over all four ranks
(the baseline), then through ``DisaggregatedServer`` paired 2:2 and fan-out
1:3, two ``generate``s each: every rank's tokens must equal the baseline's
bit for bit, ``kv_bytes`` the cache's own.  Rank 0 logs each handoff's
``transfer_s`` and ``kv_bytes / transfer_s`` beside its bytes bound (the
cache read and written once at the card's HBM rate: a lower bound, not the
link's), the phases' times and the card's name and power limit, and writes
them to ``artifacts/disaggregate_ranks.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
SPLITS = (("paired_2_2", {"prefill_fraction": 0.5}), ("fanout_1_3", {"fanout": (1, 3)}))


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--kv-pages", type=int, default=4)
    return ap.parse_args(argv)


def _rank_main(args) -> int:
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs import base
    from repro_torch.core.communicator import world
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import DisaggregatedServer, Server, ServerConfig

    comm = world(device_type=args.device)
    rank = comm.rank()
    chip_smoke.check(comm.size() == WORLD, f"{comm.size()} ranks, want {WORLD}")
    arch = "phi4_mini_3_8b"
    cfg = base.get_smoke_config(arch) if args.smoke else base.get_config(arch)
    pcfg = base.get_parallel(arch)
    scfg = ServerConfig(max_batch=2, max_new_tokens=args.new_tokens)
    reqs = serve.requests(cfg, 2, args.prompt_len)
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    out = {"card": card, "arch": cfg.name, "layers": cfg.num_layers,
           "prompt_len": args.prompt_len, "kv_pages": args.kv_pages, "world": WORLD}

    baseline = Server(cfg, pcfg, scfg, make_host_communicator(device=args.device))
    want, stats = baseline.generate(reqs)
    out["baseline"] = {k: stats[k] for k in ("prefill_s", "decode_s", "tokens_per_s")}
    del baseline
    if args.device == "cuda":
        torch.cuda.empty_cache()
    for name, split in SPLITS:
        t0 = time.perf_counter()
        dis = DisaggregatedServer(cfg, pcfg, scfg, kv_pages=args.kv_pages,
                                  device=args.device, **split)
        init_s = time.perf_counter() - t0
        runs = []
        for i in range(2):
            tokens, stats = dis.generate(reqs)
            chip_smoke.check(np.array_equal(tokens, want),
                             f"{name} rank {rank} generate {i + 1}: tokens differ from the "
                             f"single-group Server's")
            runs.append(stats)
        kv = runs[0]["kv_bytes"]
        out[name] = {
            "init_s": init_s,
            "roles": {"prefill": dis.prefill is not None, "decode": dis.decode is not None},
            "runs": runs, "kv_bytes": kv,
            "transfer_gb_per_s": [kv / r["transfer_s"] / 1e9 for r in runs],
            "transfer_bound_ms": (2 * kv / chip_smoke.HBM_BYTES_PER_S * 1e3
                                  if args.device == "cuda" else None),
            "tokens_equal_baseline": True,
        }
        del dis
        if args.device == "cuda":
            torch.cuda.empty_cache()
    chip_smoke.log(f"rank {rank}: " + json.dumps(out))
    if rank == 0:
        path = ROOT / "artifacts" / "disaggregate_ranks.json"
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    if "RANK" in os.environ:
        return _rank_main(args)
    if args.device == "cuda":
        import chip_smoke

        mods = chip_smoke._kernel_modules()  # first: nvcc's users import it through the core
        from repro_torch.kernels import nvcc

        # once, before the ranks load the libraries
        nvcc.build_all(m.LIBRARY for m in mods)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={WORLD}", __file__, *(argv if argv is not None else sys.argv[1:])]
    return subprocess.run(cmd, env=env, cwd=str(ROOT), timeout=1800).returncode


if __name__ == "__main__":
    raise SystemExit(main())
