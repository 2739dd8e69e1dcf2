"""Continuous-batching serving on the port's paged-KV engine: ragged
requests join the running decode iteration as slots free up, grow their KV
block by block out of a budgeted pool (preempting the newest row under
pressure), and retire at their own generation budget — then every output is
checked token-for-token against the fixed-batch Server oracle.

    PYTHONPATH=src python examples_torch/continuous_batching_serve.py [--device cpu]

The server's communicator folds every rank onto a (data, 1) grid; every
rank runs the same schedule and prints the same lines.  The lint runs it on
one rank: the reference's engine raises on a grid whose data axis splits
its slot table (ROADMAP C19), so its script runs on one device or on more
devices than slots, and the tests hold the two on one.  ``main(params=...)``
serves a given parameter tree (the reference's, converted) in place of the
seeded draw.
"""
# lint-ranks: 1

import argparse

import numpy as np

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.runtime.engine import Engine, EngineConfig
from repro_torch.runtime.server import Request, Server, ServerConfig


def main(argv=None, *, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="live KV block budget (small values force preemption)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to serve on (default: the CUDA device)")
    args = ap.parse_args(argv)

    # float32 keeps the oracle comparison exact: near-tied argmaxes under
    # bf16 rounding can flip between batch shapes
    cfg = ModelConfig(
        name="demo", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, dtype="float32",
    )
    scfg = ServerConfig(max_batch=4, max_new_tokens=8, temperature=0.0)
    server = Server(cfg, ParallelConfig(), scfg, make_host_communicator(device=args.device))
    if params is not None:
        server.params = params

    bucket = 8
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(1, cfg.vocab_size,
                     (int(rng.integers(2, bucket + 1)),), dtype=np.int32)
        for _ in range(args.requests)
    ]
    budgets = [int(rng.integers(2, scfg.max_new_tokens + 1)) for _ in prompts]

    eng = Engine(server, EngineConfig(
        prompt_bucket=bucket, block_tokens=4, pool_blocks=args.pool_blocks))
    handles = [eng.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    eng.run()
    stats = eng.stats()
    print(f"{stats['finished']} requests in {stats['steps']} decode steps "
          f"({stats['generated_tokens']} tokens, "
          f"{stats['preemptions']} preemptions)")
    for h in handles:
        print(f"  request {h.rid}: prompt {len(h.tokens):>2} tokens -> "
              f"{h.generated}")

    # parity: the fixed-batch Server on bucket-left-padded prompts generates
    # the same tokens — continuous batching changed the schedule, not the math
    for start in range(0, len(prompts), scfg.max_batch):
        group = prompts[start:start + scfg.max_batch]
        reqs = [Request(tokens=np.concatenate(
            [np.zeros((bucket - len(p),), np.int32), p])) for p in group]
        tokens, _ = server.generate(reqs)
        for j in range(len(group)):
            h = handles[start + j]
            expect = np.asarray(tokens[j])[: len(h.generated)]
            assert np.array_equal(np.asarray(h.generated), expect), (
                f"request {h.rid} diverged from the fixed-batch oracle"
            )
    print("parity: every request matches the fixed-batch oracle token-for-token")
    return {"stats": {k: stats[k] for k in ("finished", "steps", "generated_tokens",
                                            "preemptions")},
            "generated": [[int(t) for t in h.generated] for h in handles],
            "prompt_lens": [len(h.tokens) for h in handles], "parity": True}


if __name__ == "__main__":
    main()
