"""Sessions in anger on the port: trainer and server on disjoint process
sets.

The MPI 4.0 pitch made concrete — one platform, two workloads, neither ever
touches ``world()``.  A session enumerates the ranks, the first half is
registered as ``repro://train`` and the second as ``repro://serve``; the
Trainer and the Server each build their communicator from *their* group
with ``Communicator.from_group``, so training steps and decode steps run on
disjoint ranks.  Each rank is a process: a rank of the train set trains, a
rank of the serve set serves (on a world of one, the one rank does both,
in turn), and each prints its own part.

    PYTHONPATH=src python examples_torch/session_train_serve.py
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        examples_torch/session_train_serve.py --device cpu

``main(params=..., dtype=...)`` trains and serves from a given parameter
tree (the reference's, converted) in place of the seeded draws, with the
model in ``dtype``.
"""
# lint-ranks: 4

import argparse
import copy
import dataclasses

import numpy as np

from repro_torch import core as mpx
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.runtime.server import Request, Server, ServerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def tiny_cfg() -> ModelConfig:
    return ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
    )


def main(argv=None, *, params=None, dtype=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to run on (default: the CUDA device)")
    args = ap.parse_args(argv)

    sess = mpx.Session.init(device_type=args.device)
    world = sess.group("repro://world")
    n = world.size()
    print(f"session: {sess} — psets: {sess.psets()}")

    half = max(1, n // 2)
    sess.register_pset("repro://train", world.incl(range(half)))
    sess.register_pset("repro://serve", world.difference(world.incl(range(half))) or world)

    train_comm = mpx.Communicator.from_group(
        sess.group("repro://train"),
        tag="repro://train",
        shape=(half, 1),
        axis_names=("data", "model"),
    )
    serve_group = sess.group("repro://serve")
    serve_comm = mpx.Communicator.from_group(
        serve_group,
        tag="repro://serve",
        shape=(serve_group.size(), 1),
        axis_names=("data", "model"),
    )
    overlap = train_comm.group().intersection(serve_comm.group())
    print(f"train: {train_comm}\nserve: {serve_comm}\n"
          f"overlapping devices: {overlap.size()} (expect 0 with >1 device)")
    out = {"world": n, "overlap": overlap.size(), "train_size": train_comm.size(),
           "serve_size": serve_comm.size()}

    cfg, pcfg = tiny_cfg(), ParallelConfig()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if train_comm.rank() != mpx.UNDEFINED:
        trainer = Trainer(
            cfg, pcfg, TrainerConfig(steps=10, lr=1e-3, log_every=5),
            train_comm, seq_len=64, global_batch=4,
        )
        if params is not None:
            trainer.init_state = lambda: trainer.place_state(copy.deepcopy(params))
        result = trainer.run()
        print(f"trained to step {result['final_step']}: "
              f"loss {result['metrics'][-1]['loss']:.4f}")
        out["final_step"] = result["final_step"]
        out["losses"] = [m["loss"] for m in result["metrics"]]
        del trainer

    if serve_comm.rank() != mpx.UNDEFINED:
        server = Server(cfg, pcfg, ServerConfig(max_batch=4, max_new_tokens=8), serve_comm)
        if params is not None:
            server.params = params
        rng = np.random.default_rng(0)
        reqs = [
            Request(tokens=rng.integers(1, cfg.vocab_size, size=(16,), dtype=np.int32))
            for _ in range(4)
        ]
        tokens, stats = server.generate(reqs)
        print(f"served {tokens.shape} tokens at {stats['tokens_per_s']:.1f} tok/s "
              f"on {serve_comm.size()} devices")
        out["tokens"] = np.asarray(tokens)
        out["shape"] = tuple(tokens.shape)
    return out


if __name__ == "__main__":
    main()
