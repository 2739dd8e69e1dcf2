"""Elastic training demo on the port: the job survives a rank eviction
without a restart.

A trainer on a ``(W/2, 2)`` fabric of W ranks — ``(4, 2)`` on 8, as in the
reference — loses rank 2 at step 5.  ULFM-style, the epoch is revoked, the
survivor group is ``Group.difference``-shrunk, the fabric rebuilds over the
survivors (``(3, 2)`` on 6 of 8 ranks), the last committed manifest restores
onto them, and the loop continues — same processes, new communicator
generation.  At step 8 a spare rank hot-joins and the data axis grows back.
Every rank runs every transition; an evicted or spare rank walks the steps
without computing.  It needs at least four ranks::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \\
        examples_torch/elastic_train.py --device cpu

and on four cards ``--nproc-per-node 4`` (a ``(2, 2)`` fabric).
``main(params=..., dtype=...)`` trains from a given parameter tree (the
reference's, converted; also each restore's template) in place of the
seeded draw, with the model in ``dtype``.
"""
# lint-ranks: 8

import argparse
import copy
import dataclasses
import tempfile

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import errors
from repro_torch.core.communicator import Communicator
from repro_torch.core.session import Session
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None, *, params=None, dtype=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to train on (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="tiny", family="dense", num_layers=1, d_model=32, num_heads=2,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64,
    )
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    world = Session.init(device_type=args.device).group("repro://world")
    n = world.size()
    errors.check(n >= 4 and n % 2 == 0, errors.ErrorClass.ERR_DIMS,
                 f"the elastic demo needs an even world of at least 4 ranks, got {n}")
    comm = Communicator.from_group(
        world, tag="repro://train", shape=(n // 2, 2), axis_names=("data", "model"))
    injector = FaultInjector().evict_rank(5, 2).admit_rank(8)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg,
            ParallelConfig(),
            TrainerConfig(steps=10, lr=1e-3, checkpoint_dir=_shared(ckpt_dir),
                          checkpoint_every=2, log_every=2, seed=7),
            comm,
            seq_len=32,
            global_batch=12,
            injector=injector,
        )
        if params is not None:
            trainer.init_state = lambda: trainer.place_state(copy.deepcopy(params))
        result = trainer.run()
        del trainer
    print(
        f"finished step {result['final_step']} on epoch "
        f"{result['epoch']} (world size {result['world_size']}): "
        f"{result['evictions']} eviction(s), {result['joins']} hot-join(s), "
        f"0 job restarts"
    )
    assert result["final_step"] == 10
    assert result["evictions"] == 1 and result["joins"] == 1
    assert result["restarts"] == 0
    assert result["epoch"] == 2 and result["world_size"] == n
    return {key: result[key] for key in ("final_step", "epoch", "world_size", "evictions",
                                         "joins", "restarts")} | {
        "losses": [m["loss"] for m in result["metrics"]],
        "steps": [m["step"] for m in result["metrics"]]}


def _shared(path: str) -> str:
    """Rank 0's ``path`` on every rank: the ranks of one host share its file
    system, and a checkpoint's writers must name the same directory."""

    import torch.distributed as dist

    box = [path]
    dist.broadcast_object_list(box, src=0)
    return box[0]


if __name__ == "__main__":
    main()
