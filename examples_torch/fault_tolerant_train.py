"""Fault-tolerance demo on the port: training survives an injected worker
failure by restoring the newest complete checkpoint and replaying
(deterministic data — no loader state needed).

    PYTHONPATH=src python examples_torch/fault_tolerant_train.py [--device cpu]

On several ranks (``python -m torch.distributed.run --nproc-per-node N``)
every rank fails, restores and replays at the same steps.
``main(params=..., dtype=...)`` starts from a given parameter tree (the
reference's, converted; also each restore's template) in place of the
seeded draw, with the model in ``dtype``.
"""
# lint-ranks: 2

import argparse
import copy
import dataclasses
import tempfile

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None, *, params=None, dtype=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to train on (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="demo", family="dense", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=4_096,
        tie_embeddings=True,
    )
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    comm = make_host_communicator(device=args.device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg,
            ParallelConfig(remat="none"),
            TrainerConfig(steps=40, lr=1e-3, checkpoint_dir=_shared(ckpt_dir),
                          checkpoint_every=10, log_every=10),
            comm,
            seq_len=128,
            global_batch=4,
            injector=FaultInjector(fail_at_steps=(17, 28)),  # two failures
        )
        if params is not None:
            trainer.init_state = lambda: trainer.place_state(copy.deepcopy(params))
        result = trainer.run()
        print(f"finished step {result['final_step']} after "
              f"{result['restarts']} recoveries (injected failures at 17, 28)")
        assert result["final_step"] == 40
        assert result["restarts"] == 2
    return {"final_step": result["final_step"], "restarts": result["restarts"],
            "losses": [m["loss"] for m in result["metrics"]],
            "steps": [m["step"] for m in result["metrics"]]}


def _shared(path: str) -> str:
    """Rank 0's ``path`` on every rank: the ranks of one host share its file
    system, and a checkpoint's writers must name the same directory."""

    import torch.distributed as dist

    if dist.get_world_size() == 1:
        return path
    box = [path]
    dist.broadcast_object_list(box, src=0)
    return box[0]


if __name__ == "__main__":
    main()
