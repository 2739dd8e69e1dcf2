"""End-to-end training on the port: a ~100M-parameter dense LM on
the synthetic Markov stream with the full production stack (the data plan
over every rank, AdamW, checkpointing, straggler guard; the step a CUDA
graph on the card).

    PYTHONPATH=src python examples_torch/train_lm.py --steps 300

On the CPU the full 100M scale is slow; ``--small`` selects a ~14M variant
(``--device cpu``; several gloo ranks with ``python -m
torch.distributed.run --nproc-per-node N``).  ``main(params=...,
dtype=...)`` starts from a given parameter tree (the reference's,
converted) in place of the seeded draw, with the model in ``dtype``.
"""
# lint-args: --small --steps 60
# lint-ranks: 1

import argparse
import copy
import dataclasses
import json
import os
import tempfile

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def model_100m() -> ModelConfig:
    # ~103M params: 12L, d=768, 12H, d_ff=2048, 32k vocab (GPT-2-small-ish)
    return ModelConfig(
        name="demo_100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32_000, tie_embeddings=True,
    )


def model_small() -> ModelConfig:
    return ModelConfig(
        name="demo_14m", family="dense", num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=1024,
        vocab_size=8_000, tie_embeddings=True,
    )


def main(argv=None, *, params=None, dtype=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to train on (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = model_small() if args.small else model_100m()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    trainer = Trainer(
        cfg,
        ParallelConfig(remat="none"),
        TrainerConfig(
            steps=args.steps, lr=1e-3, warmup_steps=20,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=max(50, args.steps // 4), log_every=10,
        ),
        make_host_communicator(device=args.device),
        seq_len=args.seq,
        global_batch=args.batch,
    )
    if params is not None:
        trainer.init_state = lambda: trainer.place_state(copy.deepcopy(params))
    result = trainer.run()
    losses = [m["loss"] for m in result["metrics"]]
    out = {"final_step": result["final_step"], "losses": losses,
           "params_m": cfg.param_count() / 1e6}
    if not losses:
        # a previous run's checkpoint in --checkpoint-dir already reached
        # --steps; the restore resumes past the last step and trains nothing
        print(f"already complete at step {result['final_step']} "
              f"(stale {args.checkpoint_dir}; remove it to retrain)")
        return out
    print(f"steps: {result['final_step']}  loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss did not decrease"
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return out


if __name__ == "__main__":
    main()
