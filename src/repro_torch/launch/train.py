"""Training launcher: the port's Trainer (checkpoint/restart, straggler
guard, fault injection) with the data, FSDP, tensor, expert, ring and
pipeline plans.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \\
        --steps 4 --batch 2 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \\
        --smoke --device cpu --steps 4

Runs on the CUDA device unless ``--device cpu`` is given; a machine with no
CUDA device raises ``ERR_SESSION`` instead of falling back.  ``--smoke``
selects the reduced same-family config.  ``--mesh DxM`` folds the process
world onto a (data, model) grid; on more than one rank the state is placed
on it (``repro_torch.sharding.rules``: FSDP over data, heads, ``d_ff`` and
the vocabulary over model) and the batch split over data.  ``--plan``
takes the reference's specs: ``tensor``/``expert`` > 1 fold the world onto
(data, model), ``ring=N`` onto a (data, model) cart whose model dim is the
attention ring (the state placed as under ``tensor=N``: each eligible
layer's projections go to this rank's sequence block for the ring kernel,
and the head's logits stay split over the vocabulary), ``stage=S,micro=M``
onto a (data, stage) cart that streams M microbatches through S pipeline
stages.  ``--pipeline-stages`` (with
``--pipeline-microbatches``) and ``--ring-attention`` are the reference's
aliases for ``stage=``/``micro=`` and ``ring=``.  Several CPU ranks run
under ``torchrun`` (gloo), as the serve launcher's do::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch phi4_mini_3_8b --smoke --device cpu --steps 4 --batch 4 --plan data=2,tensor=2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch phi4_mini_3_8b --smoke --device cpu --steps 4 --batch 8 --plan stage=2,micro=2

The elastic drills: ``--evict-at STEP:RANK`` evicts a rank at a step (the
trainer revokes its epoch, shrinks to the survivors, restores the last
committed manifest and goes on, with no job restart), ``--admit-at
STEP[:COUNT]`` hot-joins spare ranks (the world's ranks outside the epoch)
at a step; every rank runs the same schedule::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch phi4_mini_3_8b --smoke --device cpu --steps 8 --batch 12 \
        --checkpoint-dir /tmp/ck --checkpoint-every 2 --evict-at 3:1 --admit-at 6

``--plan auto`` tunes the cell ``train_<seq>`` (``--batch`` rows) over the
communicator's ranks with :mod:`repro_torch.tune` (the H100's roofline),
logs the winner, its predicted step and its candidates, and trains under
it::

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4_mini_3_8b \
        --smoke --device cpu --steps 4 --plan auto
"""

from __future__ import annotations

import argparse
import json
import logging


def resolve_plan(args, cfg, devices):
    """One parser for every layout flag: ``--plan`` wins (``auto`` runs the
    :mod:`repro_torch.tune` roofline search for this cell: ``cfg`` at
    ``--seq`` x ``--batch`` on ``devices`` ranks, the winner registered in
    the default session of ``--device``); the deprecated
    ``--pipeline-stages``/``--ring-attention`` flags are aliases that build
    the equivalent spec and route through
    :func:`repro_torch.configs.base.parse_plan`.  Returns ``None`` (pure
    data plan) when nothing asked for a fold."""

    from repro_torch.configs import base

    if args.plan:
        if args.plan == "auto":
            from repro_torch import tune as tune_mod

            shape = base.ShapeConfig(f"train_{args.seq}", args.seq, args.batch, "train")
            result = tune_mod.tune(
                args.arch, shape, devices, config=cfg, space=base.plan_space(args.arch),
                device_type=args.device,
            )
            logging.getLogger("repro.launch").info(
                "autotuned plan: %s (predicted %.4fs over %d candidates)",
                result.plan.slug(), result.score.step_s, result.n_candidates,
            )
            return result.plan
        return base.parse_plan(args.plan, devices=devices)
    parts = []
    if args.pipeline_stages > 1:
        parts.append(f"stage={args.pipeline_stages}")
        parts.append(f"micro={args.pipeline_microbatches}")
    if args.ring_attention > 1:
        parts.append(f"ring={args.ring_attention}")
    if parts:
        return base.parse_plan(",".join(parts), devices=devices)
    return None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="auto", help="DxM, e.g. 2x1 (auto: all ranks x 1)")
    ap.add_argument("--pset", default="repro://world",
                    help="session process set the trainer owns (e.g. repro://host/0)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to train on (default: the CUDA device)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--async-checkpoint", action=argparse.BooleanOptionalAction, default=True,
                    help="checkpoint writes overlap the next steps "
                         "(--no-async-checkpoint joins each save)")
    ap.add_argument("--plan", default=None,
                    help="the parallelism plan: 'auto' (the repro_torch.tune roofline "
                         "search for this cell), or key=value pairs such as "
                         "'data=2,tensor=2', 'ring=2' or 'stage=2,micro=2'")
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="alias for --plan stage=N (with --pipeline-microbatches)")
    ap.add_argument("--pipeline-microbatches", type=int, default=2,
                    help="alias for --plan micro=N (with --pipeline-stages)")
    ap.add_argument("--ring-attention", type=int, default=0,
                    help="alias for --plan ring=N: a periodic cart ring on the model axis")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--evict-at", default=None, metavar="STEP:RANK",
                    help="elastic fault drill: evict RANK at STEP; the trainer shrinks its "
                         "epoch to the survivors, restores the last committed manifest and "
                         "continues — no job restart")
    ap.add_argument("--admit-at", default=None, metavar="STEP[:COUNT]",
                    help="elastic grow drill: hot-join COUNT spare ranks (default 1) at STEP, "
                         "re-folding the data axis")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="write metrics history JSON here")
    return ap


def run(argv=None):
    """Build the trainer from the flags and run it; returns (trainer,
    result)."""

    args = _parser().parse_args(argv)

    from repro_torch.configs import base
    from repro_torch.core import errors
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    try:
        cfg = base.get_smoke_config(args.arch) if args.smoke else base.get_config(args.arch)
        pcfg = base.get_parallel(args.arch)
    except ModuleNotFoundError as e:
        errors.fail(errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
                    f"arch {args.arch!r} is not ported yet ({e})")
    if args.mesh == "auto":
        comm = make_host_communicator(pset=args.pset, device=args.device)
    else:
        d, m = (int(t) for t in args.mesh.split("x"))
        comm = make_host_communicator(d, m, pset=args.pset, device=args.device)

    plan = resolve_plan(args, cfg, comm.group().size())
    tcfg = TrainerConfig(
        steps=args.steps,
        lr=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every or max(1, args.steps // 2),
        async_checkpoint=args.async_checkpoint,
        log_every=args.log_every,
        plan=plan,
    )
    injector = None
    if args.inject_failure_at is not None:
        injector = FaultInjector(fail_at_steps=(args.inject_failure_at,))
    if args.evict_at is not None:
        step, _, rank = args.evict_at.partition(":")
        injector = (injector or FaultInjector()).evict_rank(int(step), int(rank or 0))
    if args.admit_at is not None:
        step, _, count = args.admit_at.partition(":")
        injector = (injector or FaultInjector()).admit_rank(int(step), int(count or 1))
    trainer = Trainer(cfg, pcfg, tcfg, comm, seq_len=args.seq, global_batch=args.batch,
                      injector=injector)
    return trainer, trainer.run()


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    args = _parser().parse_args(argv)
    _, result = run(argv)
    print(json.dumps({k: v for k, v in result.items() if k != "metrics"}, indent=1))
    if result["metrics"]:
        first, last = result["metrics"][0], result["metrics"][-1]
        print(f"loss: {first['loss']:.4f} -> {last['loss']:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
