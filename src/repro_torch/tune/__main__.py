"""CLI: ``python -m repro_torch.tune --arch gemma2_9b --shape train_4k
[--device cpu]``, the reference's (``python -m repro.tune``) over the
H100's hardware model.

Prints the candidate table and the winning :class:`ParallelPlan` (both
human-readable and as a ``--plan``-compatible spec string), registers the
winner's ``repro://cart/<dims>`` process set, and optionally dumps the full
result as JSON for downstream tooling (``--json``).  The winner is
registered in the default session of ``--device`` (the card unless the
caller asks for the CPU; a machine with no card raises ``ERR_SESSION``).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch import tune as tune_mod
from repro_torch.configs.base import ARCHITECTURES, SHAPES


def _plan_spec(plan) -> str:
    """A ``--plan`` key=value spec reproducing this plan exactly."""

    parts = [f"data={plan.data}"]
    for key, v in (
        ("stage", plan.stage), ("ring", plan.ring),
        ("expert", plan.expert), ("tensor", plan.tensor),
    ):
        if v > 1:
            parts.append(f"{key}={v}")
    if plan.microbatches > 1:
        parts.append(f"micro={plan.microbatches}")
    if plan.grad_buckets > 1:
        parts.append(f"buckets={plan.grad_buckets}")
    if plan.remat is not None:
        parts.append(f"remat={plan.remat}")
    if plan.dcn_axis is not None:
        parts.append(f"dcn={plan.dcn_axis}")
    if plan.fanout is not None:
        parts.append(f"fanout={plan.fanout[0]}:{plan.fanout[1]}")
    return ",".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--arch", required=True, choices=ARCHITECTURES)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--devices", type=int, default=None,
                    help="device count to plan for (default: session world)")
    ap.add_argument("--slices", type=int, default=None,
                    help="pod-slice count (default: session repro://slice/*)")
    ap.add_argument("--mode", default="exhaustive",
                    choices=("exhaustive", "coordinate"))
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--no-register", action="store_true",
                    help="skip registering the winner's cart pset")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="ignore recorded dryrun artifacts")
    ap.add_argument("--json", action="store_true",
                    help="emit the full TuneResult as JSON on stdout")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type of the session the winner is registered in "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)

    result = tune_mod.tune(
        args.arch,
        args.shape,
        args.devices,
        slices=args.slices,
        mode=args.mode,
        calibrate=not args.no_calibrate,
        register=not args.no_register,
        top=args.top,
        device_type=args.device,
    )
    if args.json:
        print(json.dumps(result.as_dict(), indent=1))
        return 0

    plan, sc = result.plan, result.score
    print(f"tuned {args.arch} x {args.shape} over {result.n_candidates} "
          f"legal plans ({result.mode}, {result.n_scored} scored)")
    print(f"  winner : {plan.slug()}  ->  --plan {_plan_spec(plan)}")
    print(f"  pset   : {plan.cart_pset}"
          + ("" if not args.no_register else "  (not registered)"))
    print(f"  step_s : {sc.step_s:.4f}  (compute {sc.compute_s:.4f}, "
          f"memory {sc.memory_s:.4f}, bubble {sc.bubble_s:.4f}, "
          f"wire {sc.wire_s:.4f}, launch {sc.launch_s:.6f})")
    print(f"  memory : {sc.peak_bytes / 2**30:.2f} GiB "
          f"{'fits' if sc.fits else 'OVER BUDGET'}")
    print("  top candidates:")
    for slug, step_s in result.table:
        marker = "*" if slug == plan.slug() else " "
        print(f"   {marker} {step_s:10.4f}s  {slug}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
