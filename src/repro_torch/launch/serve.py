"""Serving launcher: batched prefill + decode with the port's Server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b --smoke \\
        --requests 8 --prompt-len 64 --new-tokens 16 [--device cpu]

``--arch`` takes every config of the reference: the dense family
(gemma2_9b, phi4_mini_3_8b, granite_3_8b, qwen1_5_32b), the MoE family
(grok_1_314b; deepseek_v2_236b with MLA), mamba2_2_7b, zamba2_7b, the
prefix-LM VLM paligemma_3b and the encoder-decoder seamless_m4t_large_v2.
Each request draws its prompt, then its stub ``image_embeds`` (VLM) or
``frames`` (encoder-decoder), from one seeded generator, as the reference
launcher does, so both launchers serve the same requests.

Runs on the CUDA device unless ``--device cpu`` is given; a machine with no
CUDA device raises ``ERR_SESSION`` instead of falling back.  ``--mesh DxM``
folds the process world onto a (data, model) grid and, with M > 1,
shards the model over it (the parameters under
``repro_torch.sharding.rules``: FSDP over data, heads, ``d_ff`` and the
vocabulary over model; the cache's batch over data, its heads over
model), e.g. on the CPU::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch gemma2_9b --smoke --device cpu --mesh 2x2

As in the reference, the CLI has no ring flag: the ring is
``replace(pcfg, ring_attention=True)`` handed to ``Server``.
``--continuous-batching`` serves the requests through the paged-KV
:class:`~repro_torch.runtime.engine.Engine` instead of one fixed batch, on
``min(requests, 4)`` slots with a bucket of ``--prompt-len``; it prints each
request's generated length and the engine's stats.  With ``--mesh DxM``,
M > 1, it runs over the placed server: its slot table is the placed
prefill's cache, e.g. on the CPU::

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch phi4_mini_3_8b --smoke --device cpu --mesh 1x2 --continuous-batching

``--disaggregate`` splits the serving process set into prefill and decode
worker groups (``<pset>/prefill`` / ``<pset>/decode``, the leading
``--prefill-fraction`` of the set for prefill): prefill ranks compute the
KV cache and ``rput`` it into the decode ranks' RMA window (``--kv-pages``
pages per handoff); decode rides its persistent request.  ``--fanout P:D``
makes that split heterogeneous (2:6, 3:5, ...) with the KV routed along the
dist-graph fan-out adjacency; on the CPU, four gloo ranks::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch phi4_mini_3_8b --smoke --device cpu --fanout 1:3

``--plan`` takes the reference's grammar (``configs.base.parse_plan``):
``fanout=P:D`` selects the disaggregated split, any other plan folds its
data and model dims onto the host communicator.  ``--plan auto`` tunes the
cell ``prefill_<prompt-len>`` (``--requests`` rows) over the session's
ranks with :mod:`repro_torch.tune` (the H100's roofline), prints the winner
and its predicted step, and serves under it::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4_mini_3_8b \
        --smoke --device cpu --plan auto

The reference's usage errors are kept:
``--plan`` with ``--fanout`` or ``--mesh``, ``--mesh`` with
``--disaggregate``, ``--continuous-batching`` with ``--disaggregate``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument(
        "--pset",
        default="repro://world",
        help="session process set the server owns (e.g. repro://host/0)",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="device type to serve on (default: the CUDA device)",
    )
    ap.add_argument("--mesh", default="auto",
                    help="DxM: fold the process world onto a (data, model) grid")
    ap.add_argument(
        "--disaggregate",
        action="store_true",
        help="split the pset into prefill/decode groups; KV crosses via RMA",
    )
    ap.add_argument("--prefill-fraction", type=float, default=0.5)
    ap.add_argument("--kv-pages", type=int, default=4)
    ap.add_argument(
        "--plan",
        default=None,
        help="the unified parallelism plan: 'auto' (run the repro_torch.tune "
        "roofline autotuner for this cell), 'DxT' dims, or key=value pairs; "
        "'fanout=P:D' selects the heterogeneous disaggregated split",
    )
    ap.add_argument(
        "--fanout",
        default=None,
        metavar="P:D",
        help="alias for --plan fanout=P:D (same parser): heterogeneous "
        "prefill:decode worker split (e.g. 2:6, 3:5); implies "
        "--disaggregate and replaces --prefill-fraction",
    )
    ap.add_argument(
        "--continuous-batching",
        action="store_true",
        help="serve through the continuous-batching engine (paged KV block "
        "pool, in-flight admission) instead of one fixed batch",
    )
    return ap


def requests(cfg, n: int, prompt_len: int) -> list:
    """The launcher's ``n`` random requests: per request, its tokens, then
    its extras, drawn in turn from one generator seeded 0."""

    from repro_torch.runtime.server import Request

    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(n):
        toks = rng.integers(1, cfg.vocab_size, size=(prompt_len,), dtype=np.int32)
        extra = {}
        if cfg.family == "vlm":
            extra["image_embeds"] = rng.standard_normal(
                (cfg.num_image_tokens, 1152), dtype=np.float32
            )
        if cfg.family == "encdec":
            extra["frames"] = rng.standard_normal((prompt_len, cfg.d_model), dtype=np.float32)
        reqs.append(Request(tokens=toks, extra=extra))
    return reqs


def run(argv=None):
    """Serve one batch of random prompts; returns (server, tokens, stats).
    With ``--continuous-batching``, ``tokens`` is the list of each request's
    generated tokens, in submission order, and ``stats`` the engine's."""

    ap = _parser()
    args = ap.parse_args(argv)
    if args.plan and args.fanout:
        ap.error("--fanout is an alias for --plan fanout=P:D; pass one")
    if args.plan and args.mesh != "auto":
        ap.error("--plan subsumes --mesh (the plan's data/model dims are "
                 "the mesh); drop one of the two")
    if args.fanout is not None:
        args.disaggregate = True
    if args.disaggregate and args.mesh != "auto":
        ap.error("--mesh has no effect with --disaggregate (group layouts "
                 "come from --prefill-fraction/--fanout); drop one of the two")

    from repro_torch.configs import base
    from repro_torch.core import errors
    from repro_torch.core.session import default_session
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import DisaggregatedServer, Server, ServerConfig

    try:
        cfg = base.get_smoke_config(args.arch) if args.smoke else base.get_config(args.arch)
        pcfg = base.get_parallel(args.arch)
    except ModuleNotFoundError as e:
        errors.fail(
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            f"arch {args.arch!r} is not ported yet ({e})",
        )

    # one parser for every layout flag: --plan wins; --fanout routes through
    # the same grammar as "fanout=P:D"
    plan = None
    if args.plan == "auto":
        from repro_torch import tune as tune_mod

        shape = base.ShapeConfig(f"prefill_{args.prompt_len}", args.prompt_len, args.requests,
                                 "prefill")
        result = tune_mod.tune(args.arch, shape, config=cfg, space=base.plan_space(args.arch),
                               device_type=args.device)
        plan = result.plan
        print(f"autotuned plan: {plan.slug()} (predicted {result.score.step_s:.4f}s)")
    elif args.plan or args.fanout is not None:
        spec = args.plan or f"fanout={args.fanout}"
        devices = default_session(device_type=args.device).group().size()
        plan = base.parse_plan(spec, devices=devices)
    if plan is not None and plan.fanout is not None:
        args.disaggregate = True
    if args.continuous_batching and args.disaggregate:
        ap.error("--continuous-batching schedules a single-group Server; "
                 "it does not compose with --disaggregate/--fanout yet")

    comm = None
    if not args.disaggregate:
        if plan is not None:
            d, m = (plan.fold_dims() + (1,))[:2]
            comm = make_host_communicator(d, m, pset=args.pset, device=args.device)
        elif args.mesh == "auto":
            comm = make_host_communicator(pset=args.pset, device=args.device)
        else:
            d, m = (int(t) for t in args.mesh.split("x"))
            comm = make_host_communicator(d, m, pset=args.pset, device=args.device)
    reqs = requests(cfg, args.requests, args.prompt_len)
    scfg = ServerConfig(max_batch=min(args.requests, 4) if args.continuous_batching
                        else args.requests,
                        max_new_tokens=args.new_tokens, temperature=args.temperature)
    if args.disaggregate:
        server = DisaggregatedServer(
            cfg, pcfg, scfg,
            pset=args.pset,
            prefill_fraction=args.prefill_fraction,
            kv_pages=args.kv_pages,
            fanout=plan.fanout if plan is not None else None,
            device=args.device,
        )
    else:
        server = Server(cfg, pcfg, scfg, comm)
    if args.continuous_batching:
        from repro_torch.runtime.engine import Engine, EngineConfig

        eng = Engine(server, EngineConfig(prompt_bucket=args.prompt_len))
        handles = [eng.submit(r) for r in reqs]
        eng.run()
        return server, [h.generated for h in handles], eng.stats()
    tokens, stats = server.generate(reqs)
    return server, tokens, stats


def main(argv=None):
    _, tokens, stats = run(argv)
    if isinstance(tokens, list):
        print("generated lengths:", [len(t) for t in tokens])
    else:
        print("generated shape:", tokens.shape)
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()},
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
