#!/usr/bin/env python3
"""Placed (DTensor) serving and training across cards: the sharding rules
on four ranks, one card each over NCCL, where ``chip_smoke.py`` runs them
on a mesh of one.

    python3 tools/shard_ranks.py            # starts 4 ranks (torchrun)
    python3 tools/shard_ranks.py --device cpu --smoke --prompt-len 16 --seq 32
                                            # the same on 4 gloo ranks
    python3 tools/shard_ranks.py --elastic  # the elastic drill and the
                                            # plans' eager trainer only
    python3 tools/shard_ranks.py --elastic --ring-engine
                                            # and the placed ring prefill
                                            # and the engine at TP 4
    python3 tools/shard_ranks.py --capture  # exchanges and the ring and
                                            # pipeline steps in CUDA graphs

Needs four CUDA devices and ``nvcc`` (or ``--device cpu``); run on demand,
apart from ``chip_smoke.py``.  Every rank, in turn:

* serves qwen1.5-32b at TP 4 (mesh 1 x 4; 2 x 4096 prompts, 16 new
  tokens), whose weights and cache one card does not hold beside each
  other: the tokens must be the same on every rank; logs ``prefill_s``,
  ``tokens_per_s`` and the card's peak;
* serves phi4-mini at TP 4, with and without ``seq_shard_cache`` +
  ``flash_decode_merge``: the first decode step's logits within 2e-2 of a
  ``Server`` on a 4 x 1 mesh, whose four ranks each hold the whole model
  (a model axis of one rank keeps plain tensors); the tokens,
  ``tokens_per_s`` and peaks of both logged;
* trains phi4-mini 4 steps (b 4 x 2048) under the data plan, under fsdp
  (mesh 4 x 1) and under (data 2, tensor 2): the placed runs' losses within
  1e-3 relative of the data plan's, each card's peak logged; then the data
  plan and (data 2, tensor 2) again with int8 moments (w_gate/w_up's rows
  split over model: the whole-row update), held for 2 steps;
* restores the fsdp run's checkpoint (fragments from four ranks) on rank 0
  alone, into whole tensors, equal to the run's final parameters;
* trains phi4-mini under the plans that re-form the fabric, where the
  exchanges run on cards: the ring plan (ring 4, b 2 x ``--ring-seq``,
  its state placed as the tensor plan's: each card holds a quarter of the
  heads, ``d_ff`` and vocabulary, runs every layer's other work on the
  whole sequence and a quarter of it in every attention layer, the KV
  rotating over NVLink; the head's logits stay split over the
  vocabulary) and the pipeline plan (stage 4, micro 4, b ``--batch`` x
  ``--seq``: 8 layers a card, microbatches of one row), ``--steps`` steps
  each, eagerly through the eager trainer's step function; then through
  ``Trainer(persistent=False)``, whose steps must take the step
  function's losses bit for bit (the default ``Trainer`` must build its
  captured step too: ``--capture`` runs it).  The pipeline's losses are
  held within ``LOSS_RTOL`` of the data plan's above (the same batch); the
  ring's first loss within ``RING_LOSS_RTOL`` of the data plan's forward
  on the same weights and batch (forward only: the data plan's backward
  recomputes each layer's attention through (b, 24, 8192, 8192) fp32
  scores).  Each card's peak and the step times are logged.

With ``--elastic`` (instead of the serving and data-plan runs above), the
elastic drill comes first: phi4-mini at full width and 2 layers, b 12 x
2048 (the global batch divides by 3 and 4), fp32 moments, the data plan
placed over 4 x 1, saves every 2 steps, 8 steps, PyTorch's deterministic
algorithms.  Rank 1 is evicted before step 4: the 3 survivors fold onto
(3, 1) and restore step 2; before step 7 one rank is admitted (the evicted
one, which idled meanwhile) and the grid is (4, 1) again, the live state
broadcast to it.  It must show one step build and one capture per epoch
(3), the revoked generations' process groups (NCCL communicators
included) destroyed on every card, and steps 3 to 6 bit for bit those of
a fresh 3-rank trainer restored from the drill's step-2 manifest on the
survivors, steps 7 and 8 those of a fresh 4-rank trainer restored from its
step-6 manifest (the state the grow carried over live), both eager
(``persistent=False``: no graph pool beside the drill's cached blocks);
each card's peak, the memory still allocated after the drill's trainer is
gone, and the step times are logged.  Then
the two plans above.

With ``--ring-engine`` (after the ``--elastic`` parts when both are
given): the ring prefill on placed weights, phi4-mini at TP 4 with
``ring_attention`` on ``--ring-requests`` x ``--ring-seq`` prompts, its
first decode logits within ``LOGITS_TOL`` of the ring of one on a 4 x 1
mesh (whole weights on every card) and the tokens compared; then
``serve --continuous-batching`` over qwen1.5-32b at TP 4 (8 requests of
``--engine-prompt-len`` tokens on 4 slots): every request its
``--new-tokens``, the same on every card, useful tokens/s, each card's
peak and the slot table's bytes on a card against the whole table's.

With ``--tune`` (instead of everything above): three parts, each a
``torchrun`` of its own that runs whatever the others did.  ``tune_rings``:
the median latency of an 8-byte NCCL ``all_reduce`` (``TUNE_LATENCY_REPS``
timed calls a rank, each ended by a synchronise; the hardware model's
``COLLECTIVE_LAUNCH_S``), and the decomposed rings of ``core/overlap.py``
over NVLink against NCCL on the same bytes, at phi4-mini's ``w_up`` split
four ways by rows (768 x 8192): ``ring_all_gather`` and its bidirectional
form against ``all_gather_into_tensor`` on the bf16 shard, bit for bit,
``ring_reduce_scatter`` against ``reduce_scatter_tensor`` on a whole fp32
(3072 x 8192) gradient, within fp32 rounding of four terms; each timed
beside NCCL's (medians of ``TUNE_RING_REPS``).  ``tune_train``: ``train
--plan auto`` for phi4-mini at b ``--batch`` x ``--seq`` on the four cards
(``launch.train.resolve_plan``), the winner trained ``--steps`` steps by
the default ``Trainer``, its predicted step and peak beside the warm step
and each card's peak.  ``tune_serve``: ``serve
--plan auto`` for qwen1.5-32b at 2 x ``--prompt-len`` (``launch.serve.run``):
the winner, its predicted peak, the tokens (the same on every card),
``prefill_s`` and each card's peak.  A part that fails is recorded (its
exit code in ``artifacts/shard_ranks_tune.json``) and the next runs.

With ``--capture`` (instead of everything above): each part a
``torchrun`` of its own, each a rank's threads' stacks printed before its
limit should it hang.  Probes, each eagerly first, then captured in a
CUDA graph and replayed three times, every replay bit for bit the eager
result: ``capture_shift`` (a cart shift, one ``batch_isend_irecv``),
``capture_alltoall`` (the shift as an ``all_to_all_single``),
``capture_chain`` (``CHAIN_SHIFTS`` shifts of buffers made inside the
step), ``capture_backward`` (a differentiable shift and its backward),
``capture_ring_schedules`` (``core/overlap.py``'s rings); two more that
reproduce the failures on request (``--capture-parts``):
``capture_shift_cold`` (captured with no eager shift first: NCCL
connects the pair inside the capture, which CUDA refuses) and
``capture_chain_registered`` (``NCCL_GRAPH_REGISTER=1``: the first replay
deadlocks).  Then ``capture_ring`` and ``capture_pipeline``: the ring and
pipeline plans above trained ``--steps`` steps by ``Trainer(persistent=
False)`` and by the default ``Trainer``, whose step is captured at its
second start: losses, gradient norms and final parameters bit for bit,
the warm step times of both.  The exit codes go to
``artifacts/shard_ranks_capture.json``.

Rank 0 writes everything, with the card's name and power limit, to
``artifacts/shard_ranks.json`` (a part to ``shard_ranks_<part>.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
LOGITS_TOL = 2e-2
LOSS_RTOL = 1e-3
# the ring's kernel and the data plan's flash round bf16 activations in
# another order (the repo's bf16 tolerance)
RING_LOSS_RTOL = 2e-2
# the longest a trainer's run under the ring or pipeline plan may take (its
# init and its eager steps)
TRAINER_RUN_LIMIT_S = 300
# the longest one torchrun (a part, or the whole run) may take
PART_LIMIT_S = 900
# the ring plan's global batch: b 2 x --ring-seq, the shape whose whole
# state and logits ran a card out of memory before the state was placed
RING_BATCH = 2
# the placed ring prefill: phi4-mini, --ring-requests x --ring-seq prompts
# the engine over qwen1.5-32b at TP 4: requests, slots, prompt bucket, budget
ENGINE_ARCH = "qwen1_5_32b"
ENGINE_REQUESTS, ENGINE_SLOTS = 8, 4
# --tune: timed calls of the 8-byte all_reduce, and of each ring and NCCL
# collective; phi4-mini's w_up (d_model x d_ff), split by rows over the cards
TUNE_LATENCY_REPS, TUNE_RING_REPS = 200, 20
TUNE_W_UP = (3072, 8192)


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--ring-seq", type=int, default=8192)
    ap.add_argument("--skip-serve", action="store_true",
                    help="train only (the serving runs take about half the time)")
    ap.add_argument("--elastic", action="store_true",
                    help="the elastic drill, then the ring and pipeline plans' trainers "
                         "(no serving, no data-plan runs)")
    ap.add_argument("--ring-engine", action="store_true",
                    help="the ring prefill on placed weights and the engine over qwen1.5-32b "
                         "at TP 4 (after the --elastic parts, with it)")
    ap.add_argument("--ring-requests", type=int, default=4)
    ap.add_argument("--engine-prompt-len", type=int, default=2048)
    ap.add_argument("--tune", action="store_true",
                    help="the all_reduce latency and the ring schedules against NCCL, then "
                         "train and serve --plan auto across the cards (nothing else)")
    ap.add_argument("--capture", action="store_true",
                    help="exchanges captured in CUDA graphs, then the ring and pipeline "
                         "plans' captured steps against their eager steps (nothing else)")
    ap.add_argument("--capture-parts", default=",".join(CAPTURE_DEFAULT),
                    help="--capture: the parts to run, in order")
    ap.add_argument("--part", choices=ELASTIC_PARTS + PLACED_PARTS + TUNE_PARTS + CAPTURE_PARTS,
                    default=None,
                    help="one part of --elastic or --ring-engine (each runs in processes of "
                         "its own)")
    return ap.parse_args(argv)


def _peak(device) -> float | None:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None


def _allocated(device) -> float | None:
    import torch

    return torch.cuda.memory_allocated() / 1e9 if device == "cuda" else None


def _reset(device) -> None:
    import gc

    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _same_everywhere(x) -> bool:
    """``x`` (a tensor) is the same on every rank."""

    import torch
    import torch.distributed as dist

    mine = x.detach().float().reshape(-1)
    top, low = mine.clone(), mine.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX)
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    return bool(torch.equal(top, low))


def _serve_qwen(args, out) -> None:
    import torch

    import chip_smoke
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Server, ServerConfig

    arch = "qwen1_5_32b"
    cfg = base.get_smoke_config(arch) if args.smoke else base.get_config(arch)
    _reset(args.device)
    t0 = time.perf_counter()
    server = Server(cfg, base.get_parallel(arch),
                    ServerConfig(max_batch=2, max_new_tokens=args.new_tokens),
                    make_host_communicator(1, WORLD, device=args.device))
    init_s = time.perf_counter() - t0
    init_peak = _peak(args.device)
    _reset(args.device)
    chip_smoke.check(server.placed, "qwen: the weights are not placed")
    reqs = serve.requests(cfg, 2, args.prompt_len)
    runs = []
    for _ in range(2):
        tokens, stats = server.generate(reqs)
        chip_smoke.check(_same_everywhere(torch.as_tensor(tokens, device=server.device)),
                         "qwen: the ranks' tokens differ")
        runs.append({k: stats[k] for k in ("prefill_s", "decode_s", "tokens_per_s")})
    out["qwen_tp4"] = {"layers": cfg.num_layers, "prompt_len": args.prompt_len,
                       "init_s": init_s, "runs": runs, "tokens": tokens.tolist(),
                       "init_peak_gb": init_peak, "serve_peak_gb": _peak(args.device),
                       "tokens_equal_on_every_rank": True}
    del server


def _first_decode(server, reqs):
    """The prefill's cache and the first decode step's whole logits."""

    import torch

    batch, _ = server._pad_batch(reqs)
    with torch.inference_mode():
        logits, cache = server._prefill_request(batch)(server.params, batch)
        tok = server._sample(logits, None)[:, None]
        dec, _ = server._decode_request(cache, tok)(server.params, cache, tok)
        dec = dec.full_tensor() if hasattr(dec, "full_tensor") else dec
        server._decode_reqs.clear()
        return dec.float()


def _serve_phi4(args, out) -> None:
    import numpy as np

    import chip_smoke
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Server, ServerConfig

    arch = "phi4_mini_3_8b"
    cfg = base.get_smoke_config(arch) if args.smoke else base.get_config(arch)
    pcfg = base.get_parallel(arch)
    scfg = ServerConfig(max_batch=2, max_new_tokens=args.new_tokens)
    reqs = serve.requests(cfg, 2, args.prompt_len)
    comm = make_host_communicator(1, WORLD, device=args.device)
    _reset(args.device)
    whole = Server(cfg, pcfg, scfg, make_host_communicator(WORLD, 1, device=args.device))
    chip_smoke.check(not whole.placed, "phi4: the 4 x 1 server's weights are placed")
    want = _first_decode(whole, reqs)
    base_tokens, base_stats = whole.generate(reqs)
    row = {"replicated": {"tokens": base_tokens.tolist(), "tokens_per_s":
                          base_stats["tokens_per_s"], "prefill_s": base_stats["prefill_s"],
                          "peak_gb": _peak(args.device)}}
    del whole
    for name, pc in (("tp4", pcfg), ("tp4_merged_decode", dataclasses.replace(
            pcfg, seq_shard_cache=True, flash_decode_merge=True))):
        _reset(args.device)
        server = Server(cfg, pc, scfg, comm)
        chip_smoke.check(server.placed, f"phi4 {name}: the weights are not placed")
        got = _first_decode(server, reqs)
        err = float((got - want).abs().max())
        chip_smoke.check(err <= LOGITS_TOL * (1 + float(want.abs().max())),
                         f"phi4 {name}: first decode logits {err} from the replicated Server's")
        tokens, stats = server.generate(reqs)
        row[name] = {"max_abs_err_first_decode": err, "tokens": tokens.tolist(),
                     "tokens_equal_replicated": bool(np.array_equal(tokens, base_tokens)),
                     "prefill_s": stats["prefill_s"], "tokens_per_s": stats["tokens_per_s"],
                     "peak_gb": _peak(args.device)}
        del server
    out["phi4_serve"] = row


def _train_cfg(args):
    """phi4-mini's config and parallel config; the smoke model at a layer a
    pipeline stage."""

    from repro_torch.configs import base

    arch = "phi4_mini_3_8b"
    cfg = base.get_config(arch)
    if args.smoke:
        cfg = dataclasses.replace(base.get_smoke_config(arch), num_layers=WORLD)
    return cfg, base.get_parallel(arch)


def _train(args, out) -> None:
    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import base
    from repro_torch.configs.base import ParallelPlan
    from repro_torch.core.futures import flatten, unflatten
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, pcfg = _train_cfg(args)
    ckpt = ROOT / "build" / "shard_ranks_ckpt"
    rows, finals = {}, {}
    tensor2 = ParallelPlan(data=2, tensor=2)
    for name, plan, place, moments in (("data_plan", None, False, "float32"),
                                       ("fsdp_4x1", None, True, "float32"),
                                       ("fsdp_2x2_tensor2", tensor2, True, "float32"),
                                       ("data_plan_int8", None, False, "int8"),
                                       ("fsdp_2x2_tensor2_int8", tensor2, True, "int8")):
        _reset(args.device)
        ck = str(ckpt) if name == "fsdp_4x1" else None
        if ck:
            if out["rank"] == 0:
                shutil.rmtree(ck, ignore_errors=True)
            dist.barrier()   # no rank opens the directory before it is gone
        tcfg = TrainerConfig(steps=args.steps, lr=3e-4, log_every=1, plan=plan,
                             checkpoint_dir=ck, checkpoint_every=args.steps)
        trainer = Trainer(cfg, dataclasses.replace(pcfg, moment_dtype=moments), tcfg,
                          make_host_communicator(device=args.device),
                          seq_len=args.seq, global_batch=args.batch,
                          straggler=StragglerPolicy(deadline_factor=float("inf")))
        trainer.placed = place   # the data plan's baseline keeps the state whole
        t0 = time.perf_counter()
        result = trainer.run()
        rows[name] = {"mesh": list(trainer.comm.shape), "placed": trainer.placed,
                      "moments": moments,
                      "losses": [m["loss"] for m in result["metrics"]],
                      "grad_norms": [m["grad_norm"] for m in result["metrics"]],
                      "step_s": [m["duration_s"] for m in result["metrics"]],
                      "run_s": time.perf_counter() - t0, "peak_gb": _peak(args.device)}
        if name == "fsdp_4x1":
            leaves, treedef = flatten(trainer.params)
            finals = unflatten(treedef, [t.full_tensor().detach().cpu() for t in leaves])
        del trainer, result
    # int8 moments are held for the steps before a stored moment is read
    # back twice (tests/port/test_torch_trainer.py's _int8_trajectory_held)
    for name, base_run, held in (("fsdp_4x1", "data_plan", args.steps),
                                 ("fsdp_2x2_tensor2", "data_plan", args.steps),
                                 ("fsdp_2x2_tensor2_int8", "data_plan_int8", 2)):
        want = rows[base_run]["losses"][:held]
        for got, ref in zip(rows[name]["losses"][:held], want):
            chip_smoke.check(abs(got - ref) <= LOSS_RTOL * abs(ref),
                             f"{name}: losses {rows[name]['losses']} against the data "
                             f"plan's {want}")
    if out["rank"] == 0:
        leaves, treedef = flatten(finals)
        template = {"params": unflatten(treedef, [torch.zeros_like(t) for t in leaves])}
        restored, step = CheckpointManager(str(ckpt)).restore(template)
        same = all(torch.equal(a, b) for a, b in zip(flatten(restored["params"])[0], leaves))
        chip_smoke.check(step == args.steps and same,
                         "the four ranks' checkpoint restored on one rank differs")
        rows["checkpoint_4_ranks_restored_on_1"] = True
        shutil.rmtree(ckpt, ignore_errors=True)
    out["train"] = rows
    _train_plans(args, out, rows)


#: the elastic drill: layers, global batch, steps, saves every, the
#: eviction (step, rank) and the admission step
ELASTIC_LAYERS, ELASTIC_BATCH, ELASTIC_STEPS, ELASTIC_SAVE_EVERY = 2, 12, 8, 2
ELASTIC_EVICT, ELASTIC_ADMIT = (3, 1), 6
ELASTIC_DIR = ROOT / "build" / "shard_ranks_elastic"
#: the parts of ``--elastic``, each in processes of its own
ELASTIC_PARTS = ("drill", "controls", "plans")
#: the parts of ``--ring-engine``
PLACED_PARTS = ("ring_prefill", "engine")
# the --tune parts
TUNE_PARTS = ("tune_rings", "tune_train", "tune_serve")
#: --capture: three exchanges each captured in a CUDA graph (one torchrun
#: each), then the ring and pipeline plans' captured steps against eager
CAPTURE_PROBES = ("capture_shift", "capture_alltoall", "capture_chain", "capture_backward",
                  "capture_ring_schedules", "capture_shift_cold", "capture_chain_registered")
CAPTURE_PLANS = ("capture_ring", "capture_pipeline")
CAPTURE_PARTS = CAPTURE_PROBES + CAPTURE_PLANS
# the parts ``--capture`` runs unless ``--capture-parts`` names others: all
# but the two that reproduce the failures (a capture refused, a replay that
# deadlocks until the part's limit)
CAPTURE_DEFAULT = tuple(p for p in CAPTURE_PARTS
                        if p not in ("capture_shift_cold", "capture_chain_registered"))
# the longest a probe's torchrun may take, and a plan's
CAPTURE_PROBE_LIMIT_S, CAPTURE_PLAN_LIMIT_S = 60, 240
# a chain probe's shifts, each of a fresh buffer of this many fp32
CHAIN_SHIFTS, CHAIN_ELEMS = 16, 1 << 22


def _control(args, cfg, pcfg, ckpt, step, comm, steps) -> list | None:
    """A fresh ``Trainer`` on ``comm`` restored from the manifest of
    ``step`` in ``ckpt`` and run to ``steps``: its (step, loss, grad norm)
    records, or ``None`` on a rank outside ``comm``."""

    from repro_torch.runtime.faults import StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    if comm.rank() < 0:
        return None
    # eager steps (bit for bit the graph's): no graph pool beside the drill's
    # cached blocks
    tcfg = TrainerConfig(steps=steps, lr=3e-4, log_every=1, checkpoint_dir=str(ckpt),
                         persistent=False)
    t = Trainer(cfg, pcfg, tcfg, comm, seq_len=args.seq, global_batch=ELASTIC_BATCH,
                straggler=StragglerPolicy(deadline_factor=float("inf")))
    tree, _ = t.ckpt.restore(dict(zip(("params", "opt"), t.init_state())), step=step)
    params, opt_state = t._trainable(tree["params"]), tree["opt"]
    del tree
    t.compile(params, opt_state)
    t._run_span(params, opt_state, step, steps)
    return [(m["step"], m["loss"], m["grad_norm"]) for m in t.metrics_history]


def _elastic_config(args):
    from repro_torch.configs import base

    arch = "phi4_mini_3_8b"
    cfg = base.get_smoke_config(arch) if args.smoke else base.get_config(arch)
    return dataclasses.replace(cfg, num_layers=ELASTIC_LAYERS), base.get_parallel(arch)


def _elastic_drill(args, out) -> None:
    """The elastic drill (the module's docstring): rank 1 evicted, the
    survivors' fold restored, a rank admitted back.  Each rank leaves its
    records beside the drill's manifests for :func:`_elastic_controls`."""

    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.core import tool
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import FaultInjector, StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, pcfg = _elastic_config(args)
    if out["rank"] == 0:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    dist.barrier()   # no rank opens the directory before it is gone
    torch.use_deterministic_algorithms(True, warn_only=True)
    _reset(args.device)
    tcfg = TrainerConfig(steps=ELASTIC_STEPS, lr=3e-4, log_every=1,
                         checkpoint_dir=str(ELASTIC_DIR / "drill"),
                         checkpoint_every=ELASTIC_SAVE_EVERY, keep_checkpoints=ELASTIC_STEPS)
    injector = FaultInjector().evict_rank(*ELASTIC_EVICT).admit_rank(ELASTIC_ADMIT)
    t = Trainer(cfg, pcfg, tcfg, make_host_communicator(device=args.device),
                seq_len=args.seq, global_batch=ELASTIC_BATCH, injector=injector,
                straggler=StragglerPolicy(deadline_factor=float("inf")))
    built = []
    build = t._build_step

    def counted(params, opt_state):
        built.append(build(params, opt_state))
        return built[-1]

    t._build_step = counted
    builds = tool.pvar_read()["trace:train_step"]
    t0 = time.perf_counter()
    result = t.run()
    run_s = time.perf_counter() - t0
    destroyed = [pg for e in t.retired for pg in e.destroyed]
    row = {"config": f"{cfg.name} {ELASTIC_LAYERS} layers", "seq": args.seq,
           "batch": ELASTIC_BATCH, "steps": ELASTIC_STEPS, "evict": list(ELASTIC_EVICT),
           "admit": ELASTIC_ADMIT, "epoch": result["epoch"],
           "world_size": result["world_size"], "evictions": result["evictions"],
           "joins": result["joins"],
           "records": [(m["step"], m["loss"], m["grad_norm"]) for m in result["metrics"]],
           "step_s": [m["duration_s"] for m in result["metrics"]], "run_s": run_s,
           "builds": tool.pvar_read()["trace:train_step"] - builds,
           "captures": [r.captured for r in built],
           "retired": [e.generation for e in t.retired],
           "destroyed_groups": [len(e.destroyed) for e in t.retired],
           "destroyed_gone": all(pg not in dist.distributed_c10d._world.pg_map
                                 for pg in destroyed),
           "manifests": {s: t.ckpt.manifest_meta(s) for s in t.ckpt.steps()},
           "peak_gb": _peak(args.device)}
    torch.use_deterministic_algorithms(False)
    # the trainer (in a cycle with ``counted``) and its last graph go before
    # the process group does: a live graph holds NCCL kernels of the groups
    # that destroy_process_group shuts down
    del t, built, build, counted
    _reset(args.device)
    (ELASTIC_DIR / f"drill_rank{out['rank']}.json").write_text(json.dumps(row))
    out["elastic_drill"] = row
    chip_smoke.log(f"rank {out['rank']} elastic drill: " + json.dumps(row))
    member_throughout = out["rank"] != ELASTIC_EVICT[1]
    chip_smoke.check(result["epoch"] == 2 and result["world_size"] == WORLD
                     and result["evictions"] == 1 and result["joins"] == 1,
                     f"elastic drill: {row}")
    chip_smoke.check(row["builds"] == (3 if member_throughout else 2)
                     and row["captures"] == [int(args.device == "cuda")] * row["builds"],
                     f"elastic drill: builds {row['builds']}, captures {row['captures']}")
    chip_smoke.check(row["retired"] == [0, 1] and row["destroyed_gone"],
                     f"elastic drill: retired {row['retired']}, groups {row['destroyed_groups']}")
    chip_smoke.check(row["manifests"][2] == {"epoch": 0, "world_size": WORLD}
                     and row["manifests"][4] == {"epoch": 1, "world_size": WORLD - 1}
                     and row["manifests"][ELASTIC_STEPS] == {"epoch": 2, "world_size": WORLD},
                     f"elastic drill: manifests {row['manifests']}")


def _elastic_controls(args, out) -> None:
    """Fresh trainers from the drill's step-2 manifest on the survivors'
    fold and from its step-6 manifest on all four ranks, in a process of
    their own: their steps must be the drill's, bit for bit."""

    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.session import default_session
    from repro_torch.launch.mesh import make_host_communicator

    cfg, pcfg = _elastic_config(args)
    drill = json.loads((ELASTIC_DIR / f"drill_rank{out['rank']}.json").read_text())["records"]
    world = default_session(device_type=args.device).group("repro://world")
    survivors = world.excl([ELASTIC_EVICT[1]])
    torch.use_deterministic_algorithms(True, warn_only=True)
    _reset(args.device)
    shrunk = _control(args, cfg, pcfg, ELASTIC_DIR / "drill", 2,
                      Communicator.from_group(survivors, tag="repro://world",
                                              shape=(survivors.size(), 1),
                                              axis_names=("data", "model")), ELASTIC_ADMIT)
    _reset(args.device)
    grown = _control(args, cfg, pcfg, ELASTIC_DIR / "drill", ELASTIC_ADMIT,
                     make_host_communicator(device=args.device), ELASTIC_STEPS)
    torch.use_deterministic_algorithms(False)
    last = {s: (loss, norm) for s, loss, norm in drill}
    row = {"control_grow_records": grown, "peak_gb": _peak(args.device),
           "grow_equals_restored_control": all(last[s] == (loss, norm)
                                               for s, loss, norm in grown)}
    if shrunk is not None:
        row["shrink_equals_restored_control"] = all(
            last[s] == (loss, norm) for s, loss, norm in shrunk)
        row["control_shrink_records"] = shrunk
    out["elastic_controls"] = row
    chip_smoke.log(f"rank {out['rank']} elastic controls: " + json.dumps(row))
    chip_smoke.check(row.get("shrink_equals_restored_control", True)
                     and (shrunk is not None) is (out["rank"] != ELASTIC_EVICT[1]),
                     f"elastic drill: steps 3-6 {drill} against {shrunk}")
    chip_smoke.check(row["grow_equals_restored_control"],
                     f"elastic drill: steps 7-8 {drill} against {grown}")
    dist.barrier()
    if out["rank"] == 0:
        shutil.rmtree(ELASTIC_DIR / "drill", ignore_errors=True)


def _dump(out) -> None:
    """Rank 0 writes ``out`` to ``artifacts/shard_ranks.json`` (an
    ``--elastic`` part to ``shard_ranks_elastic_<part>.json``), also as it
    goes, so that a run cut short leaves what it measured."""

    if out["rank"] == 0:
        part = out.get("part")
        name = ("shard_ranks" if not part else f"shard_ranks_elastic_{part}"
                if part in ELASTIC_PARTS else f"shard_ranks_{part}")
        path = ROOT / "artifacts" / f"{name}.json"
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(out, indent=1))


def _eager_steps(trainer, step, args) -> dict:
    """``args.steps`` eager calls of ``step`` from ``trainer``'s init and
    batches: losses, grad norms, step times and the card's peak."""

    import torch

    params, opt_state = trainer.init_state()
    losses, norms, times = [], [], []
    for i in range(args.steps):
        batch = trainer._batch(i)
        if args.device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "grad_norms": norms, "step_s": times,
            "peak_gb": _peak(args.device)}


def _train_plans(args, out, rows) -> None:
    import torch

    import chip_smoke
    from repro_torch.configs import base
    from repro_torch.configs.base import ParallelPlan
    from repro_torch.core import errors
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, pcfg = _train_cfg(args)
    plans = {}
    for name, plan, seq, batch, moments in (
            ("ring4", ParallelPlan(ring=WORLD), args.ring_seq, RING_BATCH, "float32"),
            ("stage4_micro4", ParallelPlan(stage=WORLD, microbatches=WORLD), args.seq,
             args.batch, "float32")):

        def trainer(plan=plan, seq=seq, batch=batch, moments=moments, persistent=True):
            tcfg = TrainerConfig(steps=args.steps, lr=3e-4, log_every=1, plan=plan,
                                 persistent=persistent)
            return Trainer(cfg, dataclasses.replace(pcfg, moment_dtype=moments), tcfg,
                           make_host_communicator(device=args.device), seq_len=seq,
                           global_batch=batch,
                           straggler=StragglerPolicy(deadline_factor=float("inf")))

        _reset(args.device)
        # the step function the eager trainer runs (its state placed, the
        # ring's too), called here step by step
        t = trainer(persistent=False)
        step = t._build_step(None, None)
        row = {"plan": plan.slug(), "cart": list(t.comm.shape),
               "periods": list(t.comm.periods), "seq": seq, "batch": batch,
               "moments": moments, "placed": t.placed,
               "eager": _eager_steps(t, step, args)}
        plans[name] = row
        _dump(out | {"train_plans": plans})
        del t, step
        _reset(args.device)
        t = trainer()
        try:
            t.compile(None, None)   # the default, captured step: built on the card too
        except errors.Error as e:
            row["captured_step_error"] = str(e)
        del t
        _reset(args.device)
        t = trainer(persistent=False)
        # should an eager step's exchanges hang, this rank would block in
        # the device's synchronise, where no Python handler runs: SIGALRM's
        # default action ends the process, and torchrun the others
        signal.alarm(TRAINER_RUN_LIMIT_S)
        try:
            result = t.run()
        finally:
            signal.alarm(0)
        row.update(losses=[m["loss"] for m in result["metrics"]],
                   grad_norms=[m["grad_norm"] for m in result["metrics"]],
                   step_s=[m["duration_s"] for m in result["metrics"]],
                   step_request=t._request is not None, peak_gb=_peak(args.device))
        row["trainer_equals_eager"] = (row["losses"] == row["eager"]["losses"] and
                                       row["grad_norms"] == row["eager"]["grad_norms"])
        del t
        _dump(out | {"train_plans": plans})
    # the ring's baseline: the data plan's loss on the same weights and
    # first batch, forward only
    _reset(args.device)
    t = Trainer(cfg, pcfg, TrainerConfig(steps=1), make_host_communicator(device=args.device),
                seq_len=args.ring_seq, global_batch=plans["ring4"]["batch"])
    t.placed = False
    # the seed's weights alone: no optimizer state beside the forward's
    # fp32 logits
    gen = torch.Generator(device=t.device).manual_seed(t.tcfg.seed)
    with torch.no_grad():
        params = t.bundle.init(gen)
        loss, _ = t.bundle.loss(params, t._batch(0), t.pcfg, None)
    ring = plans["ring4"]
    ring["data_plan_first_loss_forward"] = float(loss)
    del t, params, loss
    chip_smoke.check(ring["placed"] and plans["stage4_micro4"]["placed"],
                     "the plans' state is not placed")
    out["train_plans"] = plans
    first = ring["eager"]["losses"][0]
    chip_smoke.check(abs(first - ring["data_plan_first_loss_forward"])
                     <= RING_LOSS_RTOL * abs(first),
                     f"ring4: first loss {first} against the data plan's "
                     f"{ring['data_plan_first_loss_forward']}")
    pipe = plans["stage4_micro4"]
    for got, ref in zip(pipe["eager"]["losses"], rows.get("data_plan", {}).get("losses", [])):
        chip_smoke.check(abs(got - ref) <= LOSS_RTOL * abs(ref),
                         f"stage4_micro4: losses {pipe['eager']['losses']} against the data "
                         f"plan's {rows['data_plan']['losses']}")
    for name, row in plans.items():
        chip_smoke.check(all(x == x for x in row["eager"]["losses"]), f"{name}: {row}")
        chip_smoke.check("captured_step_error" not in row,
                         f"{name}: the captured step's build on {args.device}: {row}")
        chip_smoke.check(not row["step_request"] and row["trainer_equals_eager"],
                         f"{name}: the eager trainer's steps {row['losses']} differ from the "
                         f"step function's {row['eager']['losses']}")


def _ring_prefill(args, out) -> None:
    """The ring prefill on placed weights: phi4-mini at TP 4 (mesh 1 x 4,
    ``ring_attention``; each layer's projections go to this card's quarter
    of the sequence for the ring kernel, the KV rotating over NVLink),
    ``--ring-requests`` x ``--ring-seq`` prompts, against the same requests
    on a 4 x 1 mesh, whose cards each hold the whole model and run the ring
    of one on their rows: the first decode step's logits within
    ``LOGITS_TOL``, the tokens compared; ``prefill_s``, ``tokens_per_s``
    and each card's peak logged."""

    import numpy as np

    import chip_smoke
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Server, ServerConfig

    arch = "phi4_mini_3_8b"
    cfg = base.get_smoke_config(arch) if args.smoke else base.get_config(arch)
    pcfg = dataclasses.replace(base.get_parallel(arch), ring_attention=True)
    scfg = ServerConfig(max_batch=args.ring_requests, max_new_tokens=args.new_tokens)
    reqs = serve.requests(cfg, args.ring_requests, args.ring_seq)
    row = {"requests": args.ring_requests, "prompt_len": args.ring_seq}
    firsts = {}
    for name, dims in (("ring_of_one_4x1", (WORLD, 1)), ("placed_ring_1x4", (1, WORLD))):
        _reset(args.device)
        server = Server(cfg, pcfg, scfg, make_host_communicator(*dims, device=args.device))
        chip_smoke.check(server.placed is (dims[1] > 1), f"ring prefill {name}: placed")
        firsts[name] = _first_decode(server, reqs)
        runs = []
        for _ in range(2):
            tokens, stats = server.generate(reqs)
            runs.append({k: stats[k] for k in ("prefill_s", "decode_s", "tokens_per_s")})
        row[name] = {"tokens": tokens.tolist(), "runs": runs, "peak_gb": _peak(args.device)}
        del server
    want, got = firsts["ring_of_one_4x1"], firsts["placed_ring_1x4"]
    err = float((got - want).abs().max())
    a, b = (np.array(row[k]["tokens"]) for k in ("ring_of_one_4x1", "placed_ring_1x4"))
    row.update(max_abs_err_first_decode=err, tokens_equal=bool(np.array_equal(a, b)),
               tokens_equal_count=int((a == b).sum()), tokens_count=int(a.size))
    out["ring_prefill"] = row
    chip_smoke.log(f"rank {out['rank']} ring prefill: " + json.dumps(row))
    chip_smoke.check(err <= LOGITS_TOL * (1 + float(want.abs().max())),
                     f"ring prefill: first decode logits {err} from the ring of one's")


def _engine(args, out) -> None:
    """``serve --continuous-batching`` over qwen1.5-32b at TP 4 (mesh 1 x
    4): ``ENGINE_REQUESTS`` requests of ``--engine-prompt-len`` tokens on
    ``ENGINE_SLOTS`` slots, ``--new-tokens`` each; useful tokens/s, each
    card's peak at the server's init and while serving, and the slot
    table's bytes on a card against the whole table's (what one card would
    hold beside the whole weights)."""

    import torch

    import chip_smoke
    from repro_torch.core.futures import flatten
    from repro_torch.launch import serve

    _reset(args.device)
    argv = ["--arch", ENGINE_ARCH, "--device", args.device, "--mesh", f"1x{WORLD}",
            "--continuous-batching", "--requests", str(ENGINE_REQUESTS),
            "--prompt-len", str(args.engine_prompt_len), "--new-tokens", str(args.new_tokens)]
    if args.smoke:
        argv.append("--smoke")
    engines, init_peak = [], []
    from repro_torch.runtime import engine as engine_mod

    base_init = engine_mod.Engine.__init__

    def kept(self, *a, **k):   # the CLI's engine, for its slot table
        # the server's init (the whole model drawn on each card, then
        # placed) peaks apart from the serving
        init_peak.append(_peak(args.device))
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        base_init(self, *a, **k)
        engines.append(self)

    engine_mod.Engine.__init__ = kept
    try:
        t0 = time.perf_counter()
        server, tokens, stats = serve.run(argv)
        wall = time.perf_counter() - t0
    finally:
        engine_mod.Engine.__init__ = base_init
    leaves = [t for t in flatten(engines[0].cache)[0] if t.dim() > 1]
    local = sum(t.to_local().numel() * t.element_size() for t in leaves)
    whole = sum(t.numel() * t.element_size() for t in leaves)
    weights = sum(t.numel() * t.element_size() for t in flatten(server.params)[0])
    local_weights = sum(t.to_local().numel() * t.element_size()
                        for t in flatten(server.params)[0])
    lengths = [len(t) for t in tokens]
    row = {"arch": ENGINE_ARCH, "requests": ENGINE_REQUESTS, "slots": ENGINE_SLOTS,
           "prompt_len": args.engine_prompt_len, "new_tokens": args.new_tokens,
           "lengths": lengths, "stats": stats, "wall_s": wall,
           "useful_tokens_per_s": sum(lengths) / wall,
           "slot_table_bytes_card": local, "slot_table_bytes_whole": whole,
           "weights_bytes_card": local_weights, "weights_bytes_whole": weights,
           "placed": server.placed, "init_peak_gb": init_peak[0],
           "serve_peak_gb": _peak(args.device)}
    if args.device == "cuda":
        row["card_bytes"] = torch.cuda.get_device_properties(0).total_memory
    out["engine"] = row
    chip_smoke.log(f"rank {out['rank']} engine: " + json.dumps(row))
    chip_smoke.check(server.placed and lengths == [args.new_tokens] * ENGINE_REQUESTS,
                     f"engine: {row}")
    chip_smoke.check(_same_everywhere(torch.as_tensor(tokens, device=server.device)),
                     "engine: the ranks' tokens differ")
    del server, engines, leaves


def _timed(fn, reps, device) -> tuple:
    """(result, median seconds): ``reps`` calls of ``fn`` on every rank,
    each started together (a barrier) and ended by a synchronise."""

    import statistics

    import torch
    import torch.distributed as dist

    times = []
    for _ in range(reps):
        dist.barrier()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return result, statistics.median(times)


def _tune_rings(args, out) -> None:
    """The 8-byte ``all_reduce``'s latency and the ring schedules against
    NCCL's collectives (see the module's docstring)."""

    import statistics

    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.core import overlap
    from repro_torch.core.communicator import world

    comm = world(device_type=args.device)
    rank = comm.rank()
    word = torch.zeros(2, dtype=torch.float32, device=comm.device)
    lat = []
    for i in range(20 + TUNE_LATENCY_REPS):
        if args.device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(word)
        if args.device == "cuda":
            torch.cuda.synchronize()
        if i >= 20:   # after 20 warm calls
            lat.append(time.perf_counter() - t0)
    medians = [None] * WORLD
    dist.all_gather_object(medians, statistics.median(lat))
    rows, cols = TUNE_W_UP
    gen = torch.Generator(device=comm.device).manual_seed(1000 + rank)
    shard = torch.randn((rows // WORLD, cols), generator=gen, device=comm.device,
                        dtype=torch.bfloat16)
    grad = torch.randn((rows, cols), generator=gen, device=comm.device)
    gathered = torch.empty((rows, cols), dtype=torch.bfloat16, device=comm.device)
    scattered = torch.empty((rows // WORLD, cols), device=comm.device)
    nccl_ag, nccl_ag_s = _timed(lambda: (dist.all_gather_into_tensor(gathered, shard),
                                         gathered)[1], TUNE_RING_REPS, args.device)
    ring_ag, ring_ag_s = _timed(lambda: overlap.ring_all_gather(comm, shard),
                                TUNE_RING_REPS, args.device)
    bidir, bidir_s = _timed(lambda: overlap.ring_all_gather_bidirectional(comm, shard),
                            TUNE_RING_REPS, args.device)
    nccl_rs, nccl_rs_s = _timed(lambda: (dist.reduce_scatter_tensor(scattered, grad),
                                         scattered)[1], TUNE_RING_REPS, args.device)
    ring_rs, ring_rs_s = _timed(lambda: overlap.ring_reduce_scatter(comm, grad),
                                TUNE_RING_REPS, args.device)
    # four fp32 terms summed in another order: apart by at most 3 roundings
    # of partial sums no larger than the sum of the terms' magnitudes
    mags = grad.abs()
    dist.all_reduce(mags)
    bound = 3 * 2.0 ** -23 * mags.narrow(0, rank * (rows // WORLD), rows // WORLD)
    rs_err = float((ring_rs - nccl_rs).abs().max())
    gb = rows * cols * 2 / 1e9
    row = {
        "all_reduce_8_bytes_median_s_by_rank": medians,
        "collective_launch_s": statistics.median(medians),
        "w_up": list(TUNE_W_UP), "shard": [rows // WORLD, cols],
        "all_gather_bf16": {"nccl_s": nccl_ag_s, "ring_s": ring_ag_s,
                            "ring_bidirectional_s": bidir_s, "gathered_gb": gb,
                            "ring_equal": bool(torch.equal(ring_ag, nccl_ag)),
                            "bidirectional_equal": bool(torch.equal(bidir, nccl_ag))},
        "reduce_scatter_fp32": {"nccl_s": nccl_rs_s, "ring_s": ring_rs_s,
                                "input_gb": 2 * gb, "max_abs_diff": rs_err,
                                "within_rounding": bool(((ring_rs - nccl_rs).abs()
                                                         <= bound).all())}}
    out["tune_rings"] = row
    chip_smoke.log(f"rank {rank} tune rings: " + json.dumps(row))
    ag, rs = row["all_gather_bf16"], row["reduce_scatter_fp32"]
    chip_smoke.check(ag["ring_equal"] and ag["bidirectional_equal"],
                     f"tune rings: the ring gathers differ from NCCL's: {row}")
    chip_smoke.check(rs["within_rounding"], f"tune rings: the ring reduce-scatter is {rs_err} "
                                            f"from NCCL's, past fp32 rounding")


def _tune_train(args, out) -> None:
    """``train --plan auto`` for phi4-mini across the cards."""

    import chip_smoke
    from repro_torch import tune
    from repro_torch.configs import base
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, pcfg = _train_cfg(args)
    targs = train._parser().parse_args(["--arch", "phi4_mini_3_8b", "--plan", "auto",
                                        "--batch", str(args.batch), "--seq", str(args.seq),
                                        "--device", args.device])
    plan = train.resolve_plan(targs, cfg, WORLD)
    shape = base.ShapeConfig(f"train_{args.seq}", args.seq, args.batch, "train")
    predicted = tune.tune("phi4_mini_3_8b", shape, WORLD, config=cfg, register=False,
                          space=base.plan_space("phi4_mini_3_8b"), device_type=args.device)
    chip_smoke.check(predicted.plan == plan, f"tune train: {predicted.plan} against {plan}")
    _reset(args.device)
    t = Trainer(cfg, pcfg, TrainerConfig(steps=args.steps, lr=3e-4, log_every=1, plan=plan),
                make_host_communicator(device=args.device), seq_len=args.seq,
                global_batch=args.batch,
                straggler=StragglerPolicy(deadline_factor=float("inf")))
    signal.alarm(TRAINER_RUN_LIMIT_S)
    try:
        result = t.run()
    finally:
        signal.alarm(0)
    metrics = result["metrics"]
    warm = sorted(m["duration_s"] for m in metrics[1:])[(len(metrics) - 1) // 2]
    row = {"plan": plan.slug(), "candidates": predicted.n_candidates,
           "predicted": predicted.score.as_dict(),
           "cart": list(t.comm.shape), "placed": t.placed, "batch": args.batch,
           "seq": args.seq, "losses": [m["loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics],
           "step_s": [m["duration_s"] for m in metrics], "warm_step_s": warm,
           "peak_gb": _peak(args.device),
           "measured_over_predicted_step": warm / predicted.score.step_s}
    if args.device == "cuda":
        row["measured_over_predicted_peak"] = row["peak_gb"] * 1e9 / predicted.score.peak_bytes
    out["tune_train"] = row
    chip_smoke.log(f"rank {out['rank']} tune train: " + json.dumps(row))
    chip_smoke.check(all(x == x for x in row["losses"]), f"tune train: {row}")
    del t


def _tune_serve(args, out) -> None:
    """``serve --plan auto`` for qwen1.5-32b across the cards."""

    import contextlib
    import io

    import torch

    import chip_smoke
    from repro_torch import tune
    from repro_torch.configs import base
    from repro_torch.launch import serve

    arch = "qwen1_5_32b"
    argv = ["--arch", arch, "--device", args.device, "--plan", "auto", "--requests", "2",
            "--prompt-len", str(args.prompt_len), "--new-tokens", str(args.new_tokens)]
    cfg = base.get_smoke_config(arch) if args.smoke else base.get_config(arch)
    if args.smoke:
        argv.append("--smoke")
    predicted = tune.tune(arch, base.ShapeConfig(f"prefill_{args.prompt_len}", args.prompt_len,
                                                 2, "prefill"),
                          WORLD, config=cfg, register=False, space=base.plan_space(arch),
                          device_type=args.device)
    out["tune_serve"] = row = {"arch": arch, "plan": predicted.plan.slug(),
                               "candidates": predicted.n_candidates,
                               "predicted": predicted.score.as_dict(),
                               "prompt_len": args.prompt_len}
    _dump(out)   # the prediction stands should the serve fail
    _reset(args.device)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        server, tokens, stats = serve.run(argv)
    row.update(printed=printed.getvalue().strip(), grid=list(server.comm.shape),
               placed=server.placed, tokens=tokens.tolist(),
               prefill_s=stats["prefill_s"], tokens_per_s=stats["tokens_per_s"],
               peak_gb=_peak(args.device),
               tokens_equal_on_every_rank=_same_everywhere(
                   torch.as_tensor(tokens, device=server.device)))
    chip_smoke.log(f"rank {out['rank']} tune serve: " + json.dumps(row))
    chip_smoke.check(row["tokens_equal_on_every_rank"], "tune serve: the ranks' tokens differ")
    del server


def _capture_probe(args, out) -> None:
    """One exchange, a shift by one along a ring of the four ranks (each
    sends 4 MiB of fp32 to the next), eagerly and then captured in a CUDA
    graph and replayed three times on new values, each replay checked
    against the values the rank before sent, bit for bit.
    ``capture_shift``: the cart's ``shift_exchange`` (one
    ``batch_isend_irecv`` on the ring's process group), the eager call
    first; ``capture_shift_cold``: the same captured with no eager call
    before it; ``capture_alltoall``: the same shift as an
    ``all_to_all_single`` with one non-empty chunk a rank.  A capture or
    replay that hangs ends the torchrun at ``CAPTURE_PROBE_LIMIT_S``, after
    each rank printed its threads' stacks."""

    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.core import topology
    from repro_torch.core.communicator import world

    comm = world(device_type=args.device)
    cart = topology.cart_create(comm, [WORLD], [True])
    me, n = cart.rank(), WORLD
    src, dst = (me - 1) % n, (me + 1) % n
    group = cart.axis_group(cart.axis_names[0])
    dev = torch.device(args.device, torch.cuda.current_device()) if args.device == "cuda" \
        else torch.device("cpu")
    x = torch.arange(1 << 20, dtype=torch.float32, device=dev) + 1e6 * me

    def shift(x):
        if args.part == "capture_alltoall":
            out_ = torch.empty_like(x)
            dist.all_to_all_single(out_, x, output_split_sizes=[x.numel() * (j == src)
                                                                for j in range(n)],
                                   input_split_sizes=[x.numel() * (j == dst) for j in range(n)],
                                   group=group)
            return out_
        return cart.shift_exchange(x, 0, 1).get()

    def want(k: int):
        return torch.arange(1 << 20, dtype=torch.float32, device=dev) + 1e6 * src + k

    if args.part not in ("capture_shift", "capture_alltoall", "capture_shift_cold"):
        return _capture_probe_chain(args, out, comm, cart, dev)
    row = {"probe": args.part, "eager_first": args.part != "capture_shift_cold"}
    out["probe"] = row
    _dump(out)
    if row["eager_first"]:
        row["eager_equal"] = bool(torch.equal(shift(x), want(0)))
        torch.cuda.synchronize() if args.device == "cuda" else None
    if args.device != "cuda":
        row["replays_equal"] = [bool(torch.equal(shift(x), want(0)))]
        return
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        y = shift(x)
    torch.cuda.synchronize()
    row["capture_s"] = time.perf_counter() - t0
    _dump(out)
    row["replays_equal"] = []
    for k in range(1, 4):
        x.add_(1.0)
        graph.replay()
        torch.cuda.synchronize()
        row["replays_equal"].append(bool(torch.equal(y, want(k))))
    chip_smoke.log(f"rank {me} {args.part}: " + json.dumps(row))
    chip_smoke.check(all(row["replays_equal"]) and row.get("eager_equal", True),
                     f"{args.part}: {row}")
    del graph


def _capture_probe_chain(args, out, comm, cart, dev) -> None:
    """``capture_chain``: ``CHAIN_SHIFTS`` shifts chained in one graph, each
    of a buffer of ``CHAIN_ELEMS`` fp32 made inside the step (the graph's
    pool hands freed buffers on, as in a training step), the sum of what
    arrived returned, under the session's NCCL setting (buffer
    registration in graphs off); ``capture_chain_registered`` the same with
    registration on (``NCCL_GRAPH_REGISTER=1``, set by the parent): its
    first replay deadlocked; ``capture_backward``: a differentiable shift
    and its backward (a shift by -1, which autograd's device thread issues)
    in one graph; ``capture_ring_schedules``: ``core/overlap.py``'s
    ``ring_all_gather`` and ``ring_reduce_scatter`` over the four ranks.
    Each eagerly first, then captured and replayed three times: every
    replay's result equal to the eager one's, bit for bit."""

    import torch

    import chip_smoke
    from repro_torch.core import overlap, topology
    from repro_torch.core.futures import flatten

    me = cart.rank()
    base = (torch.arange(CHAIN_ELEMS, device=dev) % 1024).float() + me

    def chain(x):
        acc = torch.zeros_like(x)
        for i in range(CHAIN_SHIFTS):
            acc = acc + cart.shift_exchange(x * (i + 1), 0, 1).get()
            x = x + 1
        return acc

    w = torch.linspace(-1, 1, CHAIN_ELEMS, device=dev) * (me + 1)

    def backward(x):
        x = x.detach().requires_grad_(True)
        y = topology.shift_differentiable(cart, x, 0, 1)
        return torch.autograd.grad((y * w).sum(), x)[0]

    def schedules(x):
        return (overlap.ring_all_gather(comm, x.view(64, -1)),
                overlap.ring_reduce_scatter(comm, x.view(64, -1)))

    fn = {"capture_backward": backward, "capture_ring_schedules": schedules}.get(args.part,
                                                                                chain)
    row = {"probe": args.part, "nccl_graph_register": os.environ.get("NCCL_GRAPH_REGISTER")}
    out["probe"] = row
    _dump(out)
    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(flatten(a)[0], flatten(b)[0]))

    want = fn(base)
    if args.device != "cuda":
        row["replays_equal"] = [equal(fn(base), want)]
        return
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        y = fn(base)
    torch.cuda.synchronize()
    row["capture_s"] = time.perf_counter() - t0
    _dump(out)
    row["replays_equal"] = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        row["replays_equal"].append(equal(y, want))
        _dump(out)
    chip_smoke.log(f"rank {me} {args.part}: " + json.dumps(row))
    chip_smoke.check(all(row["replays_equal"]), f"{args.part}: {row}")
    del graph


def _capture_plan(args, out) -> None:
    """The ring plan (ring 4, b 2 x ``--ring-seq``) or the pipeline plan
    (stage 4, micro 4, b ``--batch`` x ``--seq``) trained ``--steps``
    steps by ``Trainer(persistent=False)`` (eager) and by the default
    ``Trainer`` (start 1 eager, captured at start 2, replayed after): the
    losses, the gradient norms and the final parameters must be equal bit
    for bit; each run's step times, captures and peak logged."""

    import torch

    import chip_smoke
    from repro_torch.configs.base import ParallelPlan
    from repro_torch.core.futures import flatten
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, pcfg = _train_cfg(args)
    if args.part == "capture_ring":
        plan, seq, batch = ParallelPlan(ring=WORLD), args.ring_seq, RING_BATCH
    else:
        plan, seq, batch = ParallelPlan(stage=WORLD, microbatches=WORLD), args.seq, args.batch
    row = {"plan": plan.slug(), "seq": seq, "batch": batch, "steps": args.steps,
           "nccl_graph_register": os.environ.get("NCCL_GRAPH_REGISTER")}
    out["capture_plan"] = row
    finals = {}
    # bit for bit needs the deterministic kernels where PyTorch has a choice
    torch.use_deterministic_algorithms(True, warn_only=True)
    for name, persistent in (("eager", False), ("captured", True)):
        _reset(args.device)
        t = Trainer(cfg, pcfg, TrainerConfig(steps=args.steps, lr=3e-4, log_every=1, plan=plan,
                                             persistent=persistent),
                    make_host_communicator(device=args.device), seq_len=seq,
                    global_batch=batch, straggler=StragglerPolicy(deadline_factor=float("inf")))
        result = t.run()
        metrics = result["metrics"]
        row[name] = {"losses": [m["loss"] for m in metrics],
                     "grad_norms": [m["grad_norm"] for m in metrics],
                     "step_s": [m["duration_s"] for m in metrics],
                     "captures": t._request.captured if t._request is not None else 0,
                     "placed": t.placed, "peak_gb": _peak(args.device)}
        finals[name] = [(x.to_local() if hasattr(x, "to_local") else x).detach().cpu()
                        for x in flatten(t.params)[0]]
        _dump(out)
        del t, result
    torch.use_deterministic_algorithms(False)
    row["losses_equal"] = row["eager"]["losses"] == row["captured"]["losses"]
    row["grad_norms_equal"] = row["eager"]["grad_norms"] == row["captured"]["grad_norms"]
    row["params_equal"] = all(torch.equal(a, b) for a, b in
                              zip(finals["eager"], finals["captured"]))
    for name in ("eager", "captured"):
        row[name]["warm_step_s"] = sorted(row[name]["step_s"][2:])[len(row[name]["step_s"][2:])
                                                                  // 2]
    chip_smoke.log(f"rank {out['rank']} {args.part}: " + json.dumps(row))
    _dump(out)
    chip_smoke.check(row["losses_equal"] and row["grad_norms_equal"] and row["params_equal"],
                     f"{args.part}: the captured steps differ from the eager ones: {row}")


def _rank_main(args) -> int:
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.core.communicator import world

    comm = world(device_type=args.device)
    chip_smoke.check(comm.size() == WORLD, f"{comm.size()} ranks, want {WORLD}")
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    out = {"card": card, "world": WORLD, "rank": comm.rank(), "part": args.part}
    t0 = time.perf_counter()
    if args.part in CAPTURE_PARTS:
        # a capture or replay that hangs blocks in the device, where no
        # Python handler runs: each thread's stack is printed before the
        # torchrun's limit ends the ranks
        import faulthandler

        limit = CAPTURE_PROBE_LIMIT_S if args.part in CAPTURE_PROBES else CAPTURE_PLAN_LIMIT_S
        faulthandler.dump_traceback_later(limit - 30, exit=True)
        (_capture_probe if args.part in CAPTURE_PROBES else _capture_plan)(args, out)
    elif args.part is not None:
        {"drill": _elastic_drill, "controls": _elastic_controls,
         "plans": lambda a, o: _train_plans(a, o, {}), "ring_prefill": _ring_prefill,
         "engine": _engine, "tune_rings": _tune_rings, "tune_train": _tune_train,
         "tune_serve": _tune_serve}[args.part](args, out)
    else:
        if not args.skip_serve:
            _serve_qwen(args, out)
            _serve_phi4(args, out)
        _train(args, out)
    out["run_s"] = time.perf_counter() - t0
    chip_smoke.log(f"rank {comm.rank()}: " + json.dumps(out))
    _dump(out)
    _reset(args.device)   # no trainer's graph outlives the groups below
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
    # qwen's whole model is drawn on each card before it is placed leaf by
    # leaf: every placed leaf's shard is allocated beside ~70 GB, which a
    # fragmented cache cannot give
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={WORLD}", __file__, *(argv if argv is not None else sys.argv[1:])]
    # the elastic parts run in processes of their own: a placed trainer that
    # followed the drill's in one process ran out of memory (PERF.md §7)
    if args.tune and args.part is None:
        # every part runs whatever the others did; their exit codes recorded
        rcs = {}
        for part in TUNE_PARTS:
            rcs[part] = subprocess.run(cmd + ["--part", part], env=env, cwd=str(ROOT),
                                       timeout=PART_LIMIT_S).returncode
            path = ROOT / "artifacts" / "shard_ranks_tune.json"
            path.parent.mkdir(exist_ok=True)
            path.write_text(json.dumps({"exit_codes": rcs}, indent=1))
        print(json.dumps({"tune_exit_codes": rcs}), flush=True)
        return max(rcs.values())
    if args.capture and args.part is None:
        # every part runs whatever the others did; their exit codes recorded
        rcs = {}
        for part in args.capture_parts.split(","):
            part_env = dict(env)
            if part == "capture_chain_registered":
                part_env["NCCL_GRAPH_REGISTER"] = "1"
            limit = CAPTURE_PROBE_LIMIT_S if part in CAPTURE_PROBES else CAPTURE_PLAN_LIMIT_S
            try:
                rcs[part] = subprocess.run(cmd + ["--part", part], env=part_env, cwd=str(ROOT),
                                           timeout=limit).returncode
            except subprocess.TimeoutExpired:
                rcs[part] = 124
            path = ROOT / "artifacts" / "shard_ranks_capture.json"
            path.parent.mkdir(exist_ok=True)
            path.write_text(json.dumps({"exit_codes": rcs}, indent=1))
        print(json.dumps({"capture_exit_codes": rcs}), flush=True)
        return max(rcs.values())
    parts = (ELASTIC_PARTS if args.elastic else ()) + (PLACED_PARTS if args.ring_engine else ())
    for part in parts if args.part is None and parts else (None,):
        rc = subprocess.run(cmd + (["--part", part] if part else []), env=env,
                            cwd=str(ROOT), timeout=PART_LIMIT_S).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
