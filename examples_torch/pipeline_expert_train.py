"""Chapter 8 in anger on the port: the pipeline/expert-parallel fabric.

Two demonstrations of virtual process topologies as production traffic
shaping:

1. a Trainer in **pipeline-parallel mode** — the process set folded onto a
   ``(data, stage)`` Cartesian grid, microbatches streamed through
   ``cart_shift(+1)`` stage boundaries, the whole step still one persistent
   request (``trace:train_step == 1``), and its recorded program's
   collectives read back by ``analyze_hlo``;
2. **expert dispatch over the router's expert map** — top-k MoE routing
   restricted to a ring neighborhood (device-limited routing) and the token
   exchange riding ``neighbor_alltoallv`` over a ``DistGraphComm``, sparse
   point-to-point traffic instead of a world-dense ``all_to_all``.

Each rank is a process holding its block of the tokens and its slice of
the experts.  On an odd world (one card) the pipeline demo is skipped, as
the reference's skips it on an odd device count::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        examples_torch/pipeline_expert_train.py --device cpu

``main(params=..., moe_params=..., tokens=...)`` takes the trainer's
parameter tree, the whole MoE block's weights and the tokens (the
reference's, converted) in place of the seeded draws.
"""
# lint-ranks: 4

import argparse
import copy

import torch

from repro_torch import core as mpx
from repro_torch.configs.base import ModelConfig, ParallelConfig, ParallelPlan
from repro_torch.core import tool, topology
from repro_torch.core.hloanalysis import analyze_hlo
from repro_torch.models import mlp
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def tiny_cfg(**kw) -> ModelConfig:
    base = dict(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)


def pipeline_demo(comm, params=None) -> dict:
    stages = 2 if comm.size() % 2 == 0 else 1
    if stages < 2:
        print("pipeline demo needs an even device count; skipping")
        return {}
    trainer = Trainer(
        tiny_cfg(), ParallelConfig(),
        TrainerConfig(steps=10, lr=1e-3, log_every=5,
                      plan=ParallelPlan(stage=stages, microbatches=2)),
        comm, seq_len=64, global_batch=8,
    )
    if params is not None:
        trainer.init_state = lambda: trainer.place_state(copy.deepcopy(params))
    print(f"pipeline topology: {trainer.comm}")
    result = trainer.run()
    pvars = tool.pvar_read()
    print(f"trained to step {result['final_step']}: "
          f"loss {result['metrics'][-1]['loss']:.4f} — "
          f"traces {pvars.get('trace:train_step')}, "
          f"persistent starts {pvars.get('persistent_start')}")
    stats = analyze_hlo(trainer._compiled.as_text()).collectives
    print(f"step collectives: {dict(stats.count)} (stage boundaries are "
          f"collective-permutes; no dense world alltoall)")
    out = {"final_step": result["final_step"],
           "losses": [m["loss"] for m in result["metrics"]],
           "steps": [m["step"] for m in result["metrics"]],
           "traces": pvars.get("trace:train_step"),
           "persistent_starts": pvars.get("persistent_start"),
           "collectives": dict(stats.count), "dims": tuple(trainer.comm.shape)}
    del trainer
    return out


def expert_demo(comm, moe_params=None, tokens=None) -> dict:
    n, dev = comm.size(), comm.device
    cfg = tiny_cfg(family="moe", num_experts=2 * n, moe_top_k=2, moe_d_ff=96)
    if moe_params is None:
        moe_params = mlp.init_moe(torch.Generator(device=dev).manual_seed(0), cfg,
                                  torch.float32)
    if tokens is None:
        tokens = torch.randn((8 * n, cfg.d_model), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))
    srcs, dsts = mlp.expert_dispatch_graph(n, cfg.num_experts, radius=1)
    graph = topology.dist_graph_create_adjacent(comm, srcs, dsts)
    print(f"expert graph: {graph} — rank 0 neighbors "
          f"{graph.dist_graph_neighbors(0)[2]}")

    # this rank's block of the tokens and slice of the experts (the
    # reference's in_specs P("world")); the router whole
    r, el, t = comm.rank(), cfg.num_experts // n, tokens.shape[0] // n
    local = {"router": moe_params["router"].to(dev)}
    for k in ("w_gate", "w_up", "w_down"):
        local[k] = moe_params[k][r * el:(r + 1) * el].to(dev)
    y, aux = mlp.moe_neighbor(local, tokens[r * t:(r + 1) * t].to(dev), cfg, graph)
    dropped = float(aux["dropped_fraction"])
    shape = (y.shape[0] * n, y.shape[1])
    neighbor = tool.pvar_read()["neighbor_alltoallv"]
    print(f"dispatched {tokens.shape[0]} tokens over the graph: "
          f"out {shape}, dropped fraction {dropped:.3f}, "
          f"neighbor_alltoallv issued: {neighbor}")
    return {"y": y.detach().cpu().numpy(), "dropped": dropped, "out_shape": shape,
            "neighbor_alltoallv": neighbor, "neighbors0": list(graph.dist_graph_neighbors(0)[2])}


def main(argv=None, *, params=None, moe_params=None, tokens=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to run on (default: the CUDA device)")
    args = ap.parse_args(argv)
    comm = mpx.world(device_type=args.device)
    return {"pipeline": pipeline_demo(comm, params),
            "expert": expert_demo(comm, moe_params, tokens)}


if __name__ == "__main__":
    main()
