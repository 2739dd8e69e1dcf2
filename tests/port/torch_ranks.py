"""Multi-rank programs of the port's tests, and the harness that runs them:
one fresh Python process per rank, gloo over a ``file://`` store in the
test's own directory (never a fixed port: the suite runs in parallel), each
group with a 60 s timeout, and a hard wall-clock limit after which every
rank still running is killed.  Beside them, :func:`start_jax` runs the
reference's side in a fresh Python with virtual JAX devices.

    python tests/port/torch_ranks.py <program> <rank> <world> <workdir>

A program reads its inputs from ``<workdir>/inputs.npz`` (written by the
test) and saves what it computed to ``<workdir>/rank<r>.npz``; the test
compares.  This module imports torch and numpy only, so a rank starts
quickly and never sees JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def run_ranks(program: str, world: int, workdir: Path, timeout: float = 150.0,
              envs: list[dict] | None = None) -> list[dict]:
    """Run ``program`` on ``world`` ranks; the per-rank results, in rank
    order.  Raises with every rank's output if one fails or the limit
    passes."""

    return finish_ranks(start_ranks(program, world, workdir, timeout, envs))


def start_ranks(program: str, world: int, workdir: Path, timeout: float = 150.0,
                envs: list[dict] | None = None) -> tuple:
    """Start ``program`` on ``world`` ranks without waiting; hand the
    result to :func:`finish_ranks`.  ``envs[r]``, where given, adds to rank
    ``r``'s environment (a ``PYTHONHASHSEED`` of its own, say)."""

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [
        subprocess.Popen([sys.executable, __file__, program, str(r), str(world), str(workdir)],
                         stdout=logs[r], stderr=subprocess.STDOUT,
                         env={**env, **(envs[r] if envs else {})}, cwd=str(ROOT))
        for r in range(world)
    ]
    return program, world, workdir, timeout, time.monotonic() + timeout, logs, procs


def finish_ranks(started: tuple) -> list[dict]:
    """Wait for the ranks :func:`start_ranks` started (killing those still
    running at its limit); their results, in rank order."""

    program, world, workdir, timeout, deadline, logs, procs = started
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(
            f"{program} on {world} ranks: exit codes {codes} (limit {timeout}s)\n"
            + "\n".join(f"--- rank {r}\n{out[-3000:]}" for r, out in enumerate(outputs)))
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


def start_jax(code: str, workdir, n: int = 4) -> subprocess.Popen:
    """The reference's side in a fresh Python with ``n`` virtual CPU
    devices (the ``subproc`` fixture's environment), started without
    waiting."""

    env = {**os.environ, "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
           "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", code, str(workdir)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


def finish_jax(proc: subprocess.Popen, marker: str, timeout: float = 300.0) -> None:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0 and marker in out, f"rc={proc.returncode}\n{out}\n{err[-4000:]}"


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _init(rank: int, world: int, workdir: Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))


def _err(fn) -> str:
    from repro_torch.core import errors

    try:
        fn()
    except errors.Error as e:
        return e.klass.name
    return "none"


def prog_collectives(rank: int, world: int, inputs: dict) -> dict:
    """Every ported collective on this rank's slice of the inputs, the
    typed errors of bad calls, and the shift exchanges of a 2 x 2 cart."""

    import torch

    from repro_torch.core import topology
    from repro_torch.core.communicator import world as world_comm
    from repro_torch.core.descriptors import CollectiveSpec, ReduceOp

    comm = world_comm(device_type="cpu")
    x = torch.from_numpy(inputs["x"][rank])
    ints = torch.from_numpy(inputs["ints"][rank])
    xv = torch.from_numpy(inputs["xv"][rank])
    out = {
        "allreduce_sum": comm.allreduce(x),
        "allreduce_max": comm.allreduce(x, op=ReduceOp.MAX),
        "allreduce_min": comm.allreduce(x, op=ReduceOp.MIN),
        "allreduce_prod": comm.allreduce(x, op=ReduceOp.PROD),
        "allreduce_land": comm.allreduce(ints, op=ReduceOp.LAND),
        "allreduce_lor": comm.allreduce(ints, op=ReduceOp.LOR),
        "allreduce_lxor": comm.allreduce(ints, op=ReduceOp.LXOR),
        "allreduce_band": comm.allreduce(ints, op=ReduceOp.BAND),
        "allreduce_bor": comm.allreduce(ints, op=ReduceOp.BOR),
        "allreduce_bxor": comm.allreduce(ints, op=ReduceOp.BXOR),
        "broadcast": comm.broadcast(x, root=2),
        "reduce": comm.reduce(x, root=1),
        "reduce_scatter": comm.reduce_scatter(x),
        "allgather": comm.allgather(x),
        "allgather_stacked": comm.allgather(x, spec=CollectiveSpec(tiled=False)),
        "allgather_axis1": comm.allgather(x, spec=CollectiveSpec(axis=1)),
        "gather": comm.gather(x, root=3),
        "scatter": comm.scatter(x, root=1),
        "alltoall": comm.alltoall(x),
        "alltoall_0_1": comm.alltoall(x, split_axis=0, concat_axis=1),
        "allgatherv": comm.allgatherv(xv, (3, 1, 4, 2)),
        "alltoallv": comm.alltoallv(x, (2, 1, 2, 1))[0],
        "scan_sum": comm.scan(x),
        "scan_max": comm.scan(x, op=ReduceOp.MAX),
        "scan_prod": comm.scan(x, op=ReduceOp.PROD),
        "exscan_sum": comm.exscan(x),
        "exscan_min": comm.exscan(x, op=ReduceOp.MIN),
        "send_recv": comm.send_recv(x, [(0, 2), (2, 1), (1, 0)]),
        "shift": comm.shift(x),
        "shift_nowrap": comm.shift(x, offset=-1, wrap=False),
        "immediate_allreduce": comm.immediate_allreduce(x).get(),
        "immediate_shift": comm.immediate_shift(x, 2).get(),
        "barrier": comm.barrier(),
    }
    tree = comm.allreduce({"a": x, "b": [ints, x[:2]]})
    out["tree_a"], out["tree_b0"], out["tree_b1"] = tree["a"], tree["b"][0], tree["b"][1]
    cart = topology.cart_create(comm, (2, 2), (True, False), axis_names=("row", "col"))
    for dim in (0, 1):
        for disp in (1, -1):
            out[f"cart_shift_{dim}_{disp}"] = cart.shift_exchange(x, dim, disp).get()
    errs = {
        "bad_root": _err(lambda: comm.broadcast(x, root=4)),
        "bad_reduce_root": _err(lambda: comm.reduce(x, root=-1)),
        "bad_scatter": _err(lambda: comm.reduce_scatter(x[:, :1].T.contiguous())),
        "bad_counts": _err(lambda: comm.allgatherv(xv, (1, 2, 3))),
        "bad_padding": _err(lambda: comm.allgatherv(xv[:3], (3, 1, 4, 2))),
    }
    result = {k: v.numpy() for k, v in out.items()}
    result.update({f"err_{k}": np.array(v) for k, v in errs.items()})
    result["coords"] = np.array([cart.rank(), *cart.coords()])
    return result


def prog_ring(rank: int, world: int, inputs: dict) -> dict:
    """The fused ring and the plain eager ring on this rank's shards, for
    each case of the inputs."""

    import torch

    from repro_torch.core import overlap, topology
    from repro_torch.core.communicator import world as world_comm
    from repro_torch.kernels.ring_attention import ops as ring_ops

    comm = world_comm(device_type="cpu")
    cart = topology.cart_create(comm, (world,), (True,), axis_names=("ring",))
    out = {}
    for name in sorted({k.split(":")[0] for k in inputs}):
        q, k, v = (torch.from_numpy(inputs[f"{name}:{t}"]) for t in "qkv")
        s, causal = int(inputs[f"{name}:S"]), bool(inputs[f"{name}:causal"])
        shard = q.shape[1] // world
        rows = slice(rank * shard, (rank + 1) * shard)
        out[f"{name}:fused"] = ring_ops.ring_attention(
            cart, q[:, rows], k[:, rows], v[:, rows], causal=causal, global_len=s,
            block_q=16, block_k=16).numpy()
        if s == q.shape[1]:
            out[f"{name}:plain"] = overlap.ring_attention(
                cart, q[:, rows], k[:, rows], v[:, rows], causal=causal).numpy()
    return out


def prog_ring_grad(rank: int, world: int, inputs: dict) -> dict:
    """The fused ring's gradient on this rank's shards for each case of the
    inputs (the cotangent ``g`` sliced as the output), and the gradient of
    a differentiable cart shift by +1 on a periodic ring and on a line:
    ``x`` is this rank's row, the loss ``sum(shift(x) * w)``."""

    import torch

    from repro_torch.core import topology
    from repro_torch.core.communicator import world as world_comm
    from repro_torch.kernels.ring_attention import ops as ring_ops

    comm = world_comm(device_type="cpu")
    ring = topology.cart_create(comm, (world,), (True,), axis_names=("ring",))
    out = {}
    for name in sorted({k.split(":")[0] for k in inputs if ":" in k}):
        q, k, v, g = (torch.from_numpy(inputs[f"{name}:{t}"]) for t in "qkvg")
        s, causal = int(inputs[f"{name}:S"]), bool(inputs[f"{name}:causal"])
        shard = q.shape[1] // world
        rows = slice(rank * shard, (rank + 1) * shard)
        ql, kl, vl = (t[:, rows].clone().requires_grad_(True) for t in (q, k, v))
        o = ring_ops.ring_attention(ring, ql, kl, vl, causal=causal, global_len=s,
                                    block_q=16, block_k=16)
        for t, d in zip("qkv", torch.autograd.grad(o, (ql, kl, vl), g[:, rows])):
            out[f"{name}:d{t}"] = d.numpy()
    x = torch.from_numpy(inputs["shift_x"][rank].copy()).requires_grad_(True)
    w = torch.from_numpy(inputs["shift_w"][rank].copy())
    line = topology.cart_create(comm, (world,), (False,), axis_names=("line",))
    for label, cart in (("ring", ring), ("line", line)):
        y = topology.shift_differentiable(cart, x, 0, 1)
        out[f"shift_{label}:y"] = y.detach().numpy()
        (out[f"shift_{label}:dx"],) = (d.numpy() for d in torch.autograd.grad(
            (y * w).sum(), x))
    return out


def prog_pipeline_schedule(rank: int, world: int, inputs: dict) -> dict:
    """The reference's ``PIPELINE_CODE`` on this rank: the halo exchange of
    width 2 on a line and on a ring, and a 3-microbatch pipeline whose
    stage ``s`` multiplies by ``s + 1``, its drained values summed over the
    stages."""

    import torch

    from repro_torch.core import overlap, topology
    from repro_torch.core.communicator import world as world_comm

    comm = world_comm(device_type="cpu")
    out = {}
    for label, periodic in (("line", False), ("ring", True)):
        cart = topology.cart_create(comm, (world,), (periodic,), tag=f"halo-{label}")
        x = torch.zeros(4) + float(cart.rank())
        lo, hi = overlap.halo_exchange(cart, x, dim=0, axis=0, width=2).get()
        out[f"halo_{label}"] = torch.stack([lo, hi]).numpy()
    cart = topology.cart_create(comm, (world,), (False,), tag="pipeline")
    stage = cart.cart_coords(cart.rank())[0]
    xs = torch.from_numpy(inputs["xs"])
    outs = overlap.pipeline_spmd(
        cart, stage_dim=0, num_microbatches=xs.shape[0],
        inject=lambda i: xs[i],
        stage_fn=lambda state, t: state * (stage + 1.0),
        extract=lambda i, state, is_last: state if is_last else torch.zeros_like(state),
    )
    out["pipeline"] = torch.stack([cart.allreduce(o) for o in outs]).numpy()
    return out


def _params(inputs: dict) -> dict:
    """The reference's parameter tree, saved with '/'-joined key paths."""

    from repro_torch.convert import params_from_jax

    tree: dict = {}
    for key, arr in inputs.items():
        if not key.startswith("param/"):
            continue
        node = tree
        *path, leaf = key.split("/")[1:]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return params_from_jax(tree, "cpu")


def _serve(inputs: dict, cfg, pcfg, comm) -> np.ndarray:
    from repro_torch.runtime.server import Request, Server, ServerConfig

    server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=4), comm)
    if any(k.startswith("param/") for k in inputs):
        server.params = _params(inputs)
    prompts = [inputs["prompt0"], inputs["prompt1"]]
    tokens, _ = server.generate([Request(tokens=p.copy()) for p in prompts])
    return tokens


def prog_server(rank: int, world: int, inputs: dict) -> dict:
    """The reference's ``SERVER_RING`` model and prompts on a 2 x 2 grid,
    with and without the ring, on the reference's weights."""

    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.launch.mesh import make_host_communicator

    comm = make_host_communicator(2, 2, device="cpu")
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, dtype="float32")
    ring = _serve(inputs, cfg, dataclasses.replace(ParallelConfig(), ring_attention=True), comm)
    base = _serve(inputs, cfg, ParallelConfig(), comm)
    return {"ring": ring, "base": base, "coords": np.array(comm.coords())}


def prog_zamba2_ring(rank: int, world: int, inputs: dict) -> dict:
    """zamba2's smoke model in fp32 with the ring over a 1 x 2 grid: its
    shared attention runs the ring."""

    from repro_torch.configs import base
    from repro_torch.launch.mesh import make_host_communicator

    comm = make_host_communicator(1, 2, device="cpu")
    cfg = dataclasses.replace(base.get_smoke_config("zamba2_7b"), dtype="float32")
    pcfg = dataclasses.replace(base.get_parallel("zamba2_7b"), ring_attention=True)
    return {"ring": _serve(inputs, cfg, pcfg, comm)}


def prog_trainer(rank: int, world: int, inputs: dict) -> dict:
    """The port's Trainer on the data plan over every rank: the tiny dense
    model in fp32 at the global batch the test gives, its losses per step
    and its parameters after the last."""

    import torch

    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32")
    steps = int(inputs["steps"])
    trainer = Trainer(cfg, ParallelConfig(), TrainerConfig(steps=steps, lr=1e-3, log_every=1),
                      make_host_communicator(device="cpu"), seq_len=int(inputs["seq"]),
                      global_batch=int(inputs["batch"]), clock=lambda: 0.0)
    result = trainer.run()
    flat = torch.cat([_whole(p).detach().reshape(-1) for p in _leaves(trainer.params)])
    return {"losses": np.array([m["loss"] for m in result["metrics"]]),
            "params": flat.numpy(), "world": np.array(result["world_size"])}


def _whole(t):
    """A DTensor's whole value; any other tensor as it is."""

    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@dataclasses.dataclass
class Grads:
    """The aggregate of the persistent collectives' test: two float32
    leaves and an int32 one, so two dtype buckets."""

    w: object
    b: object
    n: object


def prog_requests(rank: int, world: int, inputs: dict) -> dict:
    """The persistent collectives on this rank's slice of the inputs: each
    started twice (the second time on other values) on one array and on a
    mixed-dtype aggregate; the shape-changing ones return raw buckets."""

    import torch

    from repro_torch.core.communicator import world as world_comm

    comm = world_comm(device_type="cpu")

    def grads(i):
        return Grads(*(torch.from_numpy(inputs[k][i, rank]) for k in ("w", "b", "n")))

    x = torch.from_numpy(inputs["x"][:, rank])
    out = {}
    single = comm.allreduce_init(x[0])
    for i in range(2):
        out[f"allreduce_single_{i}"] = single.start(x[i]).get()
    for name in ("allreduce", "reduce_scatter", "allgather"):
        req = getattr(comm, f"{name}_init")(grads(0))
        out[f"{name}_buckets"] = torch.tensor(len(req.requests))
        for i in range(2):
            got = req.start(grads(i)).get()
            leaves = [got.w, got.b, got.n] if name == "allreduce" else got
            for j, leaf in enumerate(leaves):
                out[f"{name}_{i}_{j}"] = leaf
        g = grads(0)
        out[f"{name}_drift"] = torch.tensor(
            _err(lambda: req.start(Grads(g.w, g.b, g.n.float()))) == "ERR_REQUEST")
    out["starts"] = torch.tensor(single.starts)
    return {k: v.numpy() for k, v in out.items()}


#: prog_grad_sync's modes: (name, the outer communicator is used, int8 compression
#: with error feedback), the reference test's three (tests/test_requests.py)
GRAD_SYNC_MODES = (("single", False, False), ("hier", True, False),
                   ("hier_int8_ef", True, True))


def grad_sync_order(rank: int) -> tuple[int, int]:
    """The ``pready`` order of rank ``rank`` in prog_grad_sync's modes:
    ranks 0 and 3 mark their two buckets ready in index order, ranks 1 and
    2 the other way round, in one call."""

    return (0, 1) if rank in (0, 3) else (1, 0)


def prog_grad_sync(rank: int, world: int, inputs: dict) -> dict:
    """The partitioned forms on a 2 x 2 grid ("outer", "inner"), on this
    rank's slice of the inputs: ``partitioned_allreduce`` with a chunk-wise
    continuation, partitions marked ready out of order;
    ``hierarchical_allreduce`` with and without int8 compression; and
    ``PartitionedGradSync`` in its three modes over two rounds (the second
    with the first's error feedback), with ranks marking their buckets
    ready in different orders, and ``sync_gradients`` in both orders and
    with the int8 stage alone."""

    import torch

    from repro_torch.core.communicator import Communicator
    from repro_torch.core.descriptors import Compression
    from repro_torch.core.overlap import hierarchical_allreduce
    from repro_torch.core.session import default_session
    from repro_torch.optim import ErrorFeedbackState, PartitionedGradSync, sync_gradients

    sess = default_session(device_type="cpu")
    comm = Communicator.from_group(sess.group("repro://world"), tag="repro://world",
                                   shape=(2, 2), axis_names=("outer", "inner"))
    inner, outer = comm.split("inner"), comm.split("outer")
    out = {"rank": np.array(comm.rank())}

    req = inner.partitioned_allreduce(3, continuation=lambda i, y: y + i)
    pa = torch.from_numpy(inputs["pa"][rank])
    for i in (2, 0, 1):
        req.pready(i, pa[i])
    for i, y in enumerate(req.wait()):
        out[f"partitioned_{i}"] = y.numpy()
    hx = torch.from_numpy(inputs["hx"][rank])
    for c in (Compression.NONE, Compression.INT8):
        out[f"hier_{c.value}"] = hierarchical_allreduce(hx, inner, outer, compression=c).numpy()

    def grads(i):
        return {"w": torch.from_numpy(inputs["w"][rank, i]),
                "b": torch.from_numpy(inputs["b"][rank, i]),
                "h": torch.from_numpy(inputs["h"][rank, i]).to(torch.bfloat16)}

    for name, hier, int8 in GRAD_SYNC_MODES:
        sync = PartitionedGradSync(inner, outer if hier else None,
                                   compression=Compression.INT8 if int8 else Compression.NONE)
        ef = ErrorFeedbackState.init(grads(0)) if int8 else None
        for i in range(2):
            # error feedback makes every leaf fp32: one bucket, one order
            got, ef = sync(grads(i), ef, pready_order=None if int8 else grad_sync_order(rank))
            for k, v in got.items():
                out[f"{name}_{i}_{k}"] = v.float().numpy()
            if int8:
                for k, v in ef.residual.items():
                    out[f"{name}_{i}_residual_{k}"] = v.numpy()
    for order in ((0, 1), (1, 0)):
        got, _ = sync_gradients(grads(0), inner, outer, pready_order=order)
        for k, v in got.items():
            out[f"order_{order[0]}{order[1]}_{k}"] = v.float().numpy()
    # the int8 stage without error feedback: two buckets, the bf16 one
    # compressed too, ranks in different orders
    got, _ = sync_gradients(grads(1), inner, outer, compression=Compression.INT8,
                            pready_order=grad_sync_order(rank))
    for k, v in got.items():
        out[f"int8_no_ef_{k}"] = v.float().numpy()
    return out


@dataclasses.dataclass
class KV:
    """The aggregate of the RMA numerics: an fp32 and an int32 leaf."""

    k: object
    v: object


def prog_rma(rank: int, world: int, inputs: dict) -> dict:
    """The RMA numerics of the reference's ``CODE_RMA`` on this rank's
    slice of the inputs: put/get/accumulate over the op set, the window's
    default op, the atomics, a paged rput of an aggregate, rget, request
    ordering through ``then()``, REPLACE across ranks, the per-epoch write
    ledger, an empty pattern and a dynamic window."""

    import torch

    from repro_torch.core import futures, onesided
    from repro_torch.core.communicator import world as world_comm
    from repro_torch.core.descriptors import ReduceOp, WindowSpec

    comm = world_comm(device_type="cpu")
    n = comm.size()
    w, x = torch.from_numpy(inputs["w0"][rank]), torch.from_numpy(inputs["val"][rank])
    bits = torch.from_numpy(inputs["bits"][rank])
    out = {}

    win = onesided.Window(comm, w).fence()
    out["ops_get"] = win.get([((d - 1) % n, d) for d in range(n)])
    win.put(x, [(1, 0)])
    win.accumulate(x, target=2, op=ReduceOp.MAX)
    win.accumulate(x, target=3, op=ReduceOp.PROD)
    win.accumulate(x, target=1, op=ReduceOp.SUM)
    out["ops_buffer"] = win.fence().buffer

    win = onesided.Window(comm, bits).fence()
    win.accumulate(bits, target=0, op=ReduceOp.BXOR)
    win.accumulate(bits, target=1, op=ReduceOp.LOR)
    win.accumulate(bits, target=2, op=ReduceOp.BAND)
    out["bits_buffer"] = win.fence().buffer

    win = onesided.Window(comm, w, WindowSpec(accumulate_op=ReduceOp.MIN)).fence()
    win.accumulate(x, target=1)
    out["spec_buffer"] = win.fence().buffer

    win = onesided.Window(comm, w).fence()
    out["fo_sum"] = win.fetch_and_op(torch.tensor(5.0), target=1, op=ReduceOp.SUM, index=2)
    out["cas_hit"] = win.compare_and_swap(float(inputs["w0"][2][0]), 42.0, target=2, index=0)
    out["cas_miss"] = win.compare_and_swap(7.5, -1.0, target=2, index=1)
    out["ga_noop"] = win.get_accumulate(torch.ones(4), target=3, op=ReduceOp.NO_OP)
    out["fo_max"] = win.fetch_and_op(w[0], target=0, op=ReduceOp.MAX, index=1)
    out["fo_replace"] = win.fetch_and_op(w[3], target=3, op=ReduceOp.REPLACE, index=3)
    out["atomics_buffer"] = win.fence().buffer

    agg = KV(k=torch.from_numpy(inputs["k"][rank]), v=torch.from_numpy(inputs["v"][rank]))
    win = onesided.Window(comm, KV(k=torch.zeros_like(agg.k), v=torch.zeros_like(agg.v)),
                          WindowSpec(num_pages=3)).fence()
    futures.when_all([win.rput(agg, [(n - 1, 1)], page=p) for p in range(3)]).get()
    buf = win.fence().buffer
    out["pytree_k"], out["pytree_v"] = buf.k, buf.v

    win = onesided.Window(comm, w).fence()
    out["rget"] = win.rget([(2, 0), (0, 3)]).get()
    win.fence()

    # REPLACE-then-SUM is order-observable: issue order gives 5 + n
    win = onesided.Window(comm, torch.zeros(4)).fence()
    f1 = win.raccumulate(torch.full((4,), 5.0), target=2, op=ReduceOp.REPLACE)
    f2 = f1.then(lambda f: (f.get(), win.raccumulate(torch.ones(4), target=2,
                                                     op=ReduceOp.SUM).get())[1])
    futures.when_all([f2]).get()
    out["order_buffer"] = win.fence().buffer

    win = onesided.Window(comm, torch.zeros(4)).fence()
    win.accumulate(x + 10.0, target=3, op=ReduceOp.REPLACE)
    out["replace_buffer"] = win.fence().buffer

    win = onesided.Window(comm, torch.zeros(8)).fence()
    win.put(torch.full((8,), 1.0), [(0, 3)], page=(0, 2))
    win.put(torch.full((8,), 2.0), [(1, 3)], page=(1, 2))
    out["ledger_error"] = torch.tensor(_err(lambda: win.put(torch.full((8,), 3.0), [(2, 3)]))
                                       == "ERR_RANK")
    win.fence()
    win.fence()   # a fresh epoch: the ledger is cleared
    win.put(torch.full((8,), 4.0), [(2, 3)])
    out["ledger_buffer"] = win.fence().buffer

    win = onesided.Window(comm, w).fence()
    win.put(x, [])
    out["empty_buffer"] = win.fence().buffer

    win = onesided.Window(comm, torch.zeros(8), WindowSpec(dynamic=True, num_pages=4))
    win.attach([1, 2]).fence()
    win.put(torch.arange(8.0) + rank, [(0, 2)], page=1)
    out["dynamic_error"] = torch.tensor(_err(
        lambda: win.put(torch.arange(8.0), [(1, 2)], page=3)) == "ERR_RMA_RANGE")
    win.fence()
    win.detach([1])
    out["dynamic_buffer"] = win.buffer
    out["dynamic_attached"] = torch.tensor(sorted(win.attached_pages))
    return {k: v.numpy() for k, v in out.items()}


#: prog_neighbors' distributed graphs on 4 ranks: (sources, destinations)
NEIGHBOR_GRAPHS = {
    # a fan-in star (everyone -> rank 0) plus a chain edge 0 -> 1:
    # asymmetric in/out degrees
    "star": ([[1, 2, 3], [0], [], []], [[1], [0], [0], [0]]),
    # a ring with PROC_NULL placeholder slots
    "ring_null": ([[3, -1], [0], [1], [2]], [[1], [2], [3], [0, -1]]),
    # every rank neighbors every rank, in rank order
    "full": ([[0, 1, 2, 3]] * 4, [[0, 1, 2, 3]] * 4),
}

#: prog_neighbors' neighbor_alltoallv counts on the full graph (rank x slot)
FULL_COUNTS = [[3, 1, 2, 0], [2, 2, 2, 2], [0, 3, 1, 1], [1, 0, 3, 2]]


def prog_neighbors(rank: int, world: int, inputs: dict) -> dict:
    """The neighborhood collectives on this rank's slice of the inputs: a
    2 x 2 cart (periodic rows, non-periodic columns), the graphs of
    ``NEIGHBOR_GRAPHS``, a size-2 periodic cart over ranks 0 and 1, and the
    persistent form on a periodic ring of 4 (every rank the same value)."""

    import torch

    from repro_torch.core import topology
    from repro_torch.core.communicator import world as world_comm

    comm = world_comm(device_type="cpu")
    x = torch.from_numpy(inputs["x"][rank])            # (3,)
    blocks = torch.from_numpy(inputs["blocks"][rank])  # (4, 3, 2)
    out = {}
    cart = topology.cart_create(comm, (2, 2), (True, False), axis_names=("row", "col"))
    out["cart_allgather"] = cart.neighbor_allgather(x).get()
    out["cart_alltoall"] = cart.neighbor_alltoall(blocks[:, 0]).get()
    out["cart_alltoallv"], out["cart_alltoallv_rc"] = cart.neighbor_alltoallv(
        blocks, [[3, 1, 2, 0], [1, 1, 1, 1], [2, 0, 3, 1], [0, 2, 2, 3]]).get()
    for name, (srcs, dsts) in NEIGHBOR_GRAPHS.items():
        g = topology.dist_graph_create_adjacent(comm, srcs, dsts)
        out[f"{name}_degrees"] = torch.tensor([g.indegree(rank), g.outdegree(rank),
                                               g.indegree(), g.outdegree()])
        out[f"{name}_allgather"] = g.neighbor_allgather(x).get()
        out[f"{name}_alltoall"] = g.neighbor_alltoall(
            blocks[: g.outdegree(), 0] + 1.0 + rank).get()
    full = topology.dist_graph_create_adjacent(comm, *NEIGHBOR_GRAPHS["full"])
    out["full_alltoallv"], out["full_alltoallv_rc"] = full.neighbor_alltoallv(
        blocks, FULL_COUNTS).get()
    pair = topology.cart_create(comm.group().incl([0, 1]), (2,), (True,))
    if rank < 2:
        two = torch.arange(6.0).reshape(2, 3) + 1.0 + 10.0 * rank
        got, rc = pair.neighbor_alltoallv(two[..., None], [3, 1]).get()
        out["pair_alltoallv"], out["pair_rc"] = got[..., 0], rc
    ring = topology.cart_create(comm, (world,), (True,), tag="repro://cart/ring4")
    req = ring.neighbor_alltoall_init(torch.zeros((2, 8)))
    for i in range(2):
        out[f"persistent_{i}"] = req.start(torch.from_numpy(inputs["same"][i])).get()
    out["persistent_starts"] = torch.tensor(req.starts)
    return {k: v.numpy() for k, v in out.items()}


def prog_moe_neighbor(rank: int, world: int, inputs: dict) -> dict:
    """``moe_neighbor`` on this rank's tokens and expert slice of the
    reference's MoE weights: the full expert graph, radius 1, and radius 1
    at a capacity that drops rows."""

    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import topology
    from repro_torch.core.communicator import world as world_comm
    from repro_torch.models import mlp

    comm = world_comm(device_type="cpu")
    cfg = ModelConfig(name="t", family="moe", num_layers=2, d_model=16, num_heads=2,
                      num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                      num_experts=2 * world, moe_top_k=2, moe_d_ff=24)
    el = cfg.num_experts // world
    p = {"router": torch.from_numpy(inputs["router"])}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = torch.from_numpy(inputs[k][rank * el:(rank + 1) * el])
    t = inputs["x"].shape[0] // world
    x = torch.from_numpy(inputs["x"][rank * t:(rank + 1) * t])
    out = {}
    for name, radius, capacity in (("full", None, None), ("r1", 1, None), ("r1_cap", 1, 3)):
        g = topology.dist_graph_create_adjacent(
            comm, *mlp.expert_dispatch_graph(world, cfg.num_experts, radius=radius))
        y, aux = mlp.moe_neighbor(p, x, cfg, g, capacity=capacity)
        out[f"{name}_y"] = y
        for k, v in aux.items():
            out[f"{name}_{k}"] = v
    g0 = topology.dist_graph_create_adjacent(
        comm, *mlp.expert_dispatch_graph(world, world, radius=0))
    cfg1 = ModelConfig(name="t1", family="moe", num_layers=2, d_model=16, num_heads=2,
                       num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                       num_experts=world, moe_top_k=2, moe_d_ff=24)
    p1 = {"router": torch.zeros(16, world), "w_gate": torch.zeros(1, 16, 24),
          "w_up": torch.zeros(1, 16, 24), "w_down": torch.zeros(1, 24, 16)}
    out["narrow_graph_error"] = torch.tensor(
        _err(lambda: mlp.moe_neighbor(p1, x, cfg1, g0)) == "ERR_TOPOLOGY")
    return {k: v.numpy() for k, v in out.items()}


#: prog_disagg's cases: (name, config, kv cache dtype, split keyword, kv_pages)
DISAGG_CASES = (("paired", "tiny", "bfloat16", {"prefill_fraction": 0.5}, 3),
                ("fanout", "tiny", "bfloat16", {"fanout": (1, 3)}, 3),
                ("gemma2_int8", "gemma2_9b", "int8", {"prefill_fraction": 0.5}, 2))

#: the pvars the disaggregated server's tests compare
DISAGG_PVARS = ("trace:kv_transfer", "trace:prefill_step", "trace:decode_step",
                "rma_fence", "rma_rput", "rma_put", "rma_get")


# ---------------------------------------------------------------------------
# placed (DTensor) serving, training and checkpoints on a 2 x 2 grid
# ---------------------------------------------------------------------------

SHARDED_ARCHS = ("phi4_mini_3_8b", "deepseek_v2_236b", "mamba2_2_7b")


def _prefixed(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)}


def prog_sharded_serve(rank: int, world: int, inputs: dict) -> dict:
    """The dense, MLA + MoE and SSM smoke models in fp32, served by a 2 x 2
    placed ``Server`` on the reference's weights: tokens and the prefill's
    last logits; for phi4-mini also the first decode step's logits with the
    sequence-sharded merged decode, with the fp32 and the int8 cache."""

    import torch

    from repro_torch.configs import base
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Request, Server, ServerConfig
    from repro_torch.sharding import rules

    comm = make_host_communicator(2, 2, device="cpu")
    mesh = comm.device_mesh
    out = {}
    prompts = [inputs["prompt0"], inputs["prompt1"]]
    for arch in SHARDED_ARCHS:
        cfg = dataclasses.replace(base.get_smoke_config(arch), dtype="float32")
        pcfg = base.get_parallel(arch)
        variants = [("", pcfg)]
        if arch == "phi4_mini_3_8b":
            merged = dataclasses.replace(pcfg, seq_shard_cache=True, flash_decode_merge=True)
            variants += [("merge/", merged),
                         ("int8/", dataclasses.replace(merged, kv_cache_dtype="int8"))]
        params = _params(_prefixed(inputs, arch + "/"))
        for tag, pc in variants:
            server = Server(cfg, pc, ServerConfig(max_batch=2, max_new_tokens=4), comm)
            with torch.inference_mode():
                server.params = rules.distribute(
                    params, rules.param_specs(params, rules.mesh_shape(mesh), pc), mesh)
            assert server.placed
            batch, _ = server._pad_batch([Request(tokens=p.copy()) for p in prompts])
            with torch.inference_mode():
                logits, cache = server._prefill_request(batch)(server.params, batch)
                tok = server._sample(logits, None)[:, None]
                dec, _ = server._decode_request(cache, tok)(server.params, cache, tok)
                out[f"{arch}/{tag}prefill"] = logits.full_tensor().numpy()
                out[f"{arch}/{tag}decode"] = dec.full_tensor().numpy()
            out[f"{arch}/{tag}tokens"], _ = server.generate(
                [Request(tokens=p.copy()) for p in prompts])
    return out


def _tiny_cfg():
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
                       dtype="float32")


def prog_sharded_train(rank: int, world: int, inputs: dict) -> dict:
    """The tiny dense model trained 4 steps on 2 x 2 ranks under the plan
    (data 2, tensor 2), from the reference's init, with fp32 and int8
    moments; with fp32 moments it checkpoints at step 4 (fragments from
    every rank)."""

    import torch

    from repro_torch.configs.base import ParallelConfig, ParallelPlan
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    out = {}
    for moments in ("float32", "int8"):
        ckpt = inputs["ckpt_dir"].item() if moments == "float32" else None
        tcfg = TrainerConfig(steps=4, lr=1e-3, warmup_steps=2, log_every=1,
                             plan=ParallelPlan(data=2, tensor=2), checkpoint_dir=ckpt,
                             checkpoint_every=4)
        trainer = Trainer(_tiny_cfg(), dataclasses.replace(
            ParallelConfig(remat="full"), moment_dtype=moments), tcfg,
            make_host_communicator(device="cpu"), seq_len=32, global_batch=4,
            clock=lambda: 0.0)
        trainer.init_state = lambda t=trainer: t.place_state(_params(inputs))
        result = trainer.run()
        out[f"{moments}/losses"] = np.array([m["loss"] for m in result["metrics"]])
        out[f"{moments}/grad_norms"] = np.array([m["grad_norm"] for m in result["metrics"]])
        out[f"{moments}/shape"] = np.array(trainer.comm.shape)
        out[f"{moments}/params"] = torch.cat(
            [_whole(p).detach().reshape(-1) for p in _leaves(trainer.params)]).numpy()
        out[f"{moments}/placed"] = np.array(trainer.placed)
    return out


def prog_int8_plans(rank: int, world: int, inputs: dict) -> dict:
    """The tiny dense model with int8 moments from the seed's init,
    ``steps`` steps on 2 x 2 ranks under the plan (data 2, tensor 2) and,
    on the same ranks, under the data plan (whole state on every rank):
    after each step, each plan's gradients (clipping's input) and stored
    moments (int8 payloads and fp32 scales), whole, and which leaves have
    their last axis split under the first plan."""

    import torch

    from repro_torch.configs.base import ParallelConfig, ParallelPlan
    from repro_torch.core.futures import flatten
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime import trainer as trainer_mod
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    steps = int(inputs["steps"])
    clip = trainer_mod.clip_by_global_norm
    out = {}
    for name, plan in (("tensor", ParallelPlan(data=2, tensor=2)), ("data", None)):
        tcfg = TrainerConfig(steps=steps, lr=1e-3, warmup_steps=2, log_every=1, plan=plan)
        trainer = Trainer(_tiny_cfg(), ParallelConfig(remat="full", moment_dtype="int8"), tcfg,
                          make_host_communicator(device="cpu"), seq_len=32, global_batch=4,
                          clock=lambda: 0.0)
        trainer.placed = plan is not None
        grads, moments = [], []

        def record_grads(g, norm, grads=grads):
            grads.append([_whole(x).detach().clone() for x in flatten(g)[0]])
            return clip(g, norm)

        def record_update(g, state, params, update=trainer.opt.update, moments=moments):
            params, state = update(g, state, params)
            moments.append([_whole(x).detach().clone() for x in flatten((state.mu, state.nu))[0]])
            return params, state

        trainer_mod.clip_by_global_norm = record_grads
        object.__setattr__(trainer.opt, "update", record_update)
        try:
            result = trainer.run()
        finally:
            trainer_mod.clip_by_global_norm = clip
        out[f"{name}/grad_norms"] = np.array([m["grad_norm"] for m in result["metrics"]])
        for i in range(steps):
            for j, g in enumerate(grads[i]):
                out[f"{name}/{i}/g{j}"] = g.numpy()
            for j, z in enumerate(moments[i]):
                out[f"{name}/{i}/z{j}"] = z.numpy()
        if plan is not None:
            leaves = flatten(trainer.params)[0]
            out["split"] = np.array([
                any(pl.is_shard(p.ndim - 1) and p.device_mesh.size(d) > 1
                    for d, pl in enumerate(p.placements)) for p in leaves])
    return out


#: the plans of the ring and pipeline trainer tests: (seq, global batch,
#: ParallelPlan kwargs, model config kwargs); the ring's model is the
#: reference's ``TRAINER_RING`` one, the pipeline's its pipeline trainer's
TRAIN_PLANS = {
    "ring": (96, 8, dict(ring=2), dict(num_kv_heads=4, vocab_size=256)),
    "pipeline": (64, 8, dict(stage=2, microbatches=2), dict(num_kv_heads=2, vocab_size=128)),
}


def train_plan_cfg(name: str):
    """The port's model config of a :data:`TRAIN_PLANS` entry."""

    from repro_torch.configs.base import ModelConfig

    return ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                       head_dim=16, d_ff=128, dtype="float32", **TRAIN_PLANS[name][3])


def prog_train_plans(rank: int, world: int, inputs: dict) -> dict:
    """The ring plan (data 2, ring 2) and the pipeline plan (data 2, stage
    2, micro 2) of the port's ``Trainer`` on 4 ranks, 3 steps each from the
    reference's init (``<plan>/param/...``): losses, grad norms, the
    folded communicator and the parameters after the last step, whole; the
    pipeline checkpoints its last step (fragments from every rank) into
    ``ckpt_dir``.  Then the error of building the plan's step for a CUDA
    device (its capture is refused) and its message, and the plan's losses
    through the eager step (``persistent=False``)."""

    import torch

    from repro_torch.configs.base import ParallelConfig, ParallelPlan
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    out = {}
    for name, (seq, batch, plan, _) in TRAIN_PLANS.items():
        ckpt = inputs["ckpt_dir"].item() if name == "pipeline" else None
        tcfg = TrainerConfig(steps=3, log_every=1, plan=ParallelPlan(**plan),
                             checkpoint_dir=ckpt, checkpoint_every=3)
        trainer = Trainer(train_plan_cfg(name), ParallelConfig(), tcfg,
                          make_host_communicator(device="cpu"), seq_len=seq,
                          global_batch=batch, clock=lambda: 0.0)
        trainer.init_state = lambda t=trainer, n=name: t.place_state(
            _params(_prefixed(inputs, n + "/")))
        result = trainer.run()
        out[f"{name}/losses"] = np.array([m["loss"] for m in result["metrics"]])
        out[f"{name}/grad_norms"] = np.array([m["grad_norm"] for m in result["metrics"]])
        out[f"{name}/dims"] = np.array(trainer.comm.shape)
        out[f"{name}/axes"] = np.array(trainer.comm.axis_names)
        out[f"{name}/periods"] = np.array(trainer.comm.periods)
        out[f"{name}/ring_attention"] = np.array(trainer.pcfg.ring_attention)
        out[f"{name}/placed"] = np.array(trainer.placed)
        out[f"{name}/params"] = torch.cat(
            [_whole(p).detach().reshape(-1) for p in _leaves(trainer.params)]).numpy()
        # the same plan's step, as the card would capture it, is refused
        card = Trainer(train_plan_cfg(name), ParallelConfig(), TrainerConfig(
            steps=1, plan=ParallelPlan(**plan)), make_host_communicator(device="cpu"),
            seq_len=seq, global_batch=batch)
        state = card.init_state()
        card.device = torch.device("cuda")
        out[f"{name}/card_error"] = np.array(_err(lambda: card.compile(*state)))
        try:
            card.compile(*state)
        except Exception as e:  # noqa: BLE001  (the message is what is held)
            out[f"{name}/card_message"] = np.array(str(e))
        # with NCCL's registration of captured buffers off (what a cuda
        # session sets), the card captures the step
        os.environ["NCCL_GRAPH_REGISTER"] = "0"
        try:
            out[f"{name}/card_lifted"] = np.array(_err(card._check_capturable))
        finally:
            del os.environ["NCCL_GRAPH_REGISTER"]
        # the eager step (persistent=False), the plan's way on the card
        eager = Trainer(train_plan_cfg(name), ParallelConfig(), dataclasses.replace(
            tcfg, checkpoint_dir=None, persistent=False), make_host_communicator(device="cpu"),
            seq_len=seq, global_batch=batch, clock=lambda: 0.0)
        eager.init_state = lambda t=eager, n=name: t.place_state(
            _params(_prefixed(inputs, n + "/")))
        result = eager.run()
        out[f"{name}/eager_losses"] = np.array([m["loss"] for m in result["metrics"]])
        out[f"{name}/eager_request"] = np.array(eager._request is None)
    return out


def prog_sharded_restore(rank: int, world: int, inputs: dict) -> dict:
    """The reference's checkpoint (``ckpt_dir``) restored into the placed
    state of a 2 x 2 ``Trainer``: each leaf's whole value."""

    import torch

    from repro_torch.configs.base import ParallelConfig, ParallelPlan
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(steps=1, plan=ParallelPlan(data=2, tensor=2),
                         checkpoint_dir=inputs["ckpt_dir"].item())
    trainer = Trainer(_tiny_cfg(), ParallelConfig(), tcfg, make_host_communicator(device="cpu"),
                      seq_len=32, global_batch=4, clock=lambda: 0.0)
    params, opt_state = trainer.init_state()
    params, opt_state, step = trainer._restore(params, opt_state)
    from repro_torch.core.futures import flatten

    leaves = flatten({"params": params, "opt": opt_state})[0]
    return {"step": np.array(step),
            "placed": np.array(all(hasattr(t, "full_tensor") for t in leaves)),
            "values": torch.cat([_whole(t).detach().float().reshape(-1)
                                 for t in leaves]).numpy()}


def prog_rows_split(rank: int, world: int, inputs: dict) -> dict:
    """Three ranks on a 3 x 1 grid: the ``Server`` the mesh selects (whole
    weights: the model axis is one rank) serving 2 and 3 prompts; the same
    weights placed by the caller, serving the 2 rows the data axis does not
    split (replicated over it) and the 3 it does; a placed ``Trainer`` at a
    global batch of 2, its losses and grad norms."""

    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Request, Server, ServerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding import rules

    comm = make_host_communicator(world, 1, device="cpu")
    pcfg = ParallelConfig()
    server = Server(_tiny_cfg(), pcfg, ServerConfig(max_batch=3, max_new_tokens=4), comm)
    prompts = [Request(tokens=inputs[f"prompt{i}"].copy()) for i in range(3)]
    out = {"placed_by_mesh": np.array(server.placed)}
    out["whole2"], _ = server.generate(prompts[:2])
    out["whole3"], _ = server.generate(prompts[:3])
    mesh = comm.device_mesh
    with torch.inference_mode():
        server.params = rules.distribute(
            server.params, rules.param_specs(server.params, rules.mesh_shape(mesh), pcfg), mesh)
    server._prefill_reqs.clear()   # built on the whole weights
    server._decode_reqs.clear()
    out["placed"] = np.array(server.placed)
    out["placed2"], _ = server.generate(prompts[:2])
    out["placed3"], _ = server.generate(prompts[:3])
    trainer = Trainer(_tiny_cfg(), pcfg, TrainerConfig(steps=2, lr=1e-3, log_every=1),
                      make_host_communicator(device="cpu"), seq_len=16, global_batch=2,
                      clock=lambda: 0.0)
    result = trainer.run()
    out["trainer_placed"] = np.array(trainer.placed)
    out["trainer_losses"] = np.array([m["loss"] for m in result["metrics"]])
    out["trainer_grad_norms"] = np.array([m["grad_norm"] for m in result["metrics"]])
    return out


def prog_split_rows_update(rank: int, world: int, inputs: dict) -> dict:
    """AdamW with int8 moments on a leaf whose last axis is split over two
    ranks (mesh 1 x 2), in pieces of two whole rows (``PIECE`` cut to 32
    elements): the whole parameter and moments after ``steps`` updates,
    and the same updates of the whole leaf on this rank alone."""

    import torch

    from repro_torch.core.futures import flatten
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules

    adamw.PIECE = 32
    mesh = make_host_communicator(1, world, device="cpu").device_mesh
    opt = adamw.AdamW(lr=1e-2, moment_dtype="int8")
    whole = {"w": torch.from_numpy(inputs["w"].copy())}
    placed = rules.distribute({"w": whole["w"].clone()}, {"w": (None, "model")}, mesh)
    state_w, state_p = opt.init(whole), opt.init(placed)   # moments placed as "w"
    for i in range(int(inputs["steps"])):
        g = torch.from_numpy(inputs[f"g{i}"].copy())
        opt.update({"w": g}, state_w, whole)
        opt.update(rules.distribute({"w": g.clone()}, {"w": (None, "model")}, mesh),
                   state_p, placed)
    got = [t.full_tensor() if hasattr(t, "full_tensor") else t
           for t in flatten((placed, state_p))[0]]
    want = flatten((whole, state_w))[0]
    return {f"got{i}": t.numpy() for i, t in enumerate(got)} | {
        f"want{i}": t.numpy() for i, t in enumerate(want)}


def prog_overlap(rank: int, world: int, inputs: dict) -> dict:
    """``merge_partial_attention`` of shard ``rank`` over 4 ranks and, on
    each line of a 2 x 2 grid, of shard ``rank % 2`` over 2; and the cases
    of the reference's ``tests/test_overlap.py`` for ``all_gather_matmul``
    and ``matmul_reduce_scatter`` (4 ranks, fused against plain)."""

    import torch

    from repro_torch.core import collectives, overlap
    from repro_torch.launch.mesh import make_host_communicator

    ring = make_host_communicator(4, 1, device="cpu").split("data")
    grid = make_host_communicator(2, 2, device="cpu")
    pairs = grid.split("model")
    out = {}
    for n, comm, shard in ((4, ring, rank), (2, pairs, rank % 2)):
        o, m, l_ = (torch.from_numpy(inputs[f"{k}{n}"][shard]) for k in "oml")
        out[f"merge{n}"] = overlap.merge_partial_attention(o, m, l_, comm).numpy()
    n = 4
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 16 * n), generator=gen)
    w_shards = torch.randn((n, 16, 8), generator=gen) * torch.arange(1.0, n + 1)[:, None, None]
    out["agmm"] = overlap.all_gather_matmul(ring, x, w_shards[rank]).numpy()
    w_full = collectives.allgather(ring, w_shards[rank]).reshape(16 * n, 8)
    out["agmm_plain"] = (x @ w_full).numpy()
    x_r = torch.randn((n, 4, 16), generator=gen)[rank] * (rank + 1.0)
    w_r = torch.randn((n, 16, 8), generator=gen)[rank] * (rank + 1.0)
    out["mmrs"] = overlap.matmul_reduce_scatter(ring, x_r, w_r).numpy()
    full = collectives.allreduce(ring, x_r @ w_r)
    blk = full.shape[-1] // n
    out["mmrs_plain"] = full[:, rank * blk:(rank + 1) * blk].numpy()
    # the sp plan's query-block constraint (the chunked form on DTensors,
    # batch over data): the output's query blocks split over model
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ref
    from repro_torch.sharding.local import implicit_replication

    q, k, v = (torch.randn(shape, generator=gen) for shape in
               ((2, 64, 4, 8), (2, 64, 2, 8), (2, 64, 2, 8)))
    placed = [distribute_tensor(t, grid.device_mesh, [Shard(0), Replicate()],
                                src_data_rank=None) for t in (q, k, v)]
    with implicit_replication():
        sp = ref.chunked_mha(*placed, q_block=16, k_block=16, q_block_axis="model")
    out["sp"] = sp.full_tensor().numpy()
    out["sp_plain"] = ref.mha(q, k, v).numpy()
    out["sp_placements"] = np.array([str(p) for p in sp.placements])
    return out


def disagg_config(name: str, module):
    """The config of a DISAGG_CASES entry, from ``module`` (either
    package's ``configs.base``): the reference test's tiny fp32 model, or a
    smoke config in fp32."""

    if name == "tiny":
        return module.ModelConfig(name="tiny", family="dense", num_layers=2, d_model=32,
                                  num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                                  vocab_size=64, dtype="float32")
    return dataclasses.replace(module.get_smoke_config(name), dtype="float32")


def prog_disagg(rank: int, world: int, inputs: dict) -> dict:
    """``DisaggregatedServer`` on every rank for each case of
    ``DISAGG_CASES``, on the reference's weights: two ``generate``s, their
    tokens, the transfer stats and the pvars they counted."""

    from repro_torch.configs import base
    from repro_torch.core import tool
    from repro_torch.runtime.server import DisaggregatedServer, Request, ServerConfig

    out = {}
    for name, arch, kv, split, pages in DISAGG_CASES:
        cfg = disagg_config(arch, base)
        pcfg = dataclasses.replace(
            base.get_parallel(arch) if arch != "tiny" else base.ParallelConfig(),
            kv_cache_dtype=kv)
        params = _params({k[len(arch) + 1:]: v for k, v in inputs.items()
                          if k.startswith(f"{arch}/")})
        tool.pvar_reset()
        dis = DisaggregatedServer(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=6),
                                  kv_pages=pages, device="cpu", **split)
        for srv in (dis.prefill, dis.decode):
            if srv is not None:
                srv.params = params
        reqs = [Request(tokens=inputs[f"{arch}_prompt{i}"].copy()) for i in range(2)]
        for i in range(2):
            out[f"{name}_tokens{i}"], stats = dis.generate(reqs)
        counts = tool.pvar_read()
        out[f"{name}_pvars"] = np.array([counts.get(k, 0) for k in DISAGG_PVARS])
        out[f"{name}_stats"] = np.array([stats["kv_bytes"], stats["kv_pages"],
                                         stats["prefill_devices"], stats["decode_devices"]])
        out[f"{name}_roles"] = np.array([dis.prefill is not None, dis.decode is not None])
    return out


def prog_serve_mesh(rank: int, world: int, inputs: dict) -> dict:
    """The serve CLI with ``--mesh`` (``inputs["mesh"]``) on every rank:
    its tokens, and whether its weights are placed."""

    from repro_torch.launch import serve

    server, tokens, _ = serve.run(["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu",
                                   "--mesh", str(inputs["mesh"]), "--requests", "2",
                                   "--prompt-len", "8", "--new-tokens", "4"])
    return {"tokens": tokens, "placed": np.array(server.placed)}


def prog_serve_cb_mesh(rank: int, world: int, inputs: dict) -> dict:
    """The serve CLI with ``--continuous-batching`` and ``--mesh``
    (``inputs["mesh"]``) on every rank: each request's generated tokens,
    and whether the server's weights are placed."""

    from repro_torch.launch import serve

    server, tokens, _ = serve.run(["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu",
                                   "--mesh", str(inputs["mesh"]), "--continuous-batching",
                                   "--requests", "6", "--prompt-len", "8",
                                   "--new-tokens", "4"])
    return {"lengths": np.array([len(t) for t in tokens]), "tokens": np.array(tokens),
            "placed": np.array(server.placed)}


def prog_ring_placed_elastic(rank: int, world: int, inputs: dict) -> dict:
    """The ring plan (ring 2) with its state placed on 4 ranks through an
    eviction (rank 1 before step 3: the 3 survivors fold one ring of 2, the
    third idles, and the step-2 manifest is restored onto it) and an
    admission (before step 5: back to (2, 2), the live state gathered and
    placed again), 6 steps: the run's result, losses and final state."""

    import torch

    from repro_torch.configs.base import ParallelConfig, ParallelPlan
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    seq, batch, plan, _ = TRAIN_PLANS["ring"]
    tcfg = TrainerConfig(steps=6, log_every=1, plan=ParallelPlan(**plan),
                         checkpoint_dir=inputs["ckpt_dir"].item(), checkpoint_every=2)
    t = Trainer(train_plan_cfg("ring"), ParallelConfig(), tcfg,
                make_host_communicator(device="cpu"), seq_len=seq, global_batch=batch,
                injector=FaultInjector().evict_rank(3, 1).admit_rank(5), clock=lambda: 0.0)
    t.init_state = lambda: t.place_state(_params(inputs))
    res = t.run()
    out = {k: np.array(res[k]) for k in ("final_step", "evictions", "joins", "epoch",
                                         "world_size")}
    out["steps"] = np.array([m["step"] for m in res["metrics"]])
    out["losses"] = np.array([m["loss"] for m in res["metrics"]])
    out["dims"] = np.array(t.comm.shape)
    out["placed"] = np.array(all(hasattr(p, "device_mesh") for p in _leaves(t.params)))
    out["params"] = torch.cat([_whole(p).detach().reshape(-1) for p in _leaves(t.params)]).numpy()
    return out


def prog_train_cli(rank: int, world: int, inputs: dict) -> dict:
    """The train CLI with ``inputs["argv"]`` on every rank: its losses and
    grad norms, the folded grid, and whether the state is placed."""

    from repro_torch.launch import train

    trainer, result = train.run([str(a) for a in inputs["argv"]])
    return {"losses": np.array([m["loss"] for m in result["metrics"]]),
            "grad_norms": np.array([m["grad_norm"] for m in result["metrics"]]),
            "dims": np.array(trainer.comm.shape), "placed": np.array(trainer.placed)}


def prog_serve_fanout(rank: int, world: int, inputs: dict) -> dict:
    """The serve CLI with ``--fanout 1:3`` on every rank: its tokens and
    its stats' keys."""

    from repro_torch.launch import serve

    _, tokens, stats = serve.run(["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu",
                                  "--fanout", "1:3", "--requests", "2", "--prompt-len", "8",
                                  "--new-tokens", "4"])
    return {"tokens": tokens, "keys": np.array(sorted(stats))}


#: the splits of the (pod 2, data 2, model 1) grid that the session test
#: holds against the reference's: proper subsets, one axis, all axes in
#: another order
SPLIT_AXES = (("data", "model"), ("model", "pod"), ("pod", "data"), ("pod",),
              ("model", "pod", "data"))


def prog_session_calls(rank: int, world: int, inputs: dict) -> dict:
    """The session and communicator calls of ``tests/test_session.py``
    that the elastic epochs build on: ``split`` over one axis and over
    subsets of a 3-axis grid (this rank's color, its shape and an allreduce
    over it), ``register_mesh_psets``, ``create``, ``dup`` (its own process
    group, an allreduce over it), ``local_ranks``, ``Session.refresh`` with
    members that appear and vanish, and ``default_session(refresh=True)``
    in place."""

    import torch

    from repro_torch.core.communicator import Communicator, local_ranks
    from repro_torch.core.session import (
        Group,
        GroupComparison,
        RankDevice,
        Session,
        default_session,
    )

    out = {}
    sess = default_session(device_type="cpu")
    wg = sess.group("repro://world")
    comm = Communicator.from_group(wg, tag="repro://grid", shape=(2, 2),
                                   axis_names=("data", "model"))
    out["split_model"] = np.array(comm.split("model").global_ranks())
    names = sess.register_mesh_psets(comm)
    out["mesh_psets"] = np.array(names)
    for name in names:
        out[f"pset/{name}"] = np.array([m.rank for m in sess.pset(name)])
    grid3 = Communicator.from_group(wg, tag="repro://grid3", shape=(2, 2, 1),
                                    axis_names=("pod", "data", "model"))
    for axes in SPLIT_AXES:
        sub = grid3.split(*axes)
        key = "/".join(axes)
        out[f"split3/{key}/ranks"] = np.array(sub.global_ranks())
        out[f"split3/{key}/shape"] = np.array(sub.shape)
        out[f"split3/{key}/axes"] = np.array(sub.axis_names)
        out[f"split3/{key}/sum"] = sub.allreduce(torch.tensor([float(rank)])).numpy()
    created = Communicator.create((1,), ("w",), devices=sess.pset("repro://world"))
    out["create"] = np.array([created.managed, created.group().size(),
                              created.group().devices[0].rank])
    dup = comm.dup()
    out["dup"] = np.array([dup.group().compare(comm.group()) is GroupComparison.IDENT,
                           dup.managed, dup.process_group() is not comm.process_group(),
                           dup.shape == comm.shape])
    out["dup_sum"] = dup.allreduce(torch.tensor([rank + 1.0])).numpy()
    out["local_ranks"] = local_ranks(comm)
    # members that appear, then vanish: the builtin sets re-derive, the
    # user sets are pruned
    other = Session.init(device_type="cpu")
    real = other.pset("repro://world")
    fakes = tuple(RankDevice(world + i, torch.device("meta")) for i in range(2))
    other.refresh(devices=real + fakes)
    grown = [other.group().size(), other.group("repro://platform/meta").size()]
    other.register_pset("repro://doomed", Group(fakes))
    other.register_pset("repro://mixed", Group([real[0], fakes[0]]))
    other.register_pset("repro://stable", Group([real[0]]))
    other.refresh()
    out["refresh"] = np.array(grown + [
        other.group().size(), "repro://platform/meta" in other.psets(),
        "repro://doomed" in other.psets(), len(other.pset("repro://mixed")),
        len(other.pset("repro://stable")), other.pset("repro://mixed") == (real[0],)])
    sess.register_pset("repro://user", wg.incl([0, 1]))
    again = default_session(refresh=True, device_type="cpu")
    out["in_place"] = np.array([again is sess, "repro://user" in again.psets()])
    return out


#: the elastic tests' model: the reference's ``tests/test_elastic_runtime.py``
#: tiny dense config, in fp32
ELASTIC_CFG = dict(name="tiny", family="dense", num_layers=1, d_model=32, num_heads=2,
                   num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, dtype="float32")
#: the scenarios on a (data 2, model 2) grid: (steps, evictions as (step,
#: rank), admissions as (step, count))
ELASTIC_SCENARIOS = {
    "shrink": (8, ((5, 2),), ()),
    "grow": (10, ((5, 1),), ((8, 1),)),
}


def prog_elastic(rank: int, world: int, inputs: dict) -> dict:
    """The reference's ``SHRINK_CODE``, ``GROW_CODE`` and ``RESHARD_CODE``
    on 4 ranks as a (data 2, model 2) grid, from the reference's init
    (``param/...``): each scenario's result, losses, ``trace:train_step``
    builds and ``elastic:recovery_steps`` on this rank, its manifests'
    tags, and whether the revoked epochs' process groups are gone; the
    shrink's control (a fresh run to step 4, then a fresh trainer on the
    survivors' fold restored from it); a step on a fresh fabric laid out as
    a revoked one; a checkpoint written on the 2 x 2 fabric restored on a
    1 x 2 one."""

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.core import tool
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.session import default_session
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding import rules

    cfg = ModelConfig(**ELASTIC_CFG)
    work = Path(str(inputs["work"]))
    world_group = default_session(device_type="cpu").group("repro://world")

    def comm_for(group, data):
        return Communicator.from_group(group, tag="repro://train", shape=(data, 2),
                                       axis_names=("data", "model"))

    def trainer(ckpt, steps, comm, injector=None):
        tcfg = TrainerConfig(steps=steps, lr=1e-3, checkpoint_dir=str(work / ckpt),
                             checkpoint_every=2, log_every=1, seed=7)
        t = Trainer(cfg, ParallelConfig(), tcfg, comm, seq_len=32, global_batch=12,
                    injector=injector, clock=lambda: 0.0)
        t.init_state = lambda t=t: t.place_state(_params(inputs))
        return t

    def pvar(name):
        return tool.pvar_read().get(name, 0)

    out = {}
    for name, (steps, evictions, admissions) in ELASTIC_SCENARIOS.items():
        injector = FaultInjector()
        for step, r in evictions:
            injector.evict_rank(step, r)
        for step, count in admissions:
            injector.admit_rank(step, count)
        traces, recovery = pvar("trace:train_step"), pvar("elastic:recovery_steps")
        t = trainer(name, steps, comm_for(world_group, 2), injector)
        res = t.run()
        for key in ("final_step", "evictions", "joins", "restarts", "epoch", "world_size"):
            out[f"{name}/{key}"] = np.array(res[key])
        out[f"{name}/member"] = np.array(t.epoch.member)
        out[f"{name}/comm_ranks"] = np.array(t.comm.global_ranks())
        out[f"{name}/traces"] = np.array(pvar("trace:train_step") - traces)
        out[f"{name}/recovery_steps"] = np.array(pvar("elastic:recovery_steps") - recovery)
        out[f"{name}/steps"] = np.array([m["step"] for m in res["metrics"]])
        out[f"{name}/losses"] = np.array([m["loss"] for m in res["metrics"]])
        out[f"{name}/retired"] = np.array([e.generation for e in t.retired])
        destroyed = [pg for e in t.retired for pg in e.destroyed]
        out[f"{name}/destroyed"] = np.array(len(destroyed))
        out[f"{name}/destroyed_gone"] = np.array(
            all(pg not in dist.distributed_c10d._world.pg_map for pg in destroyed))
        out[f"{name}/meta"] = np.array(json.dumps(
            {s: t.ckpt.manifest_meta(s) for s in t.ckpt.steps()}))
        if t.params is not None:
            out[f"{name}/params"] = torch.cat(
                [_whole(p).detach().reshape(-1) for p in _leaves(t.params)]).numpy()
        del t

    # a fresh trainer on the layout of the grow's revoked generation (the
    # (1, 2) fold of ranks 0 and 2, whose groups are destroyed): DTensor's
    # cached sharding decisions must not hand back the destroyed mesh
    comm = comm_for(world_group.incl([0, 2]), 1)
    if comm.rank() >= 0:
        t = Trainer(cfg, ParallelConfig(), TrainerConfig(steps=1, lr=1e-3, seed=7), comm,
                    seq_len=32, global_batch=12, clock=lambda: 0.0)
        out["after_revoke/loss"] = np.array(t.run()["metrics"][0]["loss"])
        del t

    # the shrink's control: a fresh run to the same manifest, then a fresh
    # trainer restored from it on the survivors' fold (rank 2 evicted)
    pre = trainer("control", 4, comm_for(world_group, 2))
    pre.run()
    del pre
    folded = world_group.excl([2]).incl(range(2))
    comm = comm_for(folded, 1)
    if comm.rank() >= 0:
        res = trainer("control", 8, comm).run()
        out["control/steps"] = np.array([m["step"] for m in res["metrics"]])
        out["control/losses"] = np.array([m["loss"] for m in res["metrics"]])

    # a checkpoint written under the 2 x 2 fabric restores onto a 1 x 2 one
    big = comm_for(world_group, 2)
    specs = {"w": ("data", "model"), "b": ()}
    w = torch.arange(96, dtype=torch.float32).reshape(12, 8)
    tree = rules.distribute({"w": w.clone(), "b": torch.tensor(3.0)}, specs, big.device_mesh)
    manager = CheckpointManager(str(work / "reshard"), async_save=False, comm=big)
    manager.save(1, tree, meta={"epoch": 0, "world_size": 4})
    manager.wait()
    out["reshard/meta"] = np.array(json.dumps(manager.manifest_meta()))
    small = comm_for(world_group.excl([1, 3]), 1)
    if small.rank() >= 0:
        template = rules.distribute({"w": torch.zeros(12, 8), "b": torch.tensor(0.0)}, specs,
                                    small.device_mesh)
        got, step = CheckpointManager(str(work / "reshard"), comm=small).restore(template)
        out["reshard/step"] = np.array(step)
        out["reshard/w"] = got["w"].full_tensor().numpy()
        out["reshard/b"] = np.array(float(got["b"].full_tensor()))
        out["reshard/data"] = np.array(got["w"].device_mesh.size(0))
    return out


# ---------------------------------------------------------------------------
# the ring over placed weights, and the engine over a placed server
# ---------------------------------------------------------------------------

#: the reference's ``SERVER_RING`` model (``tests/test_ring_attention.py``)
RING_SERVE_CFG = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, dtype="float32")


def _specs_of(tree) -> list:
    """Per leaf of ``tree``: its placements as a spec, the mesh axes that
    split each dim (``None`` for a whole dim); ``"plain"`` for a tensor
    that is not a DTensor."""

    from repro_torch.core.futures import flatten

    out = []
    for leaf in flatten(tree)[0]:
        if not hasattr(leaf, "device_mesh"):
            out.append("plain")
            continue
        names = leaf.device_mesh.mesh_dim_names
        dims = [[] for _ in range(leaf.dim())]
        for name, pl in zip(names, leaf.placements):
            if pl.is_shard():
                dims[pl.dim].append(name)
        out.append(repr(tuple(tuple(d) if d else None for d in dims)))
    return out


def prog_ring_placed_serve(rank: int, world: int, inputs: dict) -> dict:
    """The ``SERVER_RING`` model with the ring on a ``dims`` grid: the
    server's own parameters (placed, their specs), then the reference's
    weights placed under ``param_specs``: greedy tokens, with the ring and
    without, and the prefill cache's placements."""

    import torch

    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Request, Server, ServerConfig
    from repro_torch.sharding import rules

    comm = make_host_communicator(*[int(d) for d in inputs["dims"]], device="cpu")
    mesh = comm.device_mesh
    cfg = ModelConfig(**RING_SERVE_CFG)
    params = _params(inputs)
    prompts = [Request(tokens=inputs[f"prompt{i}"].copy()) for i in range(2)]
    out = {}
    for tag, pcfg in (("ring", dataclasses.replace(ParallelConfig(), ring_attention=True)),
                      ("base", ParallelConfig())):
        server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=4), comm)
        out[f"{tag}/placed"] = np.array(server.placed)
        out[f"{tag}/specs"] = np.array(_specs_of(server.params))
        with torch.inference_mode():
            server.params = rules.distribute(
                params, rules.param_specs(params, rules.mesh_shape(mesh), pcfg), mesh)
        out[f"{tag}/tokens"], _ = server.generate(prompts)
        if tag == "ring":
            batch, _ = server._pad_batch(prompts)
            with torch.inference_mode():
                _, cache = server._prefill_request(batch)(server.params, batch)
            out["ring/cache_specs"] = np.array(_specs_of(cache))
    return out


def prog_ring_placed_train(rank: int, world: int, inputs: dict) -> dict:
    """The ring plan (data 2, ring 2) of the port's ``Trainer`` with its
    state placed, from the reference's init (``TRAIN_PLANS["ring"]``), 3
    steps, checkpointing the last (fragments from every rank): losses, grad
    norms, each parameter's and moment's spec, the parameters whole; then
    the same through the eager step."""

    import torch

    from repro_torch.configs.base import ParallelConfig, ParallelPlan
    from repro_torch.core import errors
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    seq, batch, plan, _ = TRAIN_PLANS["ring"]
    out = {}
    for tag, persistent in (("", True), ("eager/", False)):
        tcfg = TrainerConfig(steps=3, log_every=1, plan=ParallelPlan(**plan),
                             persistent=persistent, checkpoint_every=3,
                             checkpoint_dir=inputs["ckpt_dir"].item() if persistent else None)
        trainer = Trainer(train_plan_cfg("ring"), ParallelConfig(), tcfg,
                          make_host_communicator(device="cpu"), seq_len=seq,
                          global_batch=batch, clock=lambda: 0.0)
        trainer.init_state = lambda t=trainer: t.place_state(_params(inputs))
        if not tag:
            try:   # the whole state on every ring rank is refused
                trainer.placed = False
            except errors.Error as e:
                out["unplaced_refused"] = np.array(int(e.klass))
        result = trainer.run()
        out[f"{tag}losses"] = np.array([m["loss"] for m in result["metrics"]])
        out[f"{tag}grad_norms"] = np.array([m["grad_norm"] for m in result["metrics"]])
        out[f"{tag}placed"] = np.array(trainer.placed)
        if not tag:
            out["dims"] = np.array(trainer.comm.shape)
            out["ring_attention"] = np.array(trainer.pcfg.ring_attention)
            out["param_specs"] = np.array(_specs_of(trainer.params))
            state = trainer.opt_state
            out["moment_specs"] = np.array(_specs_of((state.mu, state.nu)))
            out["params"] = torch.cat(
                [_whole(p).detach().reshape(-1) for p in _leaves(trainer.params)]).numpy()
    return out


#: phi4-mini's smoke model in fp32 (a tied embedding split four ways, 4
#: query heads over 2 key/value heads) and its parallel config, on a 1 x 4
#: grid: seq, global batch, steps
FOUR_MODEL_RANKS = (64, 2, 3)


def four_model_ranks_cfg():
    """The port's fp32 phi4-mini smoke config and parallel config."""

    from repro_torch.configs import base

    arch = "phi4_mini_3_8b"
    return (dataclasses.replace(base.get_smoke_config(arch), dtype="float32"),
            base.get_parallel(arch))


def prog_four_model_ranks(rank: int, world: int, inputs: dict) -> dict:
    """The ring plan (ring 4) and the tensor plan (tensor 4) of the port's
    ``Trainer`` on 1 x 4 ranks from the reference's init, fp32: losses and
    grad norms; then the ring server on the same grid on the reference's
    weights, placed under ``param_specs``: its greedy tokens."""

    import torch

    from repro_torch.configs.base import ParallelPlan
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.server import Request, Server, ServerConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding import rules

    cfg, pcfg = four_model_ranks_cfg()
    seq, batch, steps = FOUR_MODEL_RANKS
    out = {}
    for name, plan in (("ring", ParallelPlan(ring=4)), ("tensor", ParallelPlan(tensor=4))):
        trainer = Trainer(cfg, pcfg, TrainerConfig(steps=steps, log_every=1, plan=plan),
                          make_host_communicator(device="cpu"), seq_len=seq,
                          global_batch=batch, clock=lambda: 0.0)
        trainer.init_state = lambda t=trainer: t.place_state(_params(inputs))
        result = trainer.run()
        out[f"{name}/losses"] = np.array([m["loss"] for m in result["metrics"]])
        out[f"{name}/grad_norms"] = np.array([m["grad_norm"] for m in result["metrics"]])
        out[f"{name}/dims"] = np.array(trainer.comm.shape)
        out[f"{name}/placed"] = np.array(trainer.placed)
        del trainer, result
    comm = make_host_communicator(1, 4, device="cpu")
    mesh = comm.device_mesh
    pcfg = dataclasses.replace(pcfg, ring_attention=True)
    server = Server(cfg, pcfg, ServerConfig(max_batch=2, max_new_tokens=4), comm)
    params = _params(inputs)
    with torch.inference_mode():
        server.params = rules.distribute(
            params, rules.param_specs(params, rules.mesh_shape(mesh), pcfg), mesh)
    out["serve/placed"] = np.array(server.placed)
    out["serve/tokens"], _ = server.generate(
        [Request(tokens=inputs[f"prompt{i}"].copy()) for i in range(2)])
    return out


#: ``tests/test_engine.py``'s tiny model and its ragged-admission case
ENGINE_CFG = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
                  num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64, dtype="float32")
ENGINE_BUDGETS = (6, 3, 5, 2, 4, 6)


def prog_engine_placed(rank: int, world: int, inputs: dict) -> dict:
    """The engine over a server placed on a ``dims`` grid (its weights the
    reference's, placed under ``param_specs``), bf16 and int8 caches: the
    ragged-admission requests' tokens, the slot table's specs, and the
    decode requests built."""

    import torch

    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.core.futures import flatten
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.engine import EngineConfig, make_engine
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.sharding import rules

    comm = make_host_communicator(*[int(d) for d in inputs["dims"]], device="cpu")
    mesh = comm.device_mesh
    cfg = ModelConfig(**ENGINE_CFG)
    params = _params(inputs)
    prompts = [inputs[f"prompt{i}"] for i in range(len(ENGINE_BUDGETS))]
    out = {}
    for kv in ("bfloat16", "int8"):
        pcfg = ParallelConfig(kv_cache_dtype=kv)
        server = Server(cfg, pcfg, ServerConfig(max_batch=4, max_new_tokens=6), comm)
        out[f"{kv}/placed"] = np.array(server.placed)
        with torch.inference_mode():
            server.params = rules.distribute(
                params, rules.param_specs(params, rules.mesh_shape(mesh), pcfg), mesh)
        eng = make_engine(server, EngineConfig(prompt_bucket=8, block_tokens=4))
        out[f"{kv}/cache_specs"] = np.array(
            _specs_of([t for t in flatten(eng.cache)[0] if t.dim() > 1]))
        handles = [eng.submit(p, max_new=b) for p, b in zip(prompts, ENGINE_BUDGETS)]
        eng.run()
        for i, h in enumerate(handles):
            out[f"{kv}/tokens{i}"] = np.array(h.generated)
        out[f"{kv}/steps"] = np.array(eng.stats()["steps"])
        out[f"{kv}/decode_requests"] = np.array(len(server._decode_reqs))
    return out


def prog_overlap_schedules(rank: int, world: int, inputs: dict) -> dict:
    """The decomposed ring schedules of ``core/overlap.py`` on this rank's
    slice of the inputs: the three rings on axes 0 and 1, the reduce-scatter
    on an axis that does not divide (its error class), the ring gather's
    future (``get``, ``then_matmul``) through ``comm.immediate_ring_allgather``
    and its pvar, the ``immediate_*`` helpers, and the partitioned rings in
    two ``pready`` orders with the reference test's continuation."""

    from repro_torch.core import overlap, tool
    from repro_torch.core.communicator import world as world_comm

    comm = world_comm(device_type="cpu")
    x, y, y1, w, xf, p0, p1 = (torch_from(inputs[k][rank]) for k in
                               ("x", "y", "y1", "w", "xf", "p0", "p1"))
    out = {}
    for a in (0, 1):
        out[f"gather{a}"] = overlap.ring_all_gather(comm, x, axis=a)
        out[f"bidir{a}"] = overlap.ring_all_gather_bidirectional(comm, x, axis=a)
    out["rs0"] = overlap.ring_reduce_scatter(comm, y, axis=0)
    out["rs1"] = overlap.ring_reduce_scatter(comm, y1, axis=1)
    before = tool.pvar_read().get("immediate_ring_allgather", 0)
    out["future_get"] = comm.immediate_ring_allgather(x, axis=1).get()
    fut = comm.immediate_ring_allgather(w)
    out["then_matmul"] = fut.then_matmul(xf).get()
    pvar = tool.pvar_read()["immediate_ring_allgather"] - before
    out["imm_allgather"] = overlap.immediate_all_gather(comm, x).get()
    out["imm_allreduce"] = overlap.immediate_all_reduce(comm, x).get()
    out["imm_reduce_scatter"] = overlap.immediate_reduce_scatter(comm, y, axis=0).get()
    out["imm_send_recv"] = overlap.immediate_send_recv(comm, x, [(0, 2), (2, 1), (1, 0)]).get()
    for name, order in (("a", (1, 0)), ("b", (0, 1))):
        for kind, fn, pay in (("rs", overlap.partitioned_ring_reduce_scatter, (y, p0)),
                              ("ag", overlap.partitioned_ring_all_gather, (x, p1))):
            req = fn(comm, 2, continuation=lambda i, g: g.sum() + i)
            for i in order:
                req.pready(i, pay[i])
            for i, r in enumerate(req.wait()):
                out[f"part_{kind}{i}_{name}"] = r
    result = {k: v.numpy() for k, v in out.items()}
    result["err_rs"] = np.array(_err(lambda: overlap.ring_reduce_scatter(comm, y1, axis=0)))
    result["pvar"] = np.array(pvar)
    return result


def prog_tune_cli(rank: int, world: int, inputs: dict) -> dict:
    """``serve`` and ``train --plan auto`` (``inputs["serve_argv"]``,
    ``["train_argv"]``; phi4-mini's smoke model in fp32) on every rank, on
    the reference's weights (``serve/param/...``, ``train/param/...``): the
    serve CLI's printed plan and tokens, the trainer's plan, grid, losses
    and grad norms."""

    import contextlib
    import dataclasses
    import io

    from repro_torch.configs import base
    from repro_torch.launch import serve, train
    from repro_torch.runtime import server as tserver
    from repro_torch.runtime.trainer import Trainer

    smoke = base.get_smoke_config
    base.get_smoke_config = lambda arch: dataclasses.replace(smoke(arch), dtype="float32")
    generate = tserver.Server.generate

    def on_reference_weights(self, reqs):
        self.params = _params(_prefixed(inputs, "serve/"))
        return generate(self, reqs)

    tserver.Server.generate = on_reference_weights
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, tokens, _ = serve.run([str(a) for a in inputs["serve_argv"]])
    Trainer.init_state = lambda self: self.place_state(_params(_prefixed(inputs, "train/")))
    trainer, result = train.run([str(a) for a in inputs["train_argv"]])
    return {"serve_line": np.array(printed.getvalue().splitlines()[0]), "tokens": tokens,
            "train_plan": np.array(trainer.plan.slug()), "dims": np.array(trainer.comm.shape),
            "placed": np.array(trainer.placed),
            "losses": np.array([m["loss"] for m in result["metrics"]]),
            "grad_norms": np.array([m["grad_norm"] for m in result["metrics"]])}


def prog_dryrun_counts(rank: int, world: int, inputs: dict) -> dict:
    """The dry run's placed train step of smoke phi4-mini (b 4 x 32) on a
    2 x 2 grid of real gloo ranks, over real tensors shaped as its
    stand-ins, counted by the dry run's mode: its collectives; then the
    step's program recorded again (``analysis.hlo.record_program``) and
    read back by ``analyze_hlo``, beside the mode's flops, bytes and
    collectives."""

    import torch

    from repro_torch.analysis.hlo import record_program
    from repro_torch.configs import base
    from repro_torch.core.futures import flatten, unflatten
    from repro_torch.core.hloanalysis import analyze_hlo
    from repro_torch.launch import dryrun, specs, steps
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.optim import AdamW
    from repro_torch.sharding import rules

    arch = "phi4_mini_3_8b"
    cfg, pcfg = base.get_smoke_config(arch), base.get_parallel(arch)
    comm = make_host_communicator(2, 2, device="cpu")
    mesh = comm.device_mesh
    shape = dryrun.shape_config("train_32", 4)
    opt = AdamW(lr=1e-4, moment_dtype=pcfg.moment_dtype)
    kind, (structs, sp) = specs.cell_structs(arch, shape, rules.mesh_shape(mesh), pcfg,
                                             opt=opt, cfg=cfg)
    gen = torch.Generator().manual_seed(int(inputs["seed"]))
    placed = {}
    with torch.no_grad():
        for name, tree in structs.items():
            leaves, treedef = flatten(tree)
            real = [(torch.randn(tuple(x.shape), generator=gen) * 0.02).to(x.dtype)
                    if x.dtype.is_floating_point else torch.zeros(tuple(x.shape), dtype=x.dtype)
                    for x in leaves]
            placed[name] = rules.distribute(unflatten(treedef, real), sp[name], mesh)
    for leaf in flatten(placed["params"])[0]:
        leaf.requires_grad_(True)
    step = steps.make_step(kind, cfg, pcfg, opt)
    with dryrun.DispatchCount() as counted:
        step(*steps.example_args(kind, placed))
    st = counted.collectives
    program = record_program(step, *steps.example_args(kind, placed))
    recorded = analyze_hlo(program.as_text())
    return {"collectives": np.array(json.dumps(
        {"count": dict(st.count), "operand_bytes": dict(st.operand_bytes)}, sort_keys=True)),
        "counted": np.array(json.dumps([counted.flops, counted.bytes, st.as_dict()])),
        "recorded": np.array(json.dumps([recorded.flops, recorded.bytes,
                                         recorded.collectives.as_dict()]))}


def hlo_verdicts(passes, psum, ring, gather, n: int) -> dict:
    """Every pass of ``passes`` (``repro.analysis.hlo`` or the port's) over
    the programs of ``tests/test_analysis_hlo.py`` — an all-reduce, a
    one-step ring permute and an all-gather of the (8·n, 16) fp32 array
    every one of ``n`` ranks holds (the reference's ``spmd`` replicates its
    input) — each on its passing and its failing side, and their
    ``stats_dict`` rows: JSON text, the same in both packages."""

    one_shard = 8 * n * 16 * 4
    verdicts = {
        "no_collective:psum": passes.no_collective(psum, "all-gather", "all-to-all"),
        "no_collective:gather": passes.no_collective(gather, "all-gather"),
        "collective_count:psum_1": passes.collective_count(psum, "all-reduce", 1),
        "collective_count:psum_2": passes.collective_count(psum, "all-reduce", 2),
        "permute_count:ring": passes.permute_count(ring, 1),
        "permute_count:psum": passes.permute_count(psum, 1),
        "identical_lowering:psum_psum": passes.identical_lowering(psum, psum),
        "identical_lowering:psum_gather": passes.identical_lowering(psum, gather),
        "wire_fraction_below:ring_gather": passes.wire_fraction_below(
            ring, gather, 1.0 / (n - 1) + 1e-9),
        "wire_fraction_below:gather_ring": passes.wire_fraction_below(gather, ring, 0.5),
        "neighbor_sparsity:ring": passes.neighbor_sparsity(ring, gather),
        "neighbor_sparsity:psum": passes.neighbor_sparsity(psum, gather),
        "ring_schedule:ring": passes.ring_schedule(ring, 2, shard_bytes=2 * one_shard),
        "ring_schedule:ring_n": passes.ring_schedule(ring, n, shard_bytes=n * one_shard),
        "ring_schedule:gather": passes.ring_schedule(gather, 2),
        "pvar_invariant:one": passes.pvar_invariant({"trace:train_step": 1},
                                                    "trace:train_step", 1),
        "pvar_invariant:two": passes.pvar_invariant({"trace:train_step": 1},
                                                    "trace:train_step", 2),
    }
    rows = {name: [r.name, r.ok, r.detail, bool(r), str(r)] for name, r in verdicts.items()}
    stats = {name: passes.stats_dict(m) for name, m in
             (("psum", psum), ("ring", ring), ("gather", gather))}
    return json.dumps({"verdicts": rows, "stats": stats}, sort_keys=True)


def prog_hlo_passes(rank: int, world: int, inputs: dict) -> dict:
    """The analyzer's passes over this rank's recorded programs: the
    reference test's three programs (:func:`hlo_verdicts`); a persistent
    ``allreduce_init`` against the immediate ``allreduce`` and raw
    ``dist.all_reduce`` on the same group; one forward ``ring_attention``
    on a ring of every rank (16 rows a rank, one key block); the pipeline
    plan's train step (data 2, stage 2, micro 2; every stage sends: stage
    0 its activations, stage 1 its gradients); ``moe_neighbor`` over the
    radius-1 and the full expert graph."""

    import torch
    import torch.distributed as dist

    from repro_torch.analysis import hlo as passes
    from repro_torch.configs.base import ModelConfig, ParallelConfig, ParallelPlan
    from repro_torch.core import topology, tool
    from repro_torch.core.communicator import world as world_comm
    from repro_torch.kernels.ring_attention import ops as ring_ops
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.models import mlp
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    def verdict(r):
        return [r.name, r.ok, r.detail]

    comm = world_comm(device_type="cpu")
    x = torch.from_numpy(inputs["x"][rank])
    out = {"verdicts": np.array(hlo_verdicts(
        passes, passes.record_program(comm.allreduce, x),
        passes.record_program(comm.shift, x, 1), passes.record_program(comm.allgather, x),
        world))}

    # (b) the persistent collective's program, recorded before its first start
    req = comm.allreduce_init(x)
    starts = tool.pvar_read().get("persistent_start", 0)
    immediate = passes.record_program(comm.allreduce, x)
    raw = passes.record_program(dist.all_reduce, x.clone(), group=comm.process_group())
    parity = {"immediate": passes.identical_lowering(req, immediate),
              "raw": passes.identical_lowering(req, raw),
              "gather": passes.identical_lowering(req, passes.record_program(comm.allgather, x))}
    out["parity"] = np.array(json.dumps({k: verdict(r) for k, r in parity.items()}))
    out["parity_starts"] = np.array([req.starts, tool.pvar_read().get("persistent_start", 0)
                                     - starts])

    # (c) one forward ring_attention call
    cart = topology.cart_create(comm, (world,), (True,), axis_names=("ring",))
    q, k, v = (torch.from_numpy(inputs[f"ring_{t}"]) for t in "qkv")
    shard = q.shape[1] // world
    rows = slice(rank * shard, (rank + 1) * shard)
    ring = passes.record_program(ring_ops.ring_attention, cart, q[:, rows], k[:, rows],
                                 v[:, rows], causal=True, global_len=q.shape[1],
                                 block_q=shard, block_k=shard)
    kv_bytes = 2 * k.numel() * k.element_size()
    out["ring"] = np.array(json.dumps({
        "schedule": verdict(passes.ring_schedule(ring, world, shard_bytes=kv_bytes)),
        "schedule_wrong_n": verdict(passes.ring_schedule(ring, world + 1)),
        "stats": passes.stats_dict(ring)}))

    # (d) the pipeline plan's train step (the trainer's step request)
    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32")
    trainer = Trainer(cfg, ParallelConfig(),
                      TrainerConfig(steps=2, log_every=1,
                                    plan=ParallelPlan(stage=2, microbatches=2)),
                      make_host_communicator(device="cpu"), seq_len=64, global_batch=8,
                      clock=lambda: 0.0)
    trainer.run()
    stats = passes.collective_stats(trainer._compiled)
    out["pipeline"] = np.array(json.dumps({
        "counts": dict(stats.count),
        "no_alltoall": verdict(passes.no_collective(trainer._compiled, "all-to-all")),
        "stage": trainer.comm.cart_coords(trainer.comm.rank())[1],
        "recorded_once": trainer._compiled.compiled is trainer._compiled._program,
        "starts": trainer._compiled.starts}))

    # (e) moe_neighbor over the radius-1 and the full expert graph
    mcfg = ModelConfig(name="t", family="moe", num_layers=2, d_model=16, num_heads=2,
                       num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                       num_experts=2 * world, moe_top_k=2, moe_d_ff=24)
    el = mcfg.num_experts // world
    p = {"router": torch.from_numpy(inputs["router"])}
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = torch.from_numpy(inputs[name][rank * el:(rank + 1) * el])
    t = inputs["moe_x"].shape[0] // world
    xm = torch.from_numpy(inputs["moe_x"][rank * t:(rank + 1) * t])
    moe = {}
    for name, radius in (("r1", 1), ("full", None)):
        g = topology.dist_graph_create_adjacent(
            comm, *mlp.expert_dispatch_graph(world, mcfg.num_experts, radius=radius))
        moe[name] = passes.record_program(mlp.moe_neighbor, p, xm, mcfg, g)
    out["moe"] = np.array(json.dumps({
        "counts": dict(passes.collective_stats(moe["r1"]).count),
        "no_alltoall": verdict(passes.no_collective(moe["r1"], "all-to-all")),
        "sparsity": verdict(passes.neighbor_sparsity(moe["r1"], moe["full"])),
        "full_counts": dict(passes.collective_stats(moe["full"]).count)}))
    return out


def prog_placed_repairs(rank: int, world: int, inputs: dict) -> dict:
    """The functions rewritten for ROADMAP C26 and C27 on a 2 x 2 grid,
    each on DTensors placed as the models place them (batch rows over
    data, heads over model), beside their former forms on the same
    DTensors (which torch 2.13's DTensor carries) and on plain tensors:
    the decode attention and the cross-attention (values, and the latter's
    gradients) through ``attention_heads``, the SSD decode step through
    ``ssd_step_heads``, the MoE balance counts through ``counts_over_rows``,
    the ring buffer's roll as a concatenation, and the prefill's
    ``_EntryStack`` against ``torch.stack`` + ``_pad_seq``.  Each result
    whole (``full_tensor``), with its placements."""

    import math

    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import base
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.models import attention, encdec, mlp, transformer
    from repro_torch.sharding import local

    mesh = make_host_communicator(2, 2, device="cpu").device_mesh
    gen = torch.Generator().manual_seed(int(inputs["seed"]))

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    def place(t, *pl):
        return distribute_tensor(t, mesh, list(pl))

    def whole(t):
        return (t.full_tensor() if local.is_dtensor(t) else t).detach().numpy()

    out: dict = {}
    rows_heads = (Shard(0), Shard(2))
    cfg = base.ModelConfig(name="t", family="dense", num_layers=1, d_model=16, num_heads=4,
                           num_kv_heads=2, head_dim=8, d_ff=32, vocab_size=64,
                           attn_logit_softcap=30.0)
    # -- decode attention: as many kv heads as query heads, GQA (2 kv
    # heads) and one kv head (paligemma's); the former form on DTensors
    # only where torch 2.13 can repeat the split kv heads (none to repeat)
    for hk in (4, 2, 1):
        q, kc, vc = randn(2, 1, 4, 8), randn(2, 16, hk, 8), randn(2, 16, hk, 8)
        valid = torch.arange(16)[None, :] <= torch.tensor([[9], [15]])
        pq, pk, pv = place(q, *rows_heads), place(kc, *rows_heads), place(vc, *rows_heads)
        new = local.attention_heads(
            lambda ql, kl, vl, ml: attention._decode_attend(ql, kl, vl, ml, cfg),
            pq, pk, pv, valid)
        plain = attention._decode_attend(q, kc, vc, valid, cfg)
        old = new
        if hk == 4:
            with local.implicit_replication():
                old = attention._decode_attend(pq, pk, pv, valid, cfg)
        out[f"decode{hk}"] = np.stack([whole(new), whole(old), whole(plain)])
        out[f"decode{hk}_placements"] = np.array([str(new.placements), str(old.placements)])

    # -- cross-attention, forward and backward
    p = {"wq": randn(16, 4, 8), "wo": randn(4, 8, 16)}
    h, ek, ev = randn(2, 3, 16), randn(2, 5, 4, 8), randn(2, 5, 4, 8)

    def cross_old(p, h, enc_k, enc_v):
        q = attention._proj(h, p["wq"])
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), enc_k.float()) / math.sqrt(8)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, enc_v.float()).to(h.dtype)
        return attention._out(o, p["wo"])

    grads = []
    for fn, placed in ((encdec._cross_attention, True), (cross_old, True),
                       (encdec._cross_attention, False)):
        args = (h, ek, ev)
        pp = p
        if placed:
            pp = {"wq": place(p["wq"], Replicate(), Shard(1)),
                  "wo": place(p["wo"], Replicate(), Shard(0))}
            args = (place(h, Shard(0), Replicate()), place(ek, *rows_heads),
                    place(ev, *rows_heads))
        args = [a.detach().requires_grad_(True) for a in args]
        with local.implicit_replication():
            y = fn(pp, *args) if fn is cross_old else fn(pp, args[0], args[1], args[2], cfg)
            (y * y).sum().backward()
        grads.append([whole(y)] + [whole(a.grad) for a in args])
    for i, name in enumerate(("cross_y", "cross_dh", "cross_dk", "cross_dv")):
        out[name] = np.stack([g[i] for g in grads])

    # -- the SSD decode step: groups that split (2) and one group (mamba2's,
    # whole on every model rank); the former form on DTensors only where
    # torch 2.13 can repeat the groups (one, not split)
    for g in (2, 1):
        st, x, dt = randn(2, 4, 4, 8), randn(2, 4, 4), randn(2, 4).abs()
        A, B, C = -randn(4).abs(), randn(2, g, 8), randn(2, g, 8)
        hp = (Shard(0), Shard(1))
        gp = hp if g > 1 else (Shard(0), Replicate())
        ps, px, pdt = place(st, *hp), place(x, *hp), place(dt, *hp)
        pA, pB, pC = place(A, Replicate(), Shard(0)), place(B, *gp), place(C, *gp)
        ny, ns = local.ssd_step_heads(ssd_ops.ssd_decode_step, ps, px, pdt, pA, pB, pC)
        oy, os_ = ny, ns
        if g == 1:
            oy, os_ = ssd_ops.ssd_decode_step(ps, px, pdt, pA, pB, pC)
        py, pst = ssd_ops.ssd_decode_step(st, x, dt, A, B, C)
        out[f"ssd{g}_y"] = np.stack([whole(ny), whole(oy), whole(py)])
        out[f"ssd{g}_state"] = np.stack([whole(ns), whole(os_), whole(pst)])
        out[f"ssd{g}_placements"] = np.array([str(ns.placements), str(ps.placements)])

    # -- the MoE balance counts: rows split over both axes, and over data
    e, c = 6, 3
    for name, pl in (("aux_both", (Shard(0), Shard(1))), ("aux_data", (Shard(0), Replicate()))):
        logits = randn(2, 8, e)
        probs = torch.softmax(logits, -1)
        top_e = torch.argsort(-probs, -1)[..., :2]
        slot = torch.randint(0, e * c + 1, (2, 16), generator=gen)
        placed = [place(t, *pl) for t in (logits, probs, top_e, slot)]
        new = mlp._aux(*placed, e, c)

        def old_aux(logits, probs, top_e, slot):
            me = probs.reshape(-1, e).mean(0)
            flat_e = top_e.reshape(-1)
            ce = torch.zeros(e).index_add(0, flat_e, torch.ones(flat_e.shape)) / flat_e.numel()
            return {"load_balance_loss": e * torch.sum(me * ce),
                    "router_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
                    "dropped_fraction": torch.mean((slot == e * c).float())}

        with local.implicit_replication():
            old = old_aux(*placed)
        plain = mlp._aux(logits, probs, top_e, slot, e, c)
        out[name] = np.array([[float(whole(d[k])) for k in sorted(plain)]
                              for d in (new, old, plain)])

    # -- the ring buffer's roll
    k = randn(2, 12, 4, 8)
    pk = place(k, *rows_heads)
    for r in (0, 5):
        new = attention._roll_seq(pk, r)
        old = torch.roll(pk, r, dims=1)
        out[f"roll{r}"] = np.stack([whole(new), whole(old), whole(attention._roll_seq(k, r)),
                                    whole(torch.roll(k, r, dims=1))])
        out[f"roll{r}_placements"] = np.array([str(new.placements), str(old.placements)])

    # -- the prefill's stacked cache (C27), with and without headroom; and
    # entries whose sequence is split, which are stacked as a whole
    entries = [(place(randn(2, 6, 4, 8), *rows_heads), place(randn(2, 6, 4, 8), *rows_heads))
               for _ in range(3)]
    split_seq = [tuple(place(t.full_tensor(), Shard(0), Shard(1)) for t in ent)
                 for ent in entries]
    for extra in (0, 3, "seq"):
        if extra == "seq":
            entries, extra = split_seq, 3
        acc = transformer._EntryStack(3, extra)
        for u, ent in enumerate(entries):
            acc.put(u, ent)
        got, left = acc.stacked()
        padded = [transformer._pad_seq(t, left) for t in got]
        want = [transformer._pad_seq(torch.stack(parts), extra) for parts in zip(*entries)]
        key = "stack_seq" if entries is split_seq else f"stack{extra}"
        out[key] = np.stack([np.stack([whole(a), whole(b)]) for a, b in zip(padded, want)])
        out[f"{key}_meta"] = np.array(
            [left, str(got[0].placements), str(want[0].placements),
             str(tuple(got[0].to_local().shape)), str(tuple(want[0].to_local().shape))])
    return out


def prog_analysis(rank: int, world: int, inputs: dict) -> dict:
    """The interface under analysis recording on every rank: a clean
    program (allreduce, a ring ``send_recv``, an immediate allreduce
    consumed), written to ``clean<r>.jsonl``; then the same program with
    rank 1's first two collectives swapped (``reduce`` and ``allreduce``
    move the same bytes on the wire, so the run completes) and an immediate
    allreduce never consumed on every rank, written to ``defect<r>.jsonl``."""

    import torch

    from repro_torch.analysis import events
    from repro_torch.core import tool
    from repro_torch.core.communicator import world as world_comm

    workdir = Path(str(inputs["workdir"]))
    tool.cvar_set("analysis_recording", True)
    comm = world_comm(device_type="cpu")
    x = torch.ones(8) * (rank + 1)
    perm = [(i, (i + 1) % comm.size()) for i in range(comm.size())]

    def program(swap: bool, leak: bool):
        first, second = ("allreduce", "reduce") if not (swap and rank == 1) else \
            ("reduce", "allreduce")
        y = getattr(comm, first)(x)
        y = getattr(comm, second)(y)
        y = comm.send_recv(y, perm)
        y = y + comm.immediate_allreduce(x).get()
        if leak:
            comm.immediate_allreduce(x)          # never consumed
        return y

    events.reset()
    clean = program(False, False)
    events.dump(workdir / f"clean{rank}.jsonl")
    events.reset()
    program(True, True)
    events.dump(workdir / f"defect{rank}.jsonl")
    tool.cvar_set("analysis_recording", False)
    return {"clean": clean.numpy()}


def prog_example(rank: int, world: int, inputs: dict) -> dict:
    """``main(argv, **hooks)`` of ``examples_torch/<name>.py`` under the
    analyzer's recording, as the lint runs a target, its trainers on a
    clock that stands still: this rank's ledger written to the work
    directory, ``main``'s result as JSON."""

    import runpy

    import torch

    from repro_torch.analysis import events, lint
    from repro_torch.core import tool

    from repro_torch.runtime import trainer

    workdir = Path(str(inputs["workdir"]))
    hooks = torch.load(workdir / "hooks.pt") if (workdir / "hooks.pt").exists() else {}
    # a clock that stands still: no step of a loaded host is a straggler
    init = trainer.Trainer.__init__
    trainer.Trainer.__init__ = lambda self, *a, **k: init(self, *a, **{"clock": lambda: 0.0,
                                                                       **k})
    main = runpy.run_path(str(ROOT / "examples_torch" / f"{inputs['name']}.py"))["main"]
    tool.cvar_set("analysis_recording", True)
    tool.pvar_strict(True)
    try:
        result = main([str(a) for a in inputs["argv"]], **hooks)
    finally:
        events.dump(workdir / lint.LEDGER_FILE.format(rank=rank))
    return {"json": np.array(json.dumps(result, default=_jsonable))}


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON")


def prog_straggler(rank: int, world: int, inputs: dict) -> dict:
    """The tiny model on a (2, 1) fabric under a fake clock each rank
    advances by itself (0.01 s a start): ``agree``, rank 1 alone sees step 7
    take 1 s (ROADMAP C31); ``first_start``, rank 1 is evicted at step 4
    and re-admitted at step 7, and each epoch's first start takes 1 s on
    every rank (C32).  Each case's result on this rank."""

    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.faults import FaultInjector, StragglerPolicy
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    work = Path(str(inputs["work"]))
    cfg = ModelConfig(**ELASTIC_CFG)
    out = {}
    for name, injector in (("agree", None),
                           ("first_start", FaultInjector().evict_rank(4, 1).admit_rank(7))):
        now = [0.0]
        tcfg = TrainerConfig(steps=10, lr=1e-3, checkpoint_dir=str(work / name),
                             checkpoint_every=2, log_every=1, seed=7)
        t = Trainer(cfg, ParallelConfig(), tcfg, make_host_communicator(device="cpu"),
                    seq_len=32, global_batch=4, injector=injector,
                    straggler=StragglerPolicy(deadline_factor=3.0, min_samples=2),
                    clock=lambda now=now: now[0])
        real = t.compile
        calls = [0]

        def compile_timed(params, opt_state, t=t, real=real, name=name, now=now, calls=calls):
            step = real(params, opt_state)

            def timed_step(*args):
                calls[0] += 1
                slow = (rank == 1 and calls[0] == 7) if name == "agree" else step.starts == 0
                now[0] += 1.0 if slow else 0.01
                return step(*args)

            t._compiled = timed_step
            return timed_step

        t.compile = compile_timed
        res = t.run()
        for key in ("final_step", "restarts", "evictions", "joins", "world_size"):
            out[f"{name}/{key}"] = np.array(res[key])
        del t
    return out


def torch_from(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


PROGRAMS = {"collectives": prog_collectives, "overlap_schedules": prog_overlap_schedules,
            "tune_cli": prog_tune_cli, "ring": prog_ring, "server": prog_server,
            "zamba2_ring": prog_zamba2_ring, "trainer": prog_trainer,
            "requests": prog_requests, "grad_sync": prog_grad_sync, "rma": prog_rma,
            "neighbors": prog_neighbors, "moe_neighbor": prog_moe_neighbor,
            "disagg": prog_disagg, "serve_fanout": prog_serve_fanout,
            "sharded_serve": prog_sharded_serve, "sharded_train": prog_sharded_train,
            "sharded_restore": prog_sharded_restore, "overlap": prog_overlap,
            "rows_split": prog_rows_split, "pipeline_schedule": prog_pipeline_schedule, "train_plans": prog_train_plans, "ring_grad": prog_ring_grad, "int8_plans": prog_int8_plans, "split_rows_update": prog_split_rows_update,
            "serve_mesh": prog_serve_mesh, "session_calls": prog_session_calls,
            "elastic": prog_elastic, "ring_placed_serve": prog_ring_placed_serve,
            "ring_placed_train": prog_ring_placed_train, "engine_placed": prog_engine_placed,
            "serve_cb_mesh": prog_serve_cb_mesh,
            "ring_placed_elastic": prog_ring_placed_elastic, "train_cli": prog_train_cli,
            "four_model_ranks": prog_four_model_ranks, "dryrun_counts": prog_dryrun_counts,
            "analysis": prog_analysis, "placed_repairs": prog_placed_repairs,
            "hlo_passes": prog_hlo_passes, "example": prog_example,
            "straggler": prog_straggler}


def main(argv: list[str]) -> int:
    program, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    inputs = dict(np.load(workdir / "inputs.npz"))
    _init(rank, world, workdir)
    result = PROGRAMS[program](rank, world, inputs)
    np.savez(workdir / f"rank{rank}.tmp.npz", **result)
    os.replace(workdir / f"rank{rank}.tmp.npz", workdir / f"rank{rank}.npz")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
