"""Quickstart — the paper's two listings, runnable on the port.

Listing 1: user-defined types in communication without manual datatype
registration (aggregate reflection).
Listing 2: requests as futures chained with .then() into an async sequence.

Each rank is a process.  On the card (one rank a card, NCCL)::

    PYTHONPATH=src python examples_torch/quickstart.py

and on the CPU, eight gloo ranks::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \\
        examples_torch/quickstart.py --device cpu

Listing 2 chains broadcasts from roots 0, 1 and 2; here each root is taken
modulo the world size, which changes nothing on three or more ranks and
lets the chain run on one card (the reference's script raises ``ERR_ROOT``
below three devices).  Every rank prints the same lines.
"""
# lint-ranks: 8

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import core as mpx


# --- Listing 1: aggregate reflection ----------------------------------------

@dataclasses.dataclass
class Particle:
    position: torch.Tensor     # (3,)
    velocity: torch.Tensor     # (3,)
    mass: torch.Tensor         # ()


def listing1(comm) -> Particle:
    mpx.register_aggregate(Particle)   # the PFR step (also implicit on use)
    dev = comm.device
    p = Particle(
        position=torch.ones((3,), device=dev),
        velocity=torch.full((3,), float(comm.rank()), device=dev),
        mass=torch.tensor(1.0, device=dev),
    )
    # no manual MPI_Type_create_struct: the interface reflects the
    # aggregate, packs it per-dtype, runs ONE collective per buffer
    total = comm.allreduce(p)
    print("Listing 1 — allreduced Particle:")
    print("  position:", _np(total.position), " velocity:", _np(total.velocity),
          " mass:", _np(total.mass))
    return total


# --- Listing 2: futures with continuations -----------------------------------

def listing2(comm) -> int:
    dev, n = comm.device, comm.size()

    def step(fut, root):
        value = fut.get()
        return comm.immediate_broadcast(
            torch.where(torch.tensor(comm.rank() == root % n, device=dev), value + 1, value),
            root=root % n)

    data = torch.tensor(1 if comm.rank() == 0 else 0, dtype=torch.int32, device=dev)
    f = mpx.future(comm.immediate_broadcast(data, root=0))
    f = f.then(lambda fut: step(fut, 1))
    f = f.then(lambda fut: step(fut, 2))
    out = int(f.get())          # data == 3 on all ranks
    print("Listing 2 — chained broadcasts:", out, "(expect 3)")
    return out


# --- task graph: forks + when_all (MPI_Waitall) -------------------------------

def task_graph(comm) -> float:
    dev = comm.device
    a = comm.immediate_allreduce(torch.tensor(float(comm.rank()), device=dev))
    b = comm.immediate_broadcast(torch.tensor(100.0, device=dev), root=0)

    def add(joined):
        x, y = joined.get()
        return x + y

    out = float(mpx.when_all([a, b]).then(add).get())
    print("task graph (fork/join):", out)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to run on (default: the CUDA device)")
    args = ap.parse_args(argv)

    comm = mpx.world(device_type=args.device)
    print(f"world: {comm.size()} devices")
    total = listing1(comm)
    return {
        "world": comm.size(),
        "position": _np(total.position), "velocity": _np(total.velocity),
        "mass": _np(total.mass),
        "listing2": listing2(comm),
        "task_graph": task_graph(comm),
    }


if __name__ == "__main__":
    main()
