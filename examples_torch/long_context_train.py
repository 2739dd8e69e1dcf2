"""Long-context training on the port's fused ring-attention path: the
trainer's process set folded onto a ``(data, ring)`` cart, the sequence
sharded over the periodic ring, KV rotating through the ring-step kernel —
``N - 1`` exchanges per layer, never a KV all-gather.  First the ring path
is parity-checked against the dense reference at a small size on the
first four ranks, then a few steps train at a sequence length whose dense
KV would not fit one device's smoke budget.  It needs a world of a
multiple of four ranks, one a card::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        examples_torch/long_context_train.py [--device cpu]

The ring's parity check runs the ring-step kernel on the card and its
plain version on the CPU (the reference's runs its plain version).  The
reference's script prints a ``(2, 4)`` cart whatever its device count; the
port's prints the cart it folded.  ``main(params=...)`` trains from a given
parameter tree (the reference's, converted) in place of the seeded draw.
"""
# lint-ranks: 4

import argparse
import copy
import math

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ParallelPlan
from repro_torch.core import topology
from repro_torch.core.communicator import Communicator, world
from repro_torch.core.session import UNDEFINED
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ring_attention import ops as ring_ops
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def parity_check(device: str, ring_size: int = 4) -> bool:
    comm = Communicator.from_group(
        world(device_type=device).group().incl(range(ring_size)), tag="lc-demo")
    cart = topology.cart_create(comm, (ring_size,), (True,), axis_names=("ring",))
    if comm.rank() == UNDEFINED:
        return False
    gen = torch.Generator(device=comm.device).manual_seed(0)
    q, k, v = (torch.randn((2, 128, 4, 16), generator=gen, device=comm.device)
               for _ in range(3))
    shard = 128 // ring_size
    rows = slice(cart.rank() * shard, (cart.rank() + 1) * shard)
    out = ring_ops.ring_attention(cart, q[:, rows], k[:, rows], v[:, rows], causal=True,
                                  block_q=16, block_k=16)
    ref = fa.flash_attention(q, k, v, causal=True, impl="ref")[:, rows]
    torch.testing.assert_close(out, ref, atol=5e-5, rtol=5e-5)
    print(f"parity: ring({ring_size}) == dense reference at S=128")
    return True


def train_long(device: str, params=None, seq_len: int = 1024, ring_size: int = 4) -> dict:
    cfg = ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
    )
    trainer = Trainer(  # re-forms the ranks as a (W / ring, ring) (data, ring) cart
        cfg, ParallelConfig(),
        TrainerConfig(steps=3, lr=1e-3, log_every=1,
                      plan=ParallelPlan(ring=ring_size)),
        make_host_communicator(device=device), seq_len=seq_len, global_batch=2,
    )
    if params is not None:
        trainer.init_state = lambda: trainer.place_state(copy.deepcopy(params))
    result = trainer.run()
    dims = tuple(trainer.comm.shape)
    del trainer
    loss = float(result["metrics"][-1]["loss"])
    assert math.isfinite(loss), loss
    print(f"trained {seq_len}-token sequences on a {dims} "
          f"(data, ring) cart: final loss {loss:.3f}")
    return {"losses": [m["loss"] for m in result["metrics"]], "dims": dims,
            "steps": [m["step"] for m in result["metrics"]]}


def main(argv=None, *, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to train on (default: the CUDA device)")
    args = ap.parse_args(argv)
    return {"parity": parity_check(args.device), **train_long(args.device, params)}


if __name__ == "__main__":
    main()
