"""Disaggregated prefill/decode serving over the RMA window transport, on
the port.

The serving process set is split into a *prefill* group and a *decode*
group (MPI 4.0 group algebra); prefill ranks compute the KV cache and
``rput`` it — page by page, each page's request chained onto the previous —
into an RMA window exposed by the decode ranks (MPI 4.0 chapter 12, the
one-sided interface); the decode group then generates tokens on its own
persistent decode request (a CUDA graph on the card), never touching
prefill ranks again.

The check that matters: at ``temperature=0`` the disaggregated pipeline is
**token-for-token identical** to the single-group ``Server.generate``
baseline — the transport moved the whole cache, bit-exactly, through the
window (the decode-side buffers start as zeros, so parity proves the pages
actually crossed).  On a world of one the two groups are the one rank and
the transport runs over a one-rank bridge.

    PYTHONPATH=src python examples_torch/disaggregated_serve.py
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        examples_torch/disaggregated_serve.py --device cpu

Every rank prints the same lines, but for its pvars (each rank counts its
own calls).  ``main(params=...)`` serves a given parameter tree (the
reference's, converted) in place of the seeded draws.
"""
# lint-ranks: 4

import argparse

import numpy as np

from repro_torch import core as mpx
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.runtime.server import DisaggregatedServer, Request, Server, ServerConfig


def tiny_cfg() -> ModelConfig:
    # float32: the window transport is bit-exact in any dtype (pack, put,
    # unpack, no arithmetic), but bf16 *compute* can round differently
    # between the whole set's baseline and the decode group's server, which
    # can flip near-tied argmaxes — the parity check below isolates the
    # transport
    return ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
    )


def main(argv=None, *, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to serve on (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg, pcfg = tiny_cfg(), ParallelConfig()
    scfg = ServerConfig(max_batch=4, max_new_tokens=12, temperature=0.0)

    rng = np.random.default_rng(0)
    reqs = [
        Request(tokens=rng.integers(1, cfg.vocab_size, size=(24,), dtype=np.int32))
        for _ in range(scfg.max_batch)
    ]

    # single-group baseline: prefill + decode share the whole process set
    baseline = Server(cfg, pcfg, scfg, make_host_communicator(device=args.device))
    if params is not None:
        baseline.params = params
    base_tokens, base_stats = baseline.generate(reqs)
    del baseline

    # disaggregated: prefill and decode on disjoint halves, KV over RMA
    server = DisaggregatedServer(cfg, pcfg, scfg, kv_pages=4, device=args.device)
    for srv in (server.prefill, server.decode):
        if srv is not None and params is not None:
            srv.params = params
    sess = mpx.default_session(device_type=args.device)
    print(f"prefill pset: {sess.pset_info('repro://world/prefill')}")
    print(f"decode pset:  {sess.pset_info('repro://world/decode')}")
    overlap = server.prefill_comm.group().intersection(server.decode_comm.group())
    print(f"overlapping devices: {overlap.size()} (expect 0 with >1 device)")

    tokens, stats = server.generate(reqs)
    print(f"prefill {stats['prefill_s']*1e3:.0f} ms on {stats['prefill_devices']} devices  "
          f"| KV {stats['kv_bytes']/1024:.1f} KiB in {stats['kv_pages']} pages "
          f"({stats['transfer_s']*1e3:.0f} ms)  "
          f"| decode {stats['decode_s']*1e3:.0f} ms on {stats['decode_devices']} devices  "
          f"| {stats['tokens_per_s']:.1f} tok/s")

    assert np.array_equal(tokens, base_tokens), (
        f"disaggregated tokens diverged from the single-group baseline:\n"
        f"{tokens}\nvs\n{base_tokens}"
    )
    print(f"token-for-token parity with the single-group baseline: OK {tokens.shape}")
    pv = mpx.tool.pvar_read()
    pvars = {k: v for k, v in pv.items() if k.startswith("rma_") or "kv_transfer" in k}
    print("pvars:", pvars)
    return {"tokens": tokens, "shape": tuple(tokens.shape), "parity": True,
            "overlap": overlap.size(), "pvars": pvars,
            "stats": {k: stats[k] for k in ("kv_bytes", "kv_pages", "prefill_devices",
                                            "decode_devices")}}


if __name__ == "__main__":
    main()
