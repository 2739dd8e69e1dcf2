"""Batched serving on the port: prefill + token-by-token decode with a
persistent KV cache (the decode step a CUDA graph on the card), on any of
the assigned architectures (smoke scale).

    PYTHONPATH=src python examples_torch/serve_batched.py --arch gemma2_9b

The server's communicator folds every rank onto a (data, 1) grid, as the
reference's host mesh folds every device.  On the CPU, two gloo ranks::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        examples_torch/serve_batched.py --device cpu

``main(params=..., dtype=...)`` serves a given parameter tree (the
reference's, converted) in place of the seeded draw, with the model in
``dtype``.
"""
# lint-ranks: 2

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import base
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.runtime.server import Request, Server, ServerConfig


def main(argv=None, *, params=None, dtype=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_9b", choices=base.ARCHITECTURES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to serve on (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = base.get_smoke_config(args.arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    pcfg = base.get_parallel(args.arch)
    server = Server(
        cfg, pcfg,
        ServerConfig(max_batch=args.batch, max_new_tokens=args.new_tokens,
                     temperature=args.temperature),
        make_host_communicator(device=args.device),
    )
    if params is not None:
        server.params = params

    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(args.batch):
        extra = {}
        if cfg.family == "vlm":
            extra["image_embeds"] = rng.standard_normal(
                (cfg.num_image_tokens, 1152)).astype(np.float32)
        if cfg.family == "encdec":
            extra["frames"] = rng.standard_normal(
                (args.prompt_len, cfg.d_model)).astype(np.float32)
        reqs.append(Request(
            tokens=rng.integers(1, cfg.vocab_size, (args.prompt_len,), dtype=np.int32),
            extra=extra,
        ))

    tokens, stats = server.generate(reqs)
    print(f"arch={args.arch}  generated {tokens.shape} tokens")
    print(f"prefill {stats['prefill_s']*1e3:.0f} ms   "
          f"decode {stats['decode_s']*1e3:.0f} ms   "
          f"{stats['tokens_per_s']:.1f} tok/s")
    print("first sequence:", tokens[0][:16], "...")
    return {"tokens": np.asarray(tokens), "shape": tuple(tokens.shape)}


if __name__ == "__main__":
    main()
