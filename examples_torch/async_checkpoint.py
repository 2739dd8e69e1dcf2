"""Nonblocking collective file I/O as the checkpoint subsystem (MPI 4.0
chapter 14), on the port: request-based async saves that overlap compute, a
single manifest commit per step, typed failure propagation (a torn save can
never read as success), and file views that round-trip the C2 packed layout
page-by-page.

    PYTHONPATH=src python examples_torch/async_checkpoint.py [--device cpu]

The state and the compute live on the card unless ``--device cpu`` is
given; the files go to a temporary directory.
"""
# lint-ranks: 1

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch import core as mpx
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import errors
from repro_torch.core import io as pio
from repro_torch.runtime.faults import FaultInjector


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def async_save_overlaps_compute(ckpt_dir: str, device: torch.device) -> dict:
    state = {
        "params": torch.arange(1 << 20, dtype=torch.float32, device=device),
        "moments": torch.ones((1 << 19,), dtype=torch.bfloat16, device=device),
    }
    mgr = CheckpointManager(ckpt_dir, async_save=True)

    def step_fn(a):
        return a @ a.T / 256.0 + 1.0

    x = torch.ones((256, 256), device=device)
    step_fn(x)
    _sync(device)

    t0 = time.perf_counter()
    req = mgr.save(1, state)         # returns with the I/O still in flight
    issue_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(20):              # "the next persistent step"
        x = step_fn(x)
    _sync(device)
    step_dir = mgr.wait()            # durability point; re-raises failures
    print(f"async save issued in {issue_ms:.1f} ms, committed to {step_dir}")
    assert req.test()                # completion observable on the request

    restored, step = mgr.restore({k: torch.zeros_like(v) for k, v in state.items()})
    assert torch.equal(restored["moments"], state["moments"])
    assert restored["moments"].device == state["moments"].device
    print(f"restored step {step}: bf16 bucket round-tripped exactly")
    return {"restored_step": step}


def torn_save_surfaces(ckpt_dir: str, device: torch.device) -> str:
    state = {"w": torch.ones((128, 128), device=device)}
    mgr = CheckpointManager(
        ckpt_dir, async_save=True, injector=FaultInjector(fail_fragments=("w",))
    )
    mgr.save(1, state)
    try:
        mgr.wait()
        raise AssertionError("a torn save must not report success")
    except errors.IoError as e:
        print(f"torn save surfaced as typed failure: {e}")
        message = str(e)
    assert mgr.latest_step() is None  # `latest` never advanced
    return message


def paged_view_roundtrip(path: str, device: torch.device) -> dict:
    @dataclasses.dataclass
    class KVCache:
        keys: object
        values: object

    cache = KVCache(
        keys=torch.arange(64, dtype=torch.bfloat16, device=device).reshape(8, 8) / 9,
        values=torch.ones((8, 8), dtype=torch.float32, device=device),
    )
    f = pio.open(path, pio.Mode.CREATE | pio.Mode.WRONLY)
    f.set_view(filetype=cache, num_pages=4)   # the RMA-window page layout
    rec = f.write_at_all("kv", cache)
    out = (
        pio.open(path, pio.Mode.RDONLY)
        .set_view(filetype=cache, num_pages=4)
        .read_at_all("kv", device=device)
    )
    assert torch.equal(out.keys, cache.keys)
    print(f"paged view round-trip: {len(rec['fragments'])} page fragments, "
          f"{len(rec['view']['groups'])} dtype groups")
    return {"fragments": len(rec["fragments"]), "groups": len(rec["view"]["groups"])}


def chained_requests(path: str) -> list:
    f = pio.open(path, pio.Mode.CREATE | pio.Mode.WRONLY)
    reqs = [f.iwrite_at_all(n, np.full(8, i)) for i, n in enumerate("abc")]
    names = mpx.when_all(reqs).then(
        lambda joined: [r["name"] for r in joined.get()]
    )
    out = names.get()
    print(f"when_all + then over I/O requests: {out}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type to run on (default: the CUDA device)")
    args = ap.parse_args(argv)
    # the session's device: on a machine with no card and no --device cpu
    # this raises ERR_SESSION, as every entry point of the port does
    device = mpx.world(device_type=args.device).device

    with tempfile.TemporaryDirectory() as d:
        result = async_save_overlaps_compute(f"{d}/ckpt", device)
        result["torn"] = torn_save_surfaces(f"{d}/torn", device)
        result.update(paged_view_roundtrip(f"{d}/view.mpio", device))
        result["names"] = chained_requests(f"{d}/chain.mpio")
    print("ok")
    return result


if __name__ == "__main__":
    main()
