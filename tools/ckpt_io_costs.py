#!/usr/bin/env python3
"""What the checkpoint manager's request layout buys on one card's host.

    python3 tools/ckpt_io_costs.py

Needs one CUDA device; run on demand, apart from ``chip_smoke.py``, whose
pass or fail reads neither result.  It makes the training state of
``chip_smoke.py``'s ``train_checkpoint`` phase (phi4-mini at full width and
2 layers: parameters and fp32 AdamW moments, 8.16 GB, random from seed 0)
on the card, then times, in turns buckets, one-per-dtype, one-per-dtype,
buckets:

1. a synchronous save (``async_save=False``: the device-to-host copy, the
   writes, the read-back checks and the manifest commit) under ``build/``,
   with the manager's write requests of at most ``BUCKET_BYTES``, and with
   one write request per dtype (the reference's layout);
2. a restore of that save to the card: the manager's (one concurrent read
   request per record), and the reference's (one file handle, the records
   read one after another through ``set_view``).

The restores read what the save before them just wrote, so both read from
the host's page cache alike.  Each checkpoint is deleted after its restore.
Prints each result beside the card's name and power limit and writes them
all to ``artifacts/ckpt_io_costs.json``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the device helpers)


def _state():
    import torch

    from repro_torch.configs import base
    from repro_torch.core.futures import flatten
    from repro_torch.models import api as model_api
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(base.get_config("phi4_mini_3_8b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = model_api.build(cfg).init(gen)
    opt_state = AdamW(lr=3e-4, moment_dtype="float32").init(params)
    # moments of random bytes, not zeros, as a trained state's are
    with torch.no_grad():
        for leaf in flatten((opt_state.mu, opt_state.nu))[0]:
            leaf.normal_(generator=gen)
    return {"params": params, "opt": opt_state}


def _restore_serial(directory: str, template, step: int):
    """The reference's restore: one file handle, one record at a time."""

    from repro_torch.checkpoint.manager import _flatten_with_names
    from repro_torch.core import io as pio
    from repro_torch.core.descriptors import Mode
    from repro_torch.core.futures import flatten, unflatten

    f = pio.open(str(Path(directory) / f"step_{step:08d}"), Mode.RDONLY, checksum=True)
    arrays = f.manifest()["arrays"]
    flat_t, treedef = flatten(template)
    restored = []
    for (name, _), tmpl in zip(_flatten_with_names(template), flat_t):
        f.set_view(etype=arrays[name].get("etype"))
        arr = f.read_at_all(name, tmpl.device)
        restored.append(arr.to(tmpl.dtype) if arr.dtype != tmpl.dtype else arr)
    return unflatten(treedef, restored)


def main() -> int:
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.core.futures import flatten

    chip_smoke.phase_device()
    state = _state()
    leaves = flatten(state)[0]
    bucket_bytes = ckpt_manager.BUCKET_BYTES
    directory = ROOT / "build" / "ckpt_io_costs"
    rows = []
    for layout in ("buckets", "per_dtype", "per_dtype", "buckets"):
        shutil.rmtree(directory, ignore_errors=True)
        ckpt_manager.BUCKET_BYTES = bucket_bytes if layout == "buckets" else sys.maxsize
        mgr = CheckpointManager(str(directory), async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, state, extra={"step": 2})
        save_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in (directory / "step_00000002").iterdir())
        t0 = time.perf_counter()
        if layout == "buckets":
            tree, _ = mgr.restore(state, step=2)
        else:
            tree = _restore_serial(str(directory), state, 2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(flatten(tree)[0], leaves))
        chip_smoke.check(same, f"{layout}: the restored state differs from the saved one")
        row = {"save_layout": layout,
               "restore": "per_record_requests" if layout == "buckets" else "serial",
               "save_s": save_s, "restore_s": restore_s, "checkpoint_gb": nbytes / 1e9,
               "bucket_bytes": bucket_bytes if layout == "buckets" else None,
               "device": chip_smoke.RESULTS["device"]["nvidia_smi"]}
        chip_smoke.log_row(row)
        rows.append(row)
        del tree
    ckpt_manager.BUCKET_BYTES = bucket_bytes
    shutil.rmtree(directory, ignore_errors=True)
    out = ROOT / "artifacts"
    out.mkdir(exist_ok=True)
    (out / "ckpt_io_costs.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
