"""The multi-pod dry run, :mod:`repro.launch.dryrun` for the port: trace every
(architecture x input-shape) cell once on the production grid, record its
memory, its roofline terms and its useful-flops ratio — the artifact the
tuner calibrates from (:func:`repro_torch.tune.load_calibration`).

Usage::

    python -m repro_torch.launch.dryrun --arch gemma2_9b --shape train_4k
    python -m repro_torch.launch.dryrun --arch gemma2_9b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all [--jobs 3] [--multi-pod]
    python -m repro_torch.launch.dryrun --all --both   # single- and multi-pod
    python -m repro_torch.launch.dryrun --arch phi4_mini_3_8b --shape train_2048 \\
        --batch 2 --grid 1x1 --device cpu --artifacts /tmp/dry

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
(``tune.score.CALIBRATION_DIR``); ``--all`` skips cells whose artifact was
written by the same request and runs each cell in a subprocess (a process
has one default process group).

**Port-only choices.**

* **The fake cluster.**  The reference lowers for 512 virtual XLA devices.
  The port initialises a fake process group
  (``torch.testing._internal.distributed.fake_pg``) of 256 or 512 ranks in
  one process, rank 0 of which it is; the session reads it as its world
  (``core/session.py``), and the production communicator folds it onto the
  reference's grid (``launch/mesh.make_production_communicator``, whose
  docstring says what the grid means on H100 nodes).  Its collectives move
  nothing.
* **One trace, not a compile.**  The cell is built under ``FakeTensorMode``
  on device ``cuda`` (or ``cpu`` with ``--device cpu``; no card is needed
  either way): stand-in parameters, optimizer state, batch and cache
  (``launch/specs.py``) placed as DTensors under the reference's specs, and
  the step (``launch/steps.py``) runs once over them.  The port's kernels
  are custom ops whose fake implementations give shapes and whose formulas
  give flops and bytes (:mod:`repro_torch.kernels.registry`); nothing is
  launched.  ``lower_s`` / ``compile_s`` become ``trace_s``.
* **Dispatch counts in place of HLO counts** (:class:`DispatchCount`, the
  recorder of :mod:`repro_torch.core.hloanalysis`, a ``__torch_dispatch__``
  mode under DTensor, so it sees each rank's local ops): flops from ``torch.utils.flop_counter``'s formulas and the kernels',
  bytes as each op's inputs read and outputs written — one aten op at a
  time, with no fusion, so ``memory_s`` is an upper bound of an eager
  step's traffic — and each collective by kind with its operand, result and
  wire bytes (``tool._wire_factor`` over its group's size).
  ``tool.roofline_terms`` turns them into the reference's terms.
* **Memory** is ``torch.distributed._tools.mem_tracker.MemTracker``'s peak
  over the traced step, its arguments included (:func:`peak_tracker`):
  ``memory.peak_bytes_per_device``, with the peak's categories beside it.
  ``n_hlo_lines`` and ``roofline_raw_uncorrected`` read XLA's module and
  have no counterpart (ROADMAP A16).

A cell that fails to trace is written as ``status: error`` with its
exception, and the command exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import torch

from repro_torch.core.hloanalysis import Recorder, active_fake_mode
from repro_torch.kernels.registry import tensor_bytes

ROOT = Path(__file__).resolve().parents[3]
ARTIFACTS = ROOT / "artifacts" / "dryrun_torch"

class DispatchCount(Recorder):
    """A ``__torch_dispatch__`` mode that counts one device's step: flops,
    bytes and collectives (``flops``, ``bytes``, ``collectives``, a
    :class:`repro_torch.core.tool.CollectiveStats`), one op at a time, and
    the port's kernels by op (``kernels``) — the recorder of
    :mod:`repro_torch.core.hloanalysis`, whose ``program`` holds the step's
    ops: ``analyze_hlo(counted.program.as_text())`` reads the same sums
    back.

    It lets DTensor run first (it returns ``NotImplemented`` on DTensor
    arguments), so it sees the local ops of this rank; it skips the ops
    DTensor's sharding propagation runs under a fake mode of its own, as
    ``MemTracker`` does (the mode active when counting began is the step's).
    """


def peak_tracker():
    """``MemTracker`` that, whatever its torch version, lets DTensor run
    first and skips the ops of DTensor's sharding propagation (whose
    outputs have whole, global shapes), as :class:`DispatchCount` does;
    torch 2.11's tracked them, and a pod cell's peak read 440 GB a card of
    propagation's stand-ins."""

    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class _PeakTracker(MemTracker):
        def __enter__(self):
            self._entry_fake = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if active_fake_mode() is not self._entry_fake:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _PeakTracker()


@contextlib.contextmanager
def dtensor_under_fake():
    """Run DTensor's own bookkeeping outside the trace's fake mode.  Its
    sharding propagation reuses an active fake mode to compute output
    metadata, which would make its ops (on whole, global shapes) look like
    the step's to the counters; and its strided-shard offsets read index
    tensors with ``tolist()``, which a fake tensor cannot give.  Both run
    here with the fake mode unset: propagation then makes a fake mode of
    its own, which the counters skip."""

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop, placement_types

    patched = []

    def wrap(owner, name, static=False):
        orig = owner.__dict__.get(name)
        if orig is None:
            return
        fn = orig.__func__ if static else orig

        def unfaked(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)

        setattr(owner, name, staticmethod(unfaked) if static else unfaked)
        patched.append((owner, name, orig))

    for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"):
        if name in _sharding_prop.ShardingPropagator.__dict__:
            wrap(_sharding_prop.ShardingPropagator, name)
            break
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None:
        wrap(strided, "local_shard_size_and_offset",
             static=isinstance(strided.__dict__.get("local_shard_size_and_offset"),
                               staticmethod))
    try:
        yield
    finally:
        for owner, name, orig in reversed(patched):
            setattr(owner, name, orig)


def init_fake_world(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks (this process rank 0)
    as the default group: the dry run's cluster."""

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _parse_grid(grid: str) -> tuple[int, int]:
    d, m = (int(x) for x in grid.lower().split("x"))
    return d, m


def shape_config(shape_name: str, batch: int | None = None):
    """A ``SHAPES`` entry, or ``<kind>_<seq>`` (``train_2048``) at
    ``batch``."""

    from repro_torch.configs import base

    if shape_name in base.SHAPES and batch is None:
        return base.SHAPES[shape_name]
    if shape_name in base.SHAPES:
        s = base.SHAPES[shape_name]
        return dataclasses.replace(s, global_batch=batch)
    kind, _, seq = shape_name.partition("_")
    if kind not in ("train", "prefill", "decode") or not seq.isdigit() or batch is None:
        raise ValueError(f"shape {shape_name!r} is not in SHAPES; a custom shape is "
                         f"<train|prefill|decode>_<seq> with --batch")
    return base.ShapeConfig(shape_name, int(seq), int(batch), kind)


def mesh_name(multi_pod: bool, grid: str | None = None) -> str:
    if grid:
        d, m = _parse_grid(grid)
        return f"grid_{d}x{m}"
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: dict, tag: str,
             plan_spec: str | None = None, *, device: str = "cuda", grid: str | None = None,
             batch: int | None = None, smoke: bool = False) -> dict:
    """Trace one cell; its record (the reference's fields).  Initialises the
    fake cluster: call it once a process."""

    from repro_torch.configs import base
    from repro_torch.core import tool
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import api as model_api
    from repro_torch.optim import AdamW

    cfg = base.get_smoke_config(arch) if smoke else base.get_config(arch)
    shape = shape_config(shape_name, batch)
    ok, reason = base.shape_applicable(cfg, shape)
    record: dict = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name(multi_pod, grid),
        "tag": tag,
        "overrides": overrides,
        "device": device,
    }
    if not ok:
        record.update(status="skipped", reason=reason)
        return record

    if grid and math.prod(_parse_grid(grid)) == 1:
        # one rank keeps plain tensors, as the port's trainer and server do
        # on a grid of one: no process group, no placement
        comm = None
    elif grid:
        d, m = _parse_grid(grid)
        init_fake_world(d * m)
        comm = mesh_mod.make_host_communicator(d, m, device=device)
    else:
        shp, _, _ = mesh_mod.PRODUCTION_GRIDS[bool(multi_pod)]
        init_fake_world(math.prod(shp))
        comm = mesh_mod.make_production_communicator(multi_pod=multi_pod, device=device)
    chips = comm.size() if comm is not None else 1
    pcfg = base.get_parallel(arch, multi_pod=multi_pod and not grid)
    for k, v in overrides.items():
        if not hasattr(pcfg, k):
            raise KeyError(f"unknown ParallelConfig field {k!r}")
        # a JSON list is a tuple field (``data_axes``)
        setattr(pcfg, k, tuple(v) if isinstance(v, list) else v)

    opt = AdamW(lr=1e-4, moment_dtype=pcfg.moment_dtype)
    if comm is not None:
        comm.device_mesh  # built on real index tensors, before the fake mode
    mode = model_api.fake_mode()
    t0 = time.time()
    with mode, dtensor_under_fake():
        kind, kwargs, _ = specs_mod.input_specs(
            arch, shape, comm, pcfg, opt=opt, device=device, cfg=cfg,
            microbatches=max(1, getattr(pcfg, "microbatches", 1)))
        step = steps_mod.make_step(kind, cfg, pcfg, opt)
        args = steps_mod.example_args(kind, kwargs)
        tracker = peak_tracker()
        tracker.track_external(*specs_mod._leaves(args))
        counted = DispatchCount()
        with tracker, counted:
            out = step(*args)
        del out
    trace_s = time.time() - t0

    # -- memory (proves it fits) ---------------------------------------------
    peak = tracker.get_tracker_snapshot("peak")
    dev_key = next((k for k in peak if torch.device(k).type == torch.device(device).type),
                   None)
    snap = {getattr(k, "value", str(k)): int(v) for k, v in (peak.get(dev_key) or {}).items()}
    mem = {
        "argument_size_in_bytes": sum(
            tensor_bytes(x.to_local() if hasattr(x, "to_local") else x)
            for x in specs_mod._leaves(args)),
        "peak_bytes_per_device": snap.get("Total", 0),
        "peak_by_category": {k: v for k, v in snap.items() if k != "Total"},
    }
    print("memory:", mem)

    # -- dispatch counts + roofline (one device's step) ------------------------
    terms = tool.roofline_terms(counted)
    terms["kernels"] = dict(counted.kernels)
    print("counted: flops=%.3e bytes=%.3e coll=%.3e (%d ops)"
          % (counted.flops, counted.bytes, counted.collectives.total_operand_bytes, counted.ops))

    # useful-model-FLOPs ratio
    n_active = cfg.active_param_count()
    flops_model = model_flops(cfg, shape)
    hlo_flops_global = terms["hlo_flops"] * chips
    record.update(
        status="ok",
        kind=kind,
        chips=chips,
        trace_s=round(trace_s, 2),
        memory=mem,
        roofline=terms,
        model_flops=flops_model,
        hlo_flops_global=hlo_flops_global,
        useful_flop_ratio=(flops_model / hlo_flops_global) if hlo_flops_global else None,
        params=cfg.param_count(),
        active_params=n_active,
    )

    # --plan: the candidate's analytic roofline beside the counted terms, so
    # the tuner's predicted-vs-measured check reads both from one artifact
    if plan_spec:
        from repro_torch.tune import score as tune_score
        from repro_torch.tune import search as tune_search   # the function

        plan = base.parse_plan(plan_spec, devices=chips) if plan_spec != "auto" else None
        if plan is None:
            plan = tune_search(cfg, shape, chips, space=base.plan_space(arch),
                               default_remat=pcfg.remat).plan
        predicted = tune_score.score_plan(cfg, shape, plan, default_remat=pcfg.remat)
        record.update(
            plan=dataclasses.asdict(plan),
            plan_slug=plan.slug(),
            predicted_roofline=predicted.as_dict(),
        )
    return record


def model_flops(cfg, shape) -> int:
    """The cell's useful model flops, the reference's count: 6 (train) or 2
    flops a parameter and token, over its active parameters."""

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6 if shape.kind == "train" else 2) * cfg.active_param_count() * tokens


def cell_tag(plan_spec: str | None, tag: str = "") -> str:
    """The artifact tag of a cell: ``tag``, else, under ``--plan``, the
    plan's (per-candidate artifacts must not clobber the base cell)."""

    if plan_spec and not tag:
        return "plan-" + plan_spec.replace(",", "_").replace("=", "-").replace(":", "-")
    return tag


def artifact_path(arch: str, shape: str, multi_pod: bool, tag: str, *,
                  grid: str | None = None, artifacts: Path | None = None) -> Path:
    stem = f"{arch}__{shape}__{mesh_name(multi_pod, grid)}" + (f"__{tag}" if tag else "")
    return Path(artifacts or ARTIFACTS) / f"{stem}.json"


def _cell_done(path: Path, overrides: dict, tag: str) -> bool:
    """Incremental-skip key: the cell is done only when the artifact on disk
    was produced by the SAME (overrides, tag) request."""

    if not path.exists():
        return False
    try:
        rec = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return False          # unreadable/torn artifact: rerun the cell
    return rec.get("overrides", {}) == overrides and rec.get("tag", "") == tag


def _cell_cmd(arch, shape, multi_pod, overrides, tag, extra=()):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape]
    if multi_pod:
        cmd.append("--multi-pod")
    if overrides:
        cmd += ["--overrides", json.dumps(overrides)]
    if tag:
        cmd += ["--tag", tag]
    return cmd + list(extra)


def orchestrate(jobs: int, multi_pod_modes: list[bool], overrides: dict, tag: str,
                archs=None, shapes=None, timeout: int = 3600, *, device: str = "cuda",
                artifacts: Path | None = None):
    from repro_torch.configs import base

    out_dir = Path(artifacts or ARTIFACTS)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = []
    for mp in multi_pod_modes:
        for arch in archs or base.ARCHITECTURES:
            for shape in shapes or list(base.SHAPES):
                p = artifact_path(arch, shape, mp, tag, artifacts=out_dir)
                if _cell_done(p, overrides, tag):
                    continue
                cells.append((arch, shape, mp))
    print(f"{len(cells)} cells to run ({jobs} workers)", flush=True)
    extra = ["--device", device, "--artifacts", str(out_dir)]

    def one(cell):
        arch, shape, mp = cell
        t0 = time.time()
        try:
            proc = subprocess.run(
                _cell_cmd(arch, shape, mp, overrides, tag, extra),
                capture_output=True, text=True, timeout=timeout,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=str(ROOT),
            )
        except subprocess.TimeoutExpired:
            print(f"[TIMEOUT] {arch} {shape} mp={mp} ({time.time()-t0:.0f}s)", flush=True)
            return 124
        status = "ok" if proc.returncode == 0 else "FAIL"
        print(f"[{status}] {arch} {shape} mp={mp} ({time.time()-t0:.0f}s)", flush=True)
        if proc.returncode != 0:
            tail = "\n".join(proc.stdout.splitlines()[-5:] + proc.stderr.splitlines()[-15:])
            print(tail, flush=True)
        return proc.returncode

    with ThreadPoolExecutor(max_workers=jobs) as ex:
        rcs = list(ex.map(one, cells))
    print(f"done: {rcs.count(0)}/{len(rcs)} ok")
    return 0 if all(r == 0 for r in rcs) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true", help="--all over both grids")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--overrides", default="{}", help="ParallelConfig overrides (JSON)")
    ap.add_argument("--tag", default="", help="artifact suffix for perf experiments")
    ap.add_argument(
        "--plan",
        default=None,
        help="record this ParallelPlan candidate's analytic roofline terms "
        "in the artifact ('auto' = the repro_torch.tune winner for the cell); "
        "the artifact tag defaults to the plan slug",
    )
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the stand-ins' device (no card is used either way)")
    ap.add_argument("--artifacts", default=None, help="artifact directory")
    ap.add_argument("--grid", default=None, metavar="DxM",
                    help="a (data, model) grid in place of the production one")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (a custom <kind>_<seq> shape needs it)")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides)
    artifacts = Path(args.artifacts) if args.artifacts else ARTIFACTS

    if args.all:
        modes = [False, True] if args.both else [args.multi_pod]
        archs = [args.arch] if args.arch else None
        shapes = [args.shape] if args.shape else None
        return orchestrate(args.jobs, modes, overrides, args.tag, archs, shapes,
                           args.timeout, device=args.device, artifacts=artifacts)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    tag = cell_tag(args.plan, args.tag)
    status = 0
    try:
        record = run_cell(args.arch, args.shape, args.multi_pod, overrides, tag,
                          plan_spec=args.plan, device=args.device, grid=args.grid,
                          batch=args.batch, smoke=args.smoke)
    except Exception as e:  # lint: allow-broad-except — written as status: error, exit 1
        traceback.print_exc()
        record = {"arch": args.arch, "shape": args.shape,
                  "mesh": mesh_name(args.multi_pod, args.grid), "tag": tag,
                  "overrides": overrides, "device": args.device,
                  "status": "error", "error": f"{type(e).__name__}: {e}"}
        status = 1
    artifacts.mkdir(parents=True, exist_ok=True)
    path = artifact_path(args.arch, record["shape"], args.multi_pod, tag, grid=args.grid,
                         artifacts=artifacts)
    path.write_text(json.dumps(record, indent=1, default=_json_default))
    print("wrote", path, "status:", record["status"])
    return status


def _json_default(x: Any):
    return str(x)


if __name__ == "__main__":
    sys.exit(main())
