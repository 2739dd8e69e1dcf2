"""Atomic, async checkpointing on the parallel-IO request engine —
:mod:`repro.checkpoint.manager` over tensors, in the **same on-disk
format**: a checkpoint written by either package restores in the other.

Layout::

    <dir>/step_000100/            one core.io File dataset per step
        manifest.json             array records (fragments, offsets, checksums)
        <leaf>.<offset>.npy       per-leaf fragments
        extra.json                caller's extra (the trainer's step)
        _COMPLETE                 atomic completion marker (written last)
    <dir>/latest                  text file: the newest complete step

Leaves are named by their path in the tree, as the reference names them
(``params/layers/layer/attn/wq``, ``opt/mu/embed``, ``opt/step``; an int8
moment's payload and scales ``opt/mu/embed/q`` and ``opt/mu/embed/scale``):
dict keys in sorted order, dataclass fields in declaration order.  A
plain tensor is one fragment at offset 0.  A DTensor leaf (placed state,
:mod:`repro_torch.sharding`) is written as its shards: each rank writes its
local shard as a fragment at its global offset (one rank of those holding
the same shard), as the reference writes ``addressable_shards``.  With a
communicator of several ranks the save joins before it returns: every rank
writes and verifies its fragments, the fragment records are gathered on
the communicator's rank 0, which commits the one manifest, and a barrier
returns every rank after the commit.  A restore reassembles each leaf from
its fragments and places it as its template is placed, on any mesh (or
whole): the two packages restore each other's checkpoints either way.

* a crash mid-save never corrupts an older checkpoint (new directory +
  completion marker); restore picks the newest *complete* step;
* **async save on the request engine**: the device→host copy is
  synchronous (the trainer's step updates its tensors in place right after
  ``save()`` returns), then the file writes run as I/O requests, one per
  dtype bucket of at most :data:`BUCKET_BYTES` (the reference has one per
  dtype; a model's fp32 moments are tens of GB, and hashing and writing them
  from one thread would take a core minutes), joined with ``when_all`` and
  chained with ``then()`` into a **single manifest commit**, the durability
  point;
* **errors are never swallowed**: ``wait()`` re-raises a background failure
  as ``ERR_IO``, and a failed save never writes ``_COMPLETE`` or advances
  ``latest``; every fragment is read back and checksum-verified before the
  manifest commits;
* restore reads each record through ``set_view`` with its recorded storage
  etype, so bf16 comes back bit for bit from its uint16 storage; the
  records are read as concurrent ``iread_at_all`` requests, one file
  handle (and view) each;
* an ``atexit`` hook joins the outstanding save.

Under analysis recording an async save and its join are recorded, as the
reference's are (an async save never joined is an ``unjoined-save``
finding).
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import logging
import os
import re
import shutil
import sys
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.analysis import events as analysis_events
from repro_torch.core import datatypes, errors, tool
from repro_torch.core import io as pio
from repro_torch.core.descriptors import Mode
from repro_torch.core.futures import Future, flatten, unflatten, when_all

#: The most bytes one write request of a save takes (its fragments are
#: hashed, written and read back on one host thread).
BUCKET_BYTES = 1 << 29

tool.pvar_register("ckpt_save", "checkpoint saves issued (async or sync)")
tool.pvar_register("ckpt_save_failed", "checkpoint saves that surfaced an I/O error")
tool.pvar_register("ckpt_restore", "checkpoint restores")
tool.pvar_register("ckpt_wait", "checkpoint completions joined (wait)")


def _is_dtensor(x) -> bool:
    from repro_torch.sharding.local import is_dtensor

    return is_dtensor(x)


def _shards(leaf: Any, writer: bool) -> tuple[tuple, list[tuple[tuple[int, ...], Any]]]:
    """(global shape, [(global offset, local buffer)]) of the pieces this
    rank writes of ``leaf``: a DTensor's local shard if this rank is the
    first (coordinate 0 on every mesh dim that does not split it) of those
    that hold it; a plain leaf whole if this rank is the ``writer``."""

    if not _is_dtensor(leaf):
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        return shape, [((0,) * len(shape), leaf)] if writer else []
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, place = leaf.device_mesh, leaf.placements
    shape = tuple(leaf.shape)
    first = all(pl.is_shard() or mesh.get_local_rank(i) == 0 for i, pl in enumerate(place))
    _, offset = compute_local_shape_and_global_offset(shape, mesh, place)
    return shape, [(tuple(int(o) for o in offset), leaf.to_local())] if first else []


def _placed_like(full: torch.Tensor, tmpl: Any) -> torch.Tensor:
    """``full`` (a restored whole leaf, on the host) placed as the DTensor
    ``tmpl``: this rank's shard moved to its device."""

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, place = tmpl.device_mesh, tmpl.placements
    local_shape, offset = compute_local_shape_and_global_offset(tuple(tmpl.shape), mesh, place)
    idx = tuple(slice(o, o + n) for o, n in zip(offset, local_shape))
    local = full[idx].to(tmpl.to_local().device).contiguous()
    return DTensor.from_local(local, mesh, place, run_check=False, shape=tmpl.shape,
                              stride=tmpl.stride())


def _flatten_with_names(tree: Any) -> list[tuple[str, Any]]:
    """(path name, leaf) of every leaf, in :func:`flatten`'s order, named
    as the reference names them."""

    out: list[tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, path + (str(i),))
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), path + (f.name,))
        else:
            out.append(("/".join(path) or "leaf", node))

    walk(tree, ())
    return out


log = logging.getLogger("repro_torch.checkpoint")

_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


@atexit.register
def _drain_managers_at_exit() -> None:
    for mgr in list(_MANAGERS):
        try:
            mgr.wait()
        except errors.Error as e:
            print(
                f"repro_torch.checkpoint: pending save failed at interpreter exit: {e}",
                file=sys.stderr,
            )


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        keep: int = 3,
        async_save: bool = True,
        verify: bool = True,
        injector: Any | None = None,
        comm: Any | None = None,
    ):
        self.directory = directory
        #: the communicator whose ranks save together (``None``: this
        #: process alone)
        self.comm = comm if comm is not None and comm.size() > 1 else None
        self.keep = keep
        self.async_save = async_save
        self.verify = verify
        #: optional runtime.faults.FaultInjector whose ``check_io`` is wired
        #: as the fragment write hook (torn-save fault injection)
        self.injector = injector
        self._pending: pio.IORequest | None = None
        os.makedirs(directory, exist_ok=True)
        _MANAGERS.add(self)

    # -- save ----------------------------------------------------------------

    def save(
        self,
        step: int,
        tree: Any,
        *,
        extra: dict | None = None,
        meta: dict | None = None,
    ) -> Future:
        """Save a tree checkpoint for ``step``.

        Returns the completion request: a host future resolving to the step
        directory once every fragment is durable (read-back verified) and
        the manifest, ``_COMPLETE`` marker and ``latest`` pointer are
        committed.  With ``async_save`` the request runs in the background;
        :meth:`wait` (called before the next save and at exit) joins it and
        **re-raises any failure** as ``ERR_IO``.  ``meta`` tags the manifest
        with writer context (``manifest["meta"]``).
        """

        self.wait()
        tool.pvar_count("ckpt_save")
        step_dir = os.path.join(self.directory, f"step_{step:08d}")

        # synchronous device→host copy: the caller may overwrite its
        # tensors in place as soon as save() returns
        records: dict[str, dict] = {}
        buckets: dict[str, list[list[tuple[str, np.ndarray]]]] = {}
        entry_by_frag: dict[str, dict] = {}
        writer = self.comm is None or self.comm.rank() == 0
        for name, leaf in _flatten_with_names(tree):
            shape, frags = _shards(leaf, writer)
            entries = []
            dtype = datatypes.dtype_name(leaf.dtype) if isinstance(leaf, torch.Tensor) \
                else str(np.asarray(leaf).dtype)
            for start, local in frags:
                buf, dtype = pio.to_host(local)
                fragname = f"{name.replace('/', '.')}.{'_'.join(map(str, start))}.npy"
                if fragname in entry_by_frag:
                    # sanitised names can collide ("a/b" vs {"a": {"b"}})
                    errors.fail(
                        errors.ErrorClass.ERR_IO,
                        f"leaf {name!r} collides with another leaf on "
                        f"fragment {fragname!r} after '/'→'.' sanitisation",
                    )
                chunks = buckets.setdefault(dtype, [[]])
                if chunks[-1] and sum(b.nbytes for _, b in chunks[-1]) + buf.nbytes \
                        > BUCKET_BYTES:
                    chunks.append([])
                chunks[-1].append((fragname, buf))
                entry = {
                    "fragment": fragname,
                    "offset": list(start),
                    "shape": list(buf.shape),
                    # filled by the commit continuation: digests are computed
                    # on the I/O threads, off the issue path
                    "checksum": None,
                }
                entry_by_frag[fragname] = entry
                entries.append(entry)
            record = {"name": name, "shape": list(shape), "dtype": dtype,
                      "fragments": entries}
            alias = pio.storage_alias(dtype)
            if alias is not None:
                record["etype"] = str(alias)
            records[name] = record

        f = pio.open(step_dir, Mode.CREATE | Mode.WRONLY, checksum=True, verify=self.verify)
        if self.injector is not None and hasattr(self.injector, "check_io"):
            f.write_hook = self.injector.check_io

        # one I/O request per dtype bucket (of at most BUCKET_BYTES), joined
        # into a single commit
        reqs = [
            f.awrite_fragments(f"ckpt[{step}] bucket {dt}.{i}", frags, start=False)
            for dt, chunks in buckets.items()
            for i, frags in enumerate(chunks)
        ]

        comm = self.comm

        def commit(joined: Future) -> str:
            # joins every bucket; a failed write raises ERR_IO here
            for sums in joined.get():
                for fragname, digest in sums.items():
                    entry_by_frag[fragname]["checksum"] = digest
            if comm is not None and not _gather_records(comm, records):
                return step_dir   # another rank commits the manifest
            f.commit_manifest(records, meta)  # ONE manifest sync point per step
            if extra:
                pio._atomic_write(
                    os.path.join(step_dir, "extra.json"), json.dumps(extra).encode()
                )
            pio._atomic_write(os.path.join(step_dir, "_COMPLETE"), b"ok")
            pio._atomic_write(os.path.join(self.directory, "latest"), str(step).encode())
            self._gc()
            return step_dir

        chain = when_all(reqs).then(commit)  # lazy: nothing blocks here

        def drive():
            for r in reqs:
                r.start()  # fan the bucket threads out together
            return chain._wait_value()

        completion = pio.IORequest(f"ckpt[{step}] commit", drive)
        if self.async_save and comm is None:
            if analysis_events.RECORDING:
                # only async saves can dangle: a sync save joins inline below
                analysis_events.record_ckpt("ckpt_save", id(self), step,
                                            rank=analysis_events.process_rank())
            self._pending = completion
        else:
            completion._wait_value()
            if comm is not None:
                # every rank returns once the manifest is committed
                _barrier(comm)
        return completion

    def wait(self) -> str | None:
        """Join the outstanding save and return its step directory; a
        background failure is **re-raised here as ``ERR_IO``**."""

        req, self._pending = self._pending, None
        if req is None:
            return None
        if analysis_events.RECORDING:
            analysis_events.record_ckpt("ckpt_join", id(self),
                                        rank=analysis_events.process_rank())
        if not req.valid():
            # caller consumed the returned request (get/then); only re-raise
            # a failure that was never delivered to anyone
            exc = req.drain()
            if exc is not None and not req.delivered:
                raise exc
            return None
        tool.pvar_count("ckpt_wait")
        return req.get()

    def pending(self) -> bool:
        """Is a background save still in flight (``MPI_Test`` style)?"""

        return self._pending is not None and not self._pending.test()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.directory, d, "_COMPLETE")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None, *, shardings: Any = None):
        """Restore into the structure of ``template``.

        ``shardings``: a matching tree of target devices (or ``None``
        leaves), the port's counterpart of the reference's target
        shardings; by default each leaf goes to its template's device.  Each
        record is read through ``set_view`` with its recorded storage etype;
        checksums verify every fragment on the way back in.  Returns
        (tree, step).
        """

        # join the in-flight save BEFORE resolving the step, tolerantly: a
        # torn save is skipped, logged and counted
        try:
            self.wait()
        except errors.Error as e:
            tool.pvar_count("ckpt_save_failed")
            log.warning("pending save failed; restoring newest complete step: %s", e)
        step = step if step is not None else self.latest_step()
        errors.check(
            step is not None, errors.ErrorClass.ERR_IO, f"no checkpoint in {self.directory}"
        )
        tool.pvar_count("ckpt_restore")
        step_dir = os.path.join(self.directory, f"step_{step:08d}")
        arrays = pio.open(step_dir, Mode.RDONLY).manifest()["arrays"]
        names = [n for n, _ in _flatten_with_names(template)]
        flat_t, treedef = flatten(template)
        flat_s = flatten(shardings)[0] if shardings is not None else [None] * len(flat_t)
        reqs = []
        for name, tmpl, dev in zip(names, flat_t, flat_s):
            rec = arrays.get(name)
            if rec is None:
                errors.fail(errors.ErrorClass.ERR_IO, f"array {name!r} not in {step_dir}")
            if dev is None and isinstance(tmpl, torch.Tensor) and not _is_dtensor(tmpl):
                dev = tmpl.device
            f = pio.open(step_dir, Mode.RDONLY, checksum=True)
            f.set_view(etype=rec.get("etype"))
            reqs.append(f.iread_at_all(name, dev))
        restored = []
        for tmpl, arr in zip(flat_t, when_all(reqs).get()):
            if isinstance(tmpl, torch.Tensor) and arr.dtype != tmpl.dtype:
                arr = arr.to(tmpl.dtype)
            if _is_dtensor(tmpl):
                arr = _placed_like(arr, tmpl)
            restored.append(arr)
        return unflatten(treedef, restored), step

    def extra(self, step: int) -> dict:
        p = os.path.join(self.directory, f"step_{step:08d}", "extra.json")
        if os.path.exists(p):
            with open(p) as fh:
                return json.load(fh)
        return {}

    def manifest_meta(self, step: int | None = None) -> dict:
        """The writer-context tags of a step's manifest; ``{}`` without."""

        step = step if step is not None else self.latest_step()
        if step is None:
            return {}
        step_dir = os.path.join(self.directory, f"step_{step:08d}")
        f = pio.open(step_dir, Mode.RDONLY)
        return f.manifest().get("meta", {})


def _gather_records(comm, records: dict) -> bool:
    """Merge every rank's fragment records on the communicator's rank 0
    (``records`` updated there); True on the rank that commits."""

    import torch.distributed as dist

    ranks = comm.global_ranks()
    box = [None] * comm.size() if comm.rank() == 0 else None
    dist.gather_object(records, box, dst=ranks[0], group=comm.process_group())
    if comm.rank() != 0:
        return False
    for other in box[1:]:
        for name, rec in other.items():
            records[name]["fragments"] += rec["fragments"]
    for rec in records.values():
        rec["fragments"].sort(key=lambda e: e["offset"])
    return True


def _barrier(comm) -> None:
    import torch.distributed as dist

    dist.barrier(group=comm.process_group())
