"""Parallel IO (paper §II — MPI 4.0 chapter 14, ``MPI_File_*``) —
:mod:`repro.core.io` over tensors, in the reference's on-disk format.

A :class:`File` is a *directory dataset*: each process writes the fragments
it owns (``.npy`` files named by their global offset) plus an atomically
renamed JSON manifest.  The format is the reference's, byte for byte, so a
dataset written by either package reads in the other:

* a record holds the array's name, global shape, dtype (the numpy name:
  ``float32``, ``bfloat16``, ...) and its fragments (offset, shape,
  checksum);
* dtypes that ``np.save`` cannot store (bfloat16, fp8) are stored as the
  unsigned integer of the same width (:func:`storage_alias`) and read back
  as themselves, bit for bit;
* checksums are the first 16 hex digits of the SHA-256 of a fragment's
  bytes.

The chapter-14 surface and its mapping are the reference's:
``MPI_File_open`` → :func:`open`; ``MPI_File_write_at_all`` /
``iwrite_at_all`` / ``iread_at_all`` → the :class:`File` methods of those
names, the nonblocking ones returning an :class:`IORequest` that runs on a
host thread; ``MPI_File_*_at_all_begin/end`` → the split collectives (one
active per handle, ``ERR_REQUEST`` otherwise); ``MPI_File_set_view`` →
:meth:`File.set_view`, an etype (storage representation) and a filetype (a
:class:`~repro_torch.core.datatypes.DataType` packed layout, paged);
``MPI_File_sync`` → :meth:`File.commit_manifest`.

Completion of the manifest write is the sync point; nonblocking operations
complete at ``get()``/``wait()`` on their request, where a background
failure is re-raised as ``ERR_IO``.  The reference's ``analysis_events``
hooks (MUST-style recording of split collectives) wait for the analyzer's
port, ROADMAP A15, and are left out here.
"""

from __future__ import annotations

import atexit
import builtins
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import threading
import weakref
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import datatypes, errors, tool
from repro_torch.core.descriptors import FileSpec, Mode
from repro_torch.core.futures import DeferredFuture

MANIFEST = "manifest.json"

tool.pvar_register("io_write", "blocking collective file writes (MPI_File_write_at_all)")
tool.pvar_register("io_read", "blocking collective file reads (MPI_File_read_at_all)")
tool.pvar_register("io_iwrite", "nonblocking collective writes issued (MPI_File_iwrite_at_all)")
tool.pvar_register("io_iread", "nonblocking collective reads issued (MPI_File_iread_at_all)")
tool.pvar_register("io_split_begin", "split collectives begun (MPI_File_*_at_all_begin)")
tool.pvar_register("io_set_view", "file views installed (MPI_File_set_view)")
tool.pvar_register("io_manifest_commit", "manifest sync points written (MPI_File_sync)")
tool.pvar_register("io_bytes_written", "fragment bytes written (accumulating)")
tool.pvar_register("io_bytes_read", "fragment bytes read (accumulating)")


def _tmp_in(d: str) -> tuple[int, str]:
    os.makedirs(d, exist_ok=True)
    return tempfile.mkstemp(dir=d, prefix=".tmp-")


def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = _tmp_in(os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_save(path: str, buf: np.ndarray) -> int:
    """``np.save`` of ``buf`` to ``path`` through a renamed temporary file
    (no second copy of the bytes in memory); returns the file's size."""

    fd, tmp = _tmp_in(os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, buf, allow_pickle=False)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return os.path.getsize(path)


def _c_order(buf: np.ndarray) -> np.ndarray:
    """``buf`` in C order, 0-d kept 0-d (``np.ascontiguousarray`` makes it
    1-d)."""

    return buf if buf.flags.c_contiguous else buf.copy(order="C")


def _checksum(buf: np.ndarray) -> str:
    flat = _c_order(buf).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()[:16]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        errors.fail(errors.ErrorClass.ERR_TYPE, f"unknown dtype {name!r}")
    return dt


def storage_alias(dtype: Any) -> np.dtype | None:
    """The on-disk alias for dtypes ``np.save`` cannot serialise (bfloat16,
    fp8, ...): the same-itemsize unsigned integer, so the bytes round-trip
    exactly.  ``None`` for natively serialisable dtypes.  ``dtype`` is a
    name, a numpy dtype or a torch dtype."""

    if isinstance(dtype, torch.dtype):
        dtype = datatypes.dtype_name(dtype)
    if isinstance(dtype, str):
        try:
            np_dt = np.dtype(dtype)
        except TypeError:
            return np.dtype(f"uint{_torch_dtype(dtype).itemsize * 8}")
    else:
        np_dt = np.dtype(dtype)
    if np_dt.kind in "biufc":
        return None
    return np.dtype(f"uint{np_dt.itemsize * 8}")


def _carrier(name: str) -> np.dtype:
    """The numpy dtype that holds a ``name`` array on the host: itself, or
    its storage alias."""

    alias = storage_alias(name)
    return alias if alias is not None else np.dtype(name)


def to_host(array: Any) -> tuple[np.ndarray, str]:
    """(host numpy buffer, dtype name) of a tensor or numpy array: the
    buffer in the dtype itself where numpy has it, else in its storage
    alias (the same bytes)."""

    if isinstance(array, torch.Tensor):
        # always a copy: the caller may update its tensor in place at once
        t = array.detach().to("cpu", memory_format=torch.contiguous_format, copy=True)
        name = datatypes.dtype_name(t.dtype)
        alias = storage_alias(name)
        if alias is None:
            return t.numpy(), name
        signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[alias.itemsize]
        return t.view(signed).numpy().view(alias), name
    arr = np.asarray(array)
    name = str(arr.dtype)
    alias = storage_alias(arr.dtype)
    return (arr if alias is None else _c_order(arr).view(alias)), name


def from_host(buf: np.ndarray, name: str, device=None) -> torch.Tensor:
    """The tensor of dtype ``name`` whose bytes ``buf`` holds (the inverse
    of :func:`to_host`), on ``device`` (the CPU by default)."""

    buf = _c_order(buf)
    alias = storage_alias(name)
    if alias is None:
        t = torch.from_numpy(buf.copy() if not buf.flags.writeable else buf)
    else:
        signed = np.dtype(f"int{alias.itemsize * 8}")
        t = torch.from_numpy(np.array(buf.view(signed))).view(_torch_dtype(name))
    return t if device is None else t.to(device)


# ---------------------------------------------------------------------------
# request-based nonblocking IO (MPI_File_i*)
# ---------------------------------------------------------------------------

_OUTSTANDING: "weakref.WeakSet[IORequest]" = weakref.WeakSet()


class IORequest(DeferredFuture):
    """A nonblocking file operation's request (``MPI_File_i*``).

    The operation body runs on a background thread; the request itself is a
    host :class:`~repro_torch.core.futures.DeferredFuture`, so it chains
    with ``then()`` and joins with ``when_all`` like every other request.
    ``get()``/``wait()`` join the thread and re-raise any failure — typed
    :class:`~repro_torch.core.errors.Error`\\ s pass through unchanged,
    anything else is wrapped as ``ERR_IO`` — so a background failure always
    surfaces at the completion call, never as a silent success.  Threads are
    daemonic, but every live request is joined by an ``atexit`` hook.
    """

    def __init__(self, op: str, fn: Callable[[], Any], *, start: bool = True):
        self.op = op
        self._exc: BaseException | None = None
        self._result: Any = None
        self._event = threading.Event()
        self._start_lock = threading.Lock()
        self._launched = False
        self._delivered = False

        def run():
            try:
                self._result = fn()
            except errors.Error as e:
                self._exc = e
            except BaseException as e:  # lint: allow-broad-except — forwarded to the joiner, never dropped
                exc = errors.exception(errors.ErrorClass.ERR_IO, f"{op}: {e!r}")
                exc.__cause__ = e
                self._exc = exc
            finally:
                self._event.set()

        super().__init__(self._join, probe=self._event.is_set)
        self._thread = threading.Thread(target=run, name=f"repro-io:{op}", daemon=True)
        _OUTSTANDING.add(self)
        if start:
            self.start()

    def start(self) -> "IORequest":
        """Activate the request (idempotent).  ``start=False`` construction
        is the two-phase form: a batch issuer creates its requests cheaply
        and one thread fans them out."""

        with self._start_lock:
            if not self._launched:
                self._launched = True
                self._thread.start()
        return self

    @property
    def delivered(self) -> bool:
        """Has the captured failure (if any) been raised to a caller?"""

        return self._delivered

    def _join(self) -> Any:
        self.start()  # waiting an inactive request activates it first
        self._thread.join()
        if self._exc is not None:
            self._delivered = True
            raise self._exc
        return self._result

    def drain(self) -> BaseException | None:
        """Join without raising; return the captured failure, if any."""

        self.start()
        self._thread.join()
        return self._exc


@atexit.register
def _join_outstanding_at_exit() -> None:
    for req in list(_OUTSTANDING):
        exc = req.drain()
        if exc is not None and not req.delivered:
            print(
                f"repro_torch.core.io: background {req.op} failed at interpreter "
                f"exit: {exc}",
                file=sys.stderr,
            )


# ---------------------------------------------------------------------------
# file views (MPI_File_set_view)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FileView:
    """An installed file view: ``etype`` is the elementary storage
    representation (fragments are stored as this same-itemsize dtype and
    reinterpreted back on read); ``filetype`` a
    :class:`~repro_torch.core.datatypes.DataType` whose packed group buffers
    are stored page by page."""

    etype: np.dtype | None = None
    filetype: "datatypes.DataType | None" = None
    num_pages: int = 1


class File:
    """A parallel dataset directory (``MPI_File`` analogue)."""

    def __init__(self, path: str, spec: FileSpec | None = None):
        self.path = path
        self.spec = spec or FileSpec()
        # MPI_ERR_FILE_EXISTS semantics: EXCL rejects an existing dataset
        # whether or not CREATE is also set
        if Mode.EXCL in self.spec.mode and os.path.exists(os.path.join(path, MANIFEST)):
            errors.fail(errors.ErrorClass.ERR_FILE, f"{path} already exists (EXCL)")
        if Mode.CREATE in self.spec.mode:
            os.makedirs(path, exist_ok=True)
        self._view = FileView()
        self._split: tuple[str, str, IORequest] | None = None
        self._manifest_cache: dict | None = None
        self._manifest_lock = threading.Lock()
        #: fault-injection / test hook, called with each fragment name just
        #: before its write (see ``runtime.faults.FaultInjector.check_io``)
        self.write_hook: Callable[[str], None] | None = None

    # -- views ---------------------------------------------------------------

    def set_view(
        self,
        etype: Any | None = None,
        filetype: Any | None = None,
        *,
        num_pages: int | None = None,
    ) -> "File":
        """``MPI_File_set_view``: install (or, with no arguments, reset) the
        view through which subsequent collective accesses run.  ``filetype``
        may be a :class:`~repro_torch.core.datatypes.DataType` or any
        compliant example aggregate; a reader must install a view whose
        group signature matches the writer's (``ERR_IO`` otherwise)."""

        if filetype is not None and not isinstance(filetype, datatypes.DataType):
            filetype = datatypes.datatype_of(filetype)
        et = None
        if etype is not None:
            if isinstance(etype, torch.dtype):
                etype = datatypes.dtype_name(etype)
            try:
                et = np.dtype(etype)
            except TypeError:
                errors.fail(errors.ErrorClass.ERR_TYPE,
                            f"etype {etype} is not a serialisable storage dtype")
            errors.check(
                et.kind in "biufc",
                errors.ErrorClass.ERR_TYPE,
                f"etype {et} is not a serialisable storage dtype",
            )
        n = 1 if num_pages is None else int(num_pages)
        errors.check(
            n >= 1, errors.ErrorClass.ERR_ARG, f"set_view needs >= 1 page, got {n}"
        )
        if et is not None and filetype is not None:
            for d in filetype.group_dtypes:
                errors.check(
                    d.itemsize == et.itemsize,
                    errors.ErrorClass.ERR_TYPE,
                    f"etype {et} (itemsize {et.itemsize}) cannot represent "
                    f"group dtype {datatypes.dtype_name(d)}",
                )
        self._view = FileView(et, filetype, n)
        tool.pvar_count("io_set_view")
        return self

    @property
    def view(self) -> FileView:
        return self._view

    # -- collective writes ---------------------------------------------------

    def _check_writable(self) -> None:
        errors.check(
            Mode.WRONLY in self.spec.mode or Mode.RDWR in self.spec.mode,
            errors.ErrorClass.ERR_FILE,
            f"{self.path} not opened for writing",
        )

    def _storage_dtype(self, dtype: np.dtype) -> np.dtype | None:
        """The dtype a host buffer of ``dtype`` is stored as, or ``None``
        for as-is."""

        et = self._view.etype
        if et is not None and et != dtype:
            errors.check(
                et.itemsize == dtype.itemsize,
                errors.ErrorClass.ERR_TYPE,
                f"etype {et} (itemsize {et.itemsize}) cannot store dtype {dtype}",
            )
            return et
        return storage_alias(dtype)

    def _gather(self, name: str, array: Any) -> tuple[dict, list[tuple[str, np.ndarray]]]:
        """Synchronous device→host gather: the fragment buffers plus the
        manifest record describing them.  A tensor of one process is one
        fragment at offset 0.  The buffers are host copies before control
        returns, so a pending request never races the caller's tensors.
        The checkpoint manager keeps its own variant of this gather, as the
        reference's does."""

        if self._view.filetype is not None:
            return self._gather_view(name, array)
        buf, dtype = to_host(array)
        frag = f"{name}.0.npy"
        entry = {
            "fragment": frag,
            "offset": [0] * buf.ndim,
            "shape": list(buf.shape),
            "checksum": _checksum(buf) if self.spec.checksum else None,
        }
        record = {"name": name, "shape": list(buf.shape), "dtype": dtype, "fragments": [entry]}
        if self._view.etype is not None:
            record["etype"] = str(self._view.etype)
        return record, [(frag, buf)]

    def _gather_view(self, name: str, aggregate: Any) -> tuple[dict, list]:
        """Filetype-view gather: pack the aggregate into the datatype's
        per-dtype group buffers and page them (one fragment per page)."""

        dt = self._view.filetype
        bufs = dt.pack(aggregate)
        bounds = dt.page_bounds(self._view.num_pages)
        entries, frags = [], []
        for g, (buf, pages) in enumerate(zip(bufs, bounds)):
            host = to_host(buf)[0]
            for p, (off, length) in enumerate(pages):
                page = host[off : off + length]
                frag = f"{name}.g{g}.p{p}.npy"
                frags.append((frag, page))
                entries.append(
                    {
                        "fragment": frag,
                        "group": g,
                        "offset": [int(off)],
                        "shape": [int(length)],
                        "checksum": _checksum(page) if self.spec.checksum else None,
                    }
                )
        record = {
            "name": name,
            "view": {**dt.layout_signature(), "num_pages": self._view.num_pages},
            "fragments": entries,
        }
        if self._view.etype is not None:
            record["etype"] = str(self._view.etype)
        return record, frags

    def write_at_all(self, name: str, array: Any) -> dict:
        """Collective write of this process's fragments; one manifest record
        describes the whole.  The manifest write is the sync point."""

        self._check_writable()
        tool.pvar_count("io_write")
        record, frags = self._gather(name, array)
        for frag, buf in frags:
            self._write_fragment(frag, buf)
        self._update_manifest(name, record)
        return record

    def iwrite_at_all(self, name: str, array: Any, *, commit: bool = True) -> IORequest:
        """``MPI_File_iwrite_at_all``: the device→host gather happens here,
        the fragment and manifest writes on a background thread.  A failed
        write raises ``ERR_IO`` from the request's ``get()``/``wait()``.
        ``commit=False`` defers the manifest update: the request resolves to
        the record, for a later :meth:`commit_manifest`."""

        self._check_writable()
        tool.pvar_count("io_iwrite")
        record, frags = self._gather(name, array)

        def work():
            for frag, buf in frags:
                self._write_fragment(frag, buf)
            if commit:
                self._update_manifest(name, record)
            return record

        return IORequest(f"iwrite_at_all({name!r})", work)

    def awrite_fragments(
        self, op: str, frags: list[tuple[str, np.ndarray]], *, start: bool = True
    ) -> IORequest:
        """One request over pre-gathered ``(fragment, buffer)`` pairs — the
        checkpoint manager's per-dtype-bucket write.  No manifest update.
        Resolves to ``{fragment: checksum}``, computed on the background
        thread."""

        self._check_writable()

        def work():
            sums = {}
            for frag, buf in frags:
                digest = self._write_fragment(frag, buf)
                sums[frag] = digest if self.spec.checksum else None
            return sums

        return IORequest(op, work, start=start)

    def _write_fragment(self, frag: str, buf: np.ndarray) -> str:
        """Store one fragment atomically; with ``verify``, read it back and
        compare checksums.  Returns the fragment's checksum."""

        if self.write_hook is not None:
            self.write_hook(frag)
        store = self._storage_dtype(buf.dtype)
        if store is not None:
            buf = _c_order(buf).view(store)
        digest = _checksum(buf)
        path = os.path.join(self.path, frag)
        nbytes = _atomic_save(path, buf)
        if self.spec.verify:
            # data integrity, not interface validation: raises even with the
            # error_checking cvar off (a torn write must never read as ok)
            back = np.load(path, allow_pickle=False)
            if _checksum(back) != digest:
                errors.fail(
                    errors.ErrorClass.ERR_IO, f"read-back verify failed for {frag}"
                )
        tool.pvar_add("io_bytes_written", nbytes)
        return digest

    # -- the manifest sync point ----------------------------------------------

    def commit_manifest(self, records: dict[str, dict], meta: dict | None = None) -> None:
        """Merge ``records`` and write the manifest **once**, atomically —
        the explicit ``MPI_File_sync``.  ``meta`` — writer-context tags
        merged into ``manifest["meta"]``."""

        with self._manifest_lock:
            manifest = self.manifest()
            for name, record in records.items():
                manifest["arrays"][name] = record
            if meta:
                manifest.setdefault("meta", {}).update(meta)
            _atomic_write(
                os.path.join(self.path, MANIFEST),
                json.dumps(manifest, indent=1).encode(),
            )
            self._manifest_cache = manifest
        tool.pvar_count("io_manifest_commit")

    def _update_manifest(self, name: str, record: dict) -> None:
        self.commit_manifest({name: record})

    # -- split collectives (MPI_File_*_at_all_begin / _end) --------------------

    def write_at_all_begin(self, name: str, array: Any) -> None:
        """``MPI_File_write_at_all_begin``: at most one split collective may
        be active per file handle (``ERR_REQUEST`` otherwise)."""

        self._check_split_free()
        tool.pvar_count("io_split_begin")
        self._split = ("write", name, self.iwrite_at_all(name, array))

    def write_at_all_end(self, name: str) -> dict:
        """Complete the split collective write; returns the manifest record.
        Failures surface here as ``ERR_IO``."""

        return self._split_end("write", name)

    def read_at_all_begin(self, name: str, device: Any | None = None) -> None:
        """``MPI_File_read_at_all_begin``: start the split collective read."""

        self._check_split_free()
        tool.pvar_count("io_split_begin")
        self._split = ("read", name, self.iread_at_all(name, device))

    def read_at_all_end(self, name: str) -> Any:
        return self._split_end("read", name)

    def _check_split_free(self) -> None:
        active = self._split
        errors.check(
            active is None,
            errors.ErrorClass.ERR_REQUEST,
            f"split collective already active on {self.path}"
            + (f" ({active[0]}_at_all({active[1]!r}))" if active else ""),
        )

    def _split_end(self, kind: str, name: str) -> Any:
        errors.check(
            self._split is not None,
            errors.ErrorClass.ERR_REQUEST,
            f"{kind}_at_all_end({name!r}) without a matching begin",
        )
        k, n, req = self._split
        errors.check(
            (k, n) == (kind, name),
            errors.ErrorClass.ERR_REQUEST,
            f"{kind}_at_all_end({name!r}) does not match the active split "
            f"collective {k}_at_all({n!r})",
        )
        self._split = None
        return req.get()

    # -- collective reads ------------------------------------------------------

    def manifest(self, *, refresh: bool = False) -> dict:
        p = os.path.join(self.path, MANIFEST)
        if self._manifest_cache is None or refresh:
            if not os.path.exists(p):
                return {"version": 1, "arrays": {}}  # absence is not cached
            with builtins.open(p) as f:
                self._manifest_cache = json.load(f)
        return self._manifest_cache

    def read_at_all(self, name: str, device: Any | None = None) -> Any:
        """Collective read: reassemble an array from its fragments onto
        ``device`` (the CPU by default) — the port's counterpart of the
        reference's target sharding; under a filetype view, the unpacked
        aggregate."""

        tool.pvar_count("io_read")
        return self._read(name, device)

    def iread_at_all(self, name: str, device: Any | None = None) -> IORequest:
        """``MPI_File_iread_at_all``: nonblocking collective read."""

        tool.pvar_count("io_iread")
        return IORequest(f"iread_at_all({name!r})", lambda: self._read(name, device))

    def _read(self, name: str, device: Any | None = None) -> Any:
        rec = self.manifest()["arrays"].get(name)
        if rec is None:
            errors.fail(errors.ErrorClass.ERR_IO, f"array {name!r} not in {self.path}")
        if "view" in rec:
            return self._read_view(name, rec, device)
        carrier = _carrier(rec["dtype"])
        out = np.zeros(rec["shape"], dtype=carrier)
        for e in rec["fragments"]:
            buf = self._load_fragment(e, carrier, rec)
            idx = tuple(slice(o, o + s) for o, s in zip(e["offset"], e["shape"]))
            out[idx] = buf
        return from_host(out, rec["dtype"], device)

    def _read_view(self, name: str, rec: dict, device: Any | None = None) -> Any:
        # unconditional (data integrity): a wrong view would unpack wrong
        # bytes into right-looking arrays
        dt = self._view.filetype
        if dt is None:
            errors.fail(
                errors.ErrorClass.ERR_IO,
                f"{name!r} was written through a file view; "
                "set_view(filetype=...) before reading it",
            )
        if rec["view"]["groups"] != dt.layout_signature()["groups"]:
            errors.fail(
                errors.ErrorClass.ERR_IO,
                f"file view mismatch for {name!r}: dataset layout "
                f"{rec['view']['groups']}, installed view "
                f"{dt.layout_signature()['groups']}",
            )
        bufs = []
        for g, grp in enumerate(rec["view"]["groups"]):
            carrier = _carrier(grp["dtype"])
            out = np.zeros(grp["size"], dtype=carrier)
            for e in rec["fragments"]:
                if e.get("group") != g:
                    continue
                buf = self._load_fragment(e, carrier, rec)
                off = e["offset"][0]
                out[off : off + e["shape"][0]] = buf
            bufs.append(from_host(out, grp["dtype"], device))
        return dt.unpack(bufs)

    def _load_fragment(self, e: dict, carrier: np.dtype, rec: dict) -> np.ndarray:
        buf = np.load(os.path.join(self.path, e["fragment"]), allow_pickle=False)
        tool.pvar_add("io_bytes_read", buf.nbytes)
        # integrity checks below are unconditional: they guard the data, not
        # the interface, so the error_checking cvar must not disable them
        if self.spec.checksum and e.get("checksum"):
            if _checksum(buf) != e["checksum"]:
                errors.fail(
                    errors.ErrorClass.ERR_IO,
                    f"checksum mismatch in {e['fragment']}",
                )
        if buf.dtype != carrier:
            # reinterpret ONLY a declared storage representation — the
            # record's etype, the installed view etype, or the storage
            # alias (all same-itemsize, so the bytes round-trip exactly)
            declared: set[np.dtype] = {carrier}
            if rec.get("etype") is not None:
                declared.add(np.dtype(rec["etype"]))
            if self._view.etype is not None:
                declared.add(self._view.etype)
            if not (buf.dtype in declared and buf.dtype.itemsize == carrier.itemsize):
                errors.fail(
                    errors.ErrorClass.ERR_IO,
                    f"fragment {e['fragment']} has dtype {buf.dtype}; the "
                    f"manifest's dtype is held as {carrier} (declared storage: "
                    f"{sorted(str(d) for d in declared)}) — refusing to "
                    "reinterpret",
                )
            buf = buf.view(carrier)
        return buf

    def names(self) -> list[str]:
        return sorted(self.manifest()["arrays"].keys())


def open(path: str, mode: Mode = Mode.RDONLY, **kw) -> File:  # noqa: A001
    """``MPI_File_open`` analogue with meaningful defaults."""

    return File(path, FileSpec(mode=mode, **kw))
