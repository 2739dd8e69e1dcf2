"""Every public name of the reference has its counterpart in the port, or
an A16 reason (ROADMAP A16: XLA-only artifacts with no counterpart), and
the names ported last are held against the reference's.

* the whole port: for every module of ``src/repro/``, every public
  top-level name (defined there; for a package, re-exported too) exists at
  the same path in ``repro_torch``, and every public attribute of
  ``Trainer``, ``CommEpoch`` and ``Communicator`` exists on the port's
  class, or the name is in :data:`A16` with its reason;
* ``core.future`` and ``core.set_error_checking``, ``launch.mesh.
  make_host_mesh``, ``Trainer.mesh`` and ``CommEpoch.mesh``,
  ``analysis.lint.MARKER`` and ``lint_script``,
  ``core.datatypes.apply_leafwise``, each against the reference's.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.analysis import lint as jlint
from repro.configs import base as jbase
from repro.core import datatypes as jdatatypes
from repro.core import errors as jerrors
from repro.core.epoch import CommEpoch as JCommEpoch
from repro.core.epoch import TopologySpec as JTopologySpec
from repro.core.session import default_session as jdefault_session
from repro.launch import mesh as jmesh
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import core as tcore
from repro_torch.analysis import lint as tlint
from repro_torch.configs import base as tbase
from repro_torch.core import datatypes as tdatatypes
from repro_torch.core import errors as terrors
from repro_torch.core.epoch import CommEpoch, TopologySpec
from repro_torch.core.session import default_session
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.trainer import Trainer, TrainerConfig

SRC = Path(__file__).resolve().parents[2] / "src"

#: (module of ``repro_torch``, name) → why the reference's name has no
#: counterpart; ``"<module>"`` for a whole module
A16 = {
    ("repro_torch.core._compat", "<module>"):
        "jax version shims (core/_compat.py); the port runs on one torch",
    ("repro_torch.core.hloanalysis", "Computation"):
        "an XLA computation nested in a module (a loop body, a branch); a recorded "
        "program is flat: Python loops are unrolled as they run",
    ("repro_torch.core.hloanalysis", "parse_computations"):
        "splits XLA HLO text into its nested computations (see Computation)",
    ("repro_torch.core", "TraceFuture"):
        "a future over a traced JAX value; Future over dist.Work takes its role",
    ("repro_torch.core", "trace_when_all"): "joins TraceFutures (see TraceFuture)",
    ("repro_torch.core", "trace_when_any"): "joins TraceFutures (see TraceFuture)",
    ("repro_torch.core.futures", "TraceFuture"):
        "a future over a traced JAX value; Future over dist.Work takes its role",
    ("repro_torch.core.futures", "trace_when_all"): "joins TraceFutures (see TraceFuture)",
    ("repro_torch.core.futures", "trace_when_any"): "joins TraceFutures (see TraceFuture)",
    ("repro_torch.data", "make_batch_specs"): "a JAX sharding spec of the batch",
    ("repro_torch.data.pipeline", "make_batch_specs"): "a JAX sharding spec of the batch",
    ("repro_torch.models.common", "key_iter"):
        "jax.random key splits; the port draws from one seeded torch.Generator",
    ("repro_torch.kernels.quant.kernel", "ROW_TILE"):
        "the Pallas grid step's 64 rows; the CUDA bodies pick their own rows a block",
    ("repro_torch.core.communicator.Communicator", "spmd"):
        "enters shard_map; every rank of the port runs the program itself",
    ("repro_torch.core.communicator.Communicator", "run"): "one-shot spmd (see spmd)",
    ("repro_torch.core.communicator.Communicator", "sharding"):
        "a NamedSharding; device_mesh and rules.distribute take its role",
    ("repro_torch.core.communicator.Communicator", "device_put"):
        "jax.device_put under a NamedSharding; rules.distribute takes its role",
}

#: (reference module, class) whose public attributes the port mirrors
CLASSES = (("repro.runtime.trainer", "Trainer"), ("repro.core.epoch", "CommEpoch"),
           ("repro.core.communicator", "Communicator"))


def _public_names(path: Path) -> set[str]:
    """The public names a module binds at top level by ``def``, ``class`` or
    assignment; a package's ``__init__`` also those it imports from
    ``repro``."""

    tree = ast.parse(path.read_text())
    package = path.name == "__init__.py"
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif package and isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "repro"):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _port_module(path: Path) -> str:
    parts = list(path.relative_to(SRC / "repro").with_suffix("").parts)
    return ".".join(["repro_torch"] + (parts[:-1] if parts[-1] == "__init__" else parts))


def _missing() -> list[tuple[str, str]]:
    missing = []
    for path in sorted((SRC / "repro").rglob("*.py")):
        name = _port_module(path)
        try:
            module = importlib.import_module(name)
        except ModuleNotFoundError:
            missing.append((name, "<module>"))
            continue
        missing += [(name, n) for n in sorted(_public_names(path)) if not hasattr(module, n)]
    for ref_module, cls in CLASSES:
        ref = getattr(importlib.import_module(ref_module), cls)
        port_module = "repro_torch" + ref_module[len("repro"):]
        port = getattr(importlib.import_module(port_module), cls)
        missing += [(f"{port_module}.{cls}", n) for n in dir(ref)
                    if not n.startswith("_") and not hasattr(port, n)]
    return missing


def test_every_public_name_is_ported_or_has_an_a16_reason():
    missing = _missing()
    unexplained = [m for m in missing if m not in A16]
    assert unexplained == [], unexplained
    # every A16 entry is still a name the port lacks, with its reason
    stale = [k for k in A16 if k not in missing]
    assert stale == [], stale
    assert all(A16.values())


# -- core.future, core.set_error_checking --------------------------------------


def test_future_wraps_a_value_and_passes_futures_through():
    for core in (jcore, tcore):
        f = core.future(3)
        assert isinstance(f, core.Future) and f.get() == 3
        g = core.Future(np.float32(1.5))
        assert core.future(g) is g
    np.testing.assert_array_equal(np.asarray(tcore.future(np.arange(4)).get()),
                                  np.asarray(jcore.future(np.arange(4)).get()))


def test_set_error_checking_is_exported_and_toggles_as_the_references():
    assert tcore.set_error_checking is terrors.set_error_checking
    seen = []
    for core, errors in ((jcore, jerrors), (tcore, terrors)):
        before = errors.error_checking_enabled()
        try:
            prev = [core.set_error_checking(v) for v in (False, False, True)]
            seen.append((prev, errors.error_checking_enabled()))
        finally:
            core.set_error_checking(before)
    assert seen[0] == seen[1] == ([True, False, False], True)


# -- launch.mesh.make_host_mesh, Trainer.mesh, CommEpoch.mesh -------------------


def _mesh_shape(mesh) -> dict:
    """{axis name: size} of a JAX Mesh or a torch DeviceMesh."""

    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def test_make_host_mesh_is_the_host_communicators_device_mesh():
    got = tmesh.make_host_mesh(1, 1, device="cpu")
    want = tmesh.make_host_communicator(1, 1, device="cpu").device_mesh
    assert got.mesh.tolist() == want.mesh.tolist()
    assert got.mesh_dim_names == want.mesh_dim_names
    assert _mesh_shape(got) == _mesh_shape(jmesh.make_host_mesh(1, 1)) == {"data": 1,
                                                                         "model": 1}


_TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)


def test_trainer_mesh_is_its_epochs_communicators_device_mesh():
    kw = dict(steps=1, lr=1e-3)
    jt = JTrainer(jbase.ModelConfig(**_TINY), jbase.ParallelConfig(), JTrainerConfig(**kw),
                  jmesh.make_host_mesh(), seq_len=16, global_batch=2)
    tt = Trainer(tbase.ModelConfig(**_TINY), tbase.ParallelConfig(), TrainerConfig(**kw),
                 device="cpu", seq_len=16, global_batch=2)
    assert tt.mesh is tt.epoch.comm.device_mesh is tt.epoch.mesh
    assert _mesh_shape(tt.mesh) == _mesh_shape(jt.mesh)


def test_comm_epoch_mesh_is_its_communicators_device_mesh():
    shapes = []
    for Epoch, Spec, sess in ((JCommEpoch, JTopologySpec, jdefault_session()),
                              (CommEpoch, TopologySpec, default_session(device_type="cpu"))):
        ep = Epoch.create(sess.group("repro://world"), Spec((-1, 1), ("data", "model")),
                          name="mesh")
        shapes.append(_mesh_shape(ep.mesh))
        if Epoch is CommEpoch:
            assert ep.mesh is ep.comm.device_mesh
    assert shapes[0] == shapes[1]


# -- analysis.lint.MARKER, lint_script -----------------------------------------

SCRIPTS = {
    # one future created and never consumed: a dangling-future finding
    "leak": """
        from {pkg}.analysis import events
        events.record_future_create(events.next_token(), "immediate_allreduce")
    """,
    "fails": "raise SystemExit(3)\n",
    "hangs": "import time\ntime.sleep(60)\n",
}


def test_lint_script_reports_as_the_references(tmp_path):
    assert tlint.MARKER == jlint.MARKER
    jobs = {}
    for pkg, lint in (("repro", jlint), ("repro_torch", tlint)):
        for name, body in SCRIPTS.items():
            path = tmp_path / f"{pkg}_{name}.py"
            path.write_text(textwrap.dedent(body).format(pkg=pkg))
            jobs[pkg, name] = (lint.lint_script, path, 5 if name == "hangs" else 120)
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(fn, p, timeout=t) for k, (fn, p, t) in jobs.items()}
        found = {k: f.result() for k, f in futures.items()}
    for name in SCRIPTS:
        want = [(x.code.name, x.check) for x in found["repro", name]]
        got = [(x.code.name, x.check) for x in found["repro_torch", name]]
        assert got == want, (name, got, want)
    assert [x.check for x in found["repro_torch", "leak"]] == ["dangling-future"]
    assert "immediate_allreduce" in found["repro_torch", "leak"][0].message
    assert [x.check for x in found["repro_torch", "fails"]] == ["script-failed"]
    assert [x.check for x in found["repro_torch", "hangs"]] == ["script-timeout"]


# -- core.datatypes.apply_leafwise ----------------------------------------------


@dataclasses.dataclass
class _Pair:
    a: np.ndarray
    b: float


def test_apply_leafwise_maps_every_leaf_as_the_references():
    obj = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "p": [np.int32(4), 2.5]}
    want = jdatatypes.apply_leafwise(lambda v: v * 2, obj)
    got = tdatatypes.apply_leafwise(lambda v: v * 2, obj)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    assert [float(v) for v in got["p"]] == [float(v) for v in want["p"]]
    assert [v.dtype for v in got["p"]] == [torch.int32, torch.float32]
    # the leaf shapes reach the function: no packing
    shapes = []
    tdatatypes.apply_leafwise(lambda v: shapes.append(tuple(v.shape)) or v, obj)
    assert shapes == [(), (), (2, 3)] or sorted(shapes) == [(), (), (2, 3)]
    pair = tdatatypes.apply_leafwise(lambda v: v + 1, _Pair(np.ones(2, np.float32), 1.0))
    assert isinstance(pair, _Pair) and float(pair.b) == 2.0


def test_apply_leafwise_refuses_a_leaf_that_is_not_mpi_compliant():
    codes = []
    for dt, errors in ((jdatatypes, jerrors), (tdatatypes, terrors)):
        with pytest.raises(errors.Error) as ei:
            dt.apply_leafwise(lambda v: v, {"x": np.ones(2), "s": "text"})
        codes.append(ei.value.klass.name)
        assert "not mpi-compliant" in str(ei.value)
    assert codes == ["ERR_TYPE", "ERR_TYPE"]
