"""The port stands alone: no file of ``src/repro_torch``, ``chip_smoke.py``,
``tools/`` nor the port's examples (``examples_torch/``) imports JAX or the
reference package, and what it copied
from the reference (error classes, the ported configs, the Group algebra,
the collective facade's names and pvars, the fault policies, the token
pipeline's host batches, the trainer's and optimizer's configuration, the
I/O and checkpoint pvars) still equals the reference."""

from __future__ import annotations

import ast
import dataclasses
import enum
from pathlib import Path

import pytest
import torch

from repro.configs import base as jbase
from repro.core import errors as jerrors
from repro.core import session as jsession
from repro_torch.configs import base as tbase
from repro_torch.core import errors as terrors
from repro_torch.core import session as tsession

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
_FORBIDDEN = ("jax", "jaxlib", "repro")
# every arch of ARCHITECTURES: the configs the port copied
_DENSE = ("gemma2_9b", "phi4_mini_3_8b", "granite_3_8b", "qwen1_5_32b", "mamba2_2_7b",
          "zamba2_7b", "paligemma_3b", "seamless_m4t_large_v2", "grok_1_314b",
          "deepseek_v2_236b")


def _port_files():
    """The port's package, ``chip_smoke.py``, the on-card tools and the
    port's examples."""

    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py"))
            + sorted((ROOT / "examples_torch").glob("*.py")))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                roots.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                roots.add(arg.values[0].value.split(".")[0])
    return roots


_MULTI_RANK = ("core/topology.py", "core/onesided.py", "core/collectives.py", "core/_methods.py",
               "core/overlap.py",
               "kernels/ring_attention/ref.py", "kernels/ring_attention/kernel.py",
               "kernels/ring_attention/ops.py")


_TRAINING = ("optim/adamw.py", "optim/clip.py", "optim/schedules.py", "optim/grad_sync.py",
             "data/pipeline.py", "core/datatypes.py", "core/io.py", "checkpoint/manager.py",
             "runtime/faults.py", "runtime/trainer.py", "launch/train.py")


_SERVING = ("runtime/server.py", "runtime/engine.py", "runtime/kvpool.py")


_TUNER = ("tune/__init__.py", "tune/__main__.py", "tune/score.py", "tune/search.py",
          "core/tool.py", "core/session.py")


_MODELS = ("models/transformer.py", "models/encdec.py", "models/api.py", "models/mlp.py",
           "models/attention.py", "configs/paligemma_3b.py", "configs/seamless_m4t_large_v2.py",
           "configs/grok_1_314b.py", "configs/deepseek_v2_236b.py", "launch/serve.py")


_DRY_RUN_AND_ANALYZER = ("analysis/__init__.py", "analysis/events.py", "analysis/checkers.py",
                         "analysis/static.py", "analysis/lint.py", "launch/dryrun.py",
                         "launch/specs.py", "launch/steps.py", "launch/mesh.py",
                         "kernels/registry.py")


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    package = ROOT / "src" / "repro_torch"
    covered = {str(f.relative_to(package)) for f in files if f.is_relative_to(package)}
    assert ROOT / "tools" / "quant_variants.py" in files
    examples = {f.name for f in files if f.parent == ROOT / "examples_torch"}
    assert examples == {f.name for f in (ROOT / "examples").glob("*.py")} and len(examples) == 11
    assert set(_MULTI_RANK) <= covered and set(_TRAINING) <= covered
    assert set(_MODELS) <= covered and set(_SERVING) <= covered and set(_TUNER) <= covered
    assert set(_DRY_RUN_AND_ANALYZER) <= covered
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(_FORBIDDEN))
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_error_classes_equal_the_reference():
    assert {m.name: m.value for m in terrors.ErrorClass} == \
        {m.name: m.value for m in jerrors.ErrorClass}
    for klass in jerrors.ErrorClass:
        je = jerrors.exception(klass, "x")
        te = terrors.exception(terrors.ErrorClass[klass.name], "x")
        assert (type(te).__name__, te.code, str(te)) == (type(je).__name__, je.code, str(je))


def _plain(obj):
    """A dataclass as a dict, enums by value, so copies compare across
    packages."""

    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(x) for x in obj)
    return obj


def test_every_architecture_is_copied():
    assert sorted(_DENSE) == sorted(jbase.ARCHITECTURES) == sorted(tbase.ARCHITECTURES)


@pytest.mark.parametrize("arch", _DENSE)
def test_dense_configs_equal_the_reference(arch):
    assert _plain(tbase.get_config(arch)) == _plain(jbase.get_config(arch))
    assert _plain(tbase.get_smoke_config(arch)) == _plain(jbase.get_smoke_config(arch))
    assert _plain(tbase.get_parallel(arch)) == _plain(jbase.get_parallel(arch))
    assert _plain(tbase.plan_space(arch)) == _plain(jbase.plan_space(arch))
    assert tbase.get_config(arch).param_count() == jbase.get_config(arch).param_count()


def test_group_algebra_equals_the_reference():
    a_t, b_t = tsession.Group(range(6)), tsession.Group([4, 5, 6, 7])
    a_j, b_j = jsession.Group(range(6)), jsession.Group([4, 5, 6, 7])
    for op in ("union", "intersection", "difference"):
        assert getattr(a_t, op)(b_t).devices == getattr(a_j, op)(b_j).devices
    assert a_t.incl([3, 1]).devices == a_j.incl([3, 1]).devices
    assert a_t.excl([0, 2]).devices == a_j.excl([0, 2]).devices
    assert a_t.translate_ranks([4, 5], b_t) == a_j.translate_ranks([4, 5], b_j)
    assert a_t.compare(tsession.Group(reversed(range(6)))).value == \
        a_j.compare(jsession.Group(reversed(range(6)))).value


def test_cpu_session_psets():
    """The world of this process is one rank of the default process group
    (initialised here as a world of one) computing on the CPU."""

    sess = tsession.Session(device_type="cpu")
    cpu = (tsession.RankDevice(0, torch.device("cpu")),)
    for name in ("repro://world", "mpi://self", "repro://host/0", "repro://platform/cpu"):
        assert sess.pset(name) == cpu
    sess.finalize()
    with pytest.raises(terrors.Error) as ei:
        sess.psets()
    assert ei.value.klass == terrors.ErrorClass.ERR_SESSION


def test_collective_facade_equals_the_reference():
    """The blocking and immediate methods the port binds onto its
    communicator exist in the reference under the same names, with the same
    pvars."""

    from repro.core import _methods as jmethods  # noqa: F401  (binds the reference's)
    from repro.core import tool as jtool
    from repro.core.communicator import Communicator as JComm
    from repro_torch.core import _methods as tmethods
    from repro_torch.core import tool as ttool
    from repro_torch.core.communicator import Communicator as TComm

    names = (tmethods._BLOCKING + tuple(f"immediate_{n}" for n in tmethods._IMMEDIATE)
             + ("immediate_ring_allgather",))
    for name in names:
        assert callable(getattr(TComm, name)) and callable(getattr(JComm, name)), name
        assert name in ttool.PVARS and ttool.PVARS[name] == jtool.PVARS[name], name


def test_fault_policies_are_the_reference_copied():
    """``runtime/faults.py`` is pure Python over the tool layer: the
    reference's file with its one import renamed."""

    ref = (ROOT / "src" / "repro" / "runtime" / "faults.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "runtime" / "faults.py").read_text()
    assert port == ref.replace("from repro.core import tool", "from repro_torch.core import tool")


def test_host_batch_is_the_reference_copied():
    import inspect

    from repro.data import pipeline as jpipe
    from repro_torch.data import pipeline as tpipe

    for name in ("host_batch", "_rng", "__iter__"):
        assert inspect.getsource(getattr(tpipe.TokenPipeline, name)) == \
            inspect.getsource(getattr(jpipe.TokenPipeline, name)), name
    assert _plain(tpipe.TokenPipeline(10, 4, 2)) == _plain(jpipe.TokenPipeline(10, 4, 2))


def _fields(cls) -> list:
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_trainer_and_optimizer_configs_equal_the_reference():
    from repro.optim import AdamW as JAdamW
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.optim import AdamW as TAdamW
    from repro_torch.runtime.trainer import TrainerConfig as TTrainerConfig

    assert _fields(TTrainerConfig) == _fields(JTrainerConfig)
    assert _fields(TAdamW) == _fields(JAdamW)


def test_io_checkpoint_and_trainer_pvars_equal_the_reference():
    from repro.core import tool as jtool
    from repro.runtime import trainer as _jtrainer  # noqa: F401  (registers its pvars)
    from repro_torch.core import tool as ttool
    from repro_torch.runtime import trainer as _ttrainer  # noqa: F401

    names = [n for n in ttool.PVARS if n.startswith(("io_", "ckpt_", "elastic:evictions",
                                                      "elastic:joins", "config:"))]
    assert len(names) == 16  # 9 io, 4 ckpt, 2 elastic, 1 config
    for name in names:
        assert ttool.PVARS[name] == jtool.PVARS[name], name
