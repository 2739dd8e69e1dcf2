"""The port's checkpoint I/O against the reference on the CPU: the same
on-disk format in both directions (a reference checkpoint of the trainer's
state restores in the port, a port checkpoint restores in the reference,
bit for bit, with manifests of the same records), the async save's failure
path, and the layers under it — the reflected datatypes of the file views,
the file layer (views, split collectives, open modes, integrity) and the
``DeferredFuture`` requests it runs on."""

from __future__ import annotations

import dataclasses
import enum
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import base as jbase
from repro.core import datatypes as jdt
from repro.core import io as jio
from repro.core.descriptors import Mode as JMode
from repro.models import api as japi
from repro.optim import AdamW as JAdamW
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import datatypes as tdt
from repro_torch.core import errors as terrors
from repro_torch.core import io as tio
from repro_torch.core import tool as ttool
from repro_torch.core.descriptors import Mode
from repro_torch.core.futures import DeferredFuture, Future, flatten, unflatten, when_all
from repro_torch.optim import AdamWState
from repro_torch.runtime.faults import FaultInjector

torch.set_num_threads(1)

_TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)


def _jax_state(moment_dtype, cfg=None):
    """The reference trainer's state after one update: bf16 parameters of
    the tiny dense model (or of ``cfg``), the AdamW state with
    ``moment_dtype`` moments."""

    cfg = cfg or jbase.ModelConfig(**_TINY)
    params = jax.jit(japi.build(cfg).init)(jax.random.PRNGKey(0))
    opt = JAdamW(lr=1e-2, moment_dtype=moment_dtype)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state = jax.jit(opt.update)(grads, jax.jit(opt.init)(params), params)
    return {"params": params, "opt": state}


def _port_state(jstate):
    host = jax.tree_util.tree_map(np.array, jstate)
    return {"params": params_from_jax(host["params"], "cpu"),
            "opt": opt_state_from_jax(host["opt"], "cpu")}


def _zeros_like_port(state):
    """A template of ``state``'s structure (the port's ``_Q8`` moments
    included), every leaf zero."""

    leaves, treedef = flatten(state)
    return unflatten(treedef, [torch.zeros_like(x) for x in leaves])


def _port_leaves(state):
    """params, step, mu, nu: the order of the reference's leaves."""

    o = state["opt"]
    return (flatten(state["params"])[0] + [o.step] + flatten(o.mu)[0] + flatten(o.nu)[0])


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return tio.to_host(x)[0].tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _records(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["arrays"]


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_reference_checkpoint_restores_in_port(tmp_path, moment_dtype):
    jstate = _jax_state(moment_dtype)
    JManager(str(tmp_path / "j"), async_save=False).save(3, jstate, extra={"step": 3})
    want = _port_state(jstate)
    mgr = TManager(str(tmp_path / "j"))
    got, step = mgr.restore(_zeros_like_port(want))
    assert step == 3 and mgr.extra(3) == {"step": 3}
    assert isinstance(got["opt"], AdamWState)
    for g, w in zip(_port_leaves(got), _port_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape and _bits(g) == _bits(w)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_port_checkpoint_restores_in_reference(tmp_path, moment_dtype):
    """And the manifests of the two packages hold the same records:
    names, shapes, dtypes, storage etypes, fragments and checksums; an int8
    moment is two records, ``.../q`` and ``.../scale``, and no ``meta``."""

    jstate = _jax_state(moment_dtype)
    tstate = _port_state(jstate)
    req = TManager(str(tmp_path / "t")).save(3, tstate, extra={"step": 3},
                                             meta={"world_size": 1})
    assert req.get().endswith("step_00000003")
    jmgr = JManager(str(tmp_path / "t"))
    got, step = jmgr.restore(jax.tree_util.tree_map(jnp.zeros_like, jstate))
    assert step == 3 and jmgr.manifest_meta(3) == {"world_size": 1}
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate)):
        assert g.dtype == w.dtype and g.shape == w.shape and _bits(g) == _bits(w)
    JManager(str(tmp_path / "j"), async_save=False).save(3, jstate)
    records = _records(tmp_path / "t", 3)
    assert records == _records(tmp_path / "j", 3)
    assert not any("meta" in name for name in records)
    if moment_dtype == "int8":
        moments = {n.rsplit("/", 1)[1] for n in records if n.startswith(("opt/mu/", "opt/nu/"))}
        assert moments == {"q", "scale"}
        assert records["opt/mu/embed/q"]["dtype"] == "int8"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_encdec_checkpoint_crosses_packages(tmp_path, writer):
    """The encoder-decoder's state (seamless's smoke model: the stacked
    ``encoder`` and ``decoder`` trees, fp32 moments) saved by one package
    restores in the other bit for bit, with manifests of the same records."""

    jstate = _jax_state("float32", jbase.get_smoke_config("seamless_m4t_large_v2"))
    tstate = _port_state(jstate)
    assert "encoder" in tstate["params"] and "cross" in tstate["params"]["decoder"]
    JManager(str(tmp_path / "j"), async_save=False).save(2, jstate, extra={"step": 2})
    TManager(str(tmp_path / "t")).save(2, tstate, extra={"step": 2}).get()
    assert _records(tmp_path / "t", 2) == _records(tmp_path / "j", 2)
    if writer == "reference":
        got, step = TManager(str(tmp_path / "j")).restore(_zeros_like_port(tstate))
        pairs = zip(_port_leaves(got), _port_leaves(tstate))
    else:
        got, step = JManager(str(tmp_path / "t")).restore(
            jax.tree_util.tree_map(jnp.zeros_like, jstate))
        pairs = zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate))
    assert step == 2
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape and _bits(g) == _bits(w)


@pytest.mark.parametrize("arch,moments", [("grok_1_314b", "int8"),
                                           ("deepseek_v2_236b", "float32")])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_moe_checkpoint_crosses_packages(tmp_path, writer, arch, moments):
    """The MoE smoke models' state (bf16 experts beside the fp32 router;
    deepseek's MLA units and unstacked ``dense_0``) saved by one package
    restores in the other bit for bit, with manifests of the same records."""

    jstate = _jax_state(moments, jbase.get_smoke_config(arch))
    tstate = _port_state(jstate)
    assert tstate["params"]["layers"]["layer"]["mlp"]["router"].dtype == torch.float32
    assert tstate["params"]["layers"]["layer"]["mlp"]["w_gate"].dtype == torch.bfloat16
    JManager(str(tmp_path / "j"), async_save=False).save(2, jstate, extra={"step": 2})
    TManager(str(tmp_path / "t")).save(2, tstate, extra={"step": 2}).get()
    assert _records(tmp_path / "t", 2) == _records(tmp_path / "j", 2)
    if writer == "reference":
        got, step = TManager(str(tmp_path / "j")).restore(_zeros_like_port(tstate))
        pairs = zip(_port_leaves(got), _port_leaves(tstate))
    else:
        got, step = JManager(str(tmp_path / "t")).restore(
            jax.tree_util.tree_map(jnp.zeros_like, jstate))
        pairs = zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate))
    assert step == 2
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape and _bits(g) == _bits(w)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "h": torch.randn((4,), generator=g).to(torch.bfloat16)},
            "opt": {"mu": torch.ones((8, 8)), "step": torch.tensor(3, dtype=torch.int32)}}


def _zeros(state):
    return jax.tree_util.tree_map(torch.zeros_like, state)


@pytest.mark.parametrize("async_save", [True, False])
def test_failed_save_is_err_io_at_the_join(tmp_path, async_save):
    """A torn save surfaces as ERR_IO at the join (the next wait for an
    async save, the save itself for a sync one); it commits no manifest,
    ``latest`` stays at the last complete step, and the next save works."""

    mgr = TManager(str(tmp_path), async_save=async_save)
    mgr.save(1, _state(1))
    mgr.wait()
    mgr.injector = FaultInjector(fail_fragments=("opt.step",))
    with pytest.raises(terrors.IoError):
        mgr.save(2, _state(2))
        mgr.wait()
    assert not (tmp_path / "step_00000002" / "_COMPLETE").exists()
    assert not (tmp_path / "step_00000002" / "manifest.json").exists()
    assert mgr.latest_step() == 1
    restored, step = mgr.restore(_zeros(_state()))
    assert step == 1 and torch.equal(restored["params"]["w"], _state(1)["params"]["w"])
    mgr.save(3, _state(3))
    mgr.wait()
    assert mgr.latest_step() == 3


def test_async_save_overlaps_and_restores_bits(tmp_path):
    """save() returns at once with the host copy taken: the caller may
    overwrite its tensors; the completion request chains like any other;
    one manifest commit per save; retention keeps the last ``keep``."""

    mgr = TManager(str(tmp_path), keep=2)
    before = ttool.pvar_read()["io_manifest_commit"]
    for s in (1, 2, 3):
        state = _state(s)
        req = mgr.save(s, state)
        keep = jax.tree_util.tree_map(torch.clone, state)
        for t in jax.tree_util.tree_leaves(state):
            t.zero_()  # the step's in-place update, right after save()
    tag, step_dir = req.then(lambda r: ("committed", r.get())).get()
    assert tag == "committed" and step_dir.endswith("step_00000003")
    assert mgr.wait() is None  # the caller consumed it
    assert ttool.pvar_read()["io_manifest_commit"] == before + 3
    assert mgr.steps() == [2, 3]
    restored, _ = mgr.restore(_zeros(keep))
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(keep)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def test_restore_skips_a_torn_step_and_name_collisions_fail(tmp_path):
    mgr = TManager(str(tmp_path), async_save=False)
    mgr.save(1, _state(1))
    broken = tmp_path / "step_00000002"
    broken.mkdir()
    (broken / "garbage.npy").write_bytes(b"xx")
    assert mgr.latest_step() == 1
    with pytest.raises(terrors.IoError, match="collides"):
        mgr.save(5, {"a/b": torch.ones(2), "a": {"b": torch.zeros(2)}})


# -- the file layer ------------------------------------------------------------


@dataclasses.dataclass
class KVState:
    keys: object
    values: object
    step: int


def _kv(mod):
    return KVState(keys=mod.arange(24, dtype=mod.bfloat16).reshape(4, 6) / 3,
                   values=mod.ones((4, 6), dtype=mod.bfloat16) * 2, step=7)


class Color(enum.Enum):
    RED = 1
    BLUE = 2


@dataclasses.dataclass
class Particle:
    pos: object
    mass: float
    tags: list
    color: Color = Color.RED
    extra: object = None


def _aggregates(mod, asarray):
    return [
        Particle(pos=asarray(np.arange(6, dtype=np.float32).reshape(2, 3)), mass=2.5,
                 tags=[1, True, asarray(np.array([3, 4], np.int32))]),
        {"b": (1.0, 2), "a": asarray(np.ones((2, 2), np.float32)), "c": Color.BLUE},
        [asarray(np.zeros(3, np.float32)), asarray(np.arange(2, dtype=np.int16))],
    ]


@pytest.mark.parametrize("i", range(3))
def test_datatypes_equal_the_reference(i):
    """The reflected datatype of the same aggregate has the reference's
    layout (group dtypes and sizes, extent); pack/unpack and apply_packed
    round-trip; ``is_compliant`` agrees on aggregates and non-aggregates."""

    jobj = _aggregates(jnp, jnp.asarray)[i]
    tobj = _aggregates(torch, torch.as_tensor)[i]
    jd, td = jdt.datatype_of(jobj), tdt.datatype_of(tobj)
    assert td.layout_signature() == jd.layout_signature() and td.extent == jd.extent
    bufs, dt = tdt.pack(tobj)
    for a, b in zip(bufs, jd.pack(jobj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tdt.unpack(bufs, dt)
    assert tdt.datatype_of(back).layout_signature() == td.layout_signature()
    def twice(b):
        return b * 2 if b.is_floating_point() else b

    for a, b in zip(tdt.pack(tdt.apply_packed(twice, tobj))[0], bufs):
        assert torch.equal(a, twice(b))
    for value in (tobj, "text", None, [None, 1], {"k": object()}):
        jv = jobj if value is tobj else value
        assert tdt.is_compliant(value) == jdt.is_compliant(jv)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_filetype_view_crosses_packages(tmp_path, writer):
    """An aggregate written through a paged filetype view by one package
    reads back through the same view in the other; the datatypes' layout
    signatures are equal."""

    jstate, tstate = _kv(jnp), _kv(torch)
    assert tdt.datatype_of(tstate).layout_signature() == \
        jdt.datatype_of(jstate).layout_signature()
    path = str(tmp_path / "d")
    if writer == "reference":
        jio.open(path, JMode.CREATE | JMode.WRONLY).set_view(
            filetype=jstate, num_pages=3).write_at_all("kv", jstate)
        out = tio.open(path).set_view(filetype=tstate, num_pages=3).read_at_all("kv")
        assert isinstance(out, KVState) and int(out.step) == 7
        assert torch.equal(out.keys, tstate.keys) and torch.equal(out.values, tstate.values)
    else:
        rec = tio.open(path, Mode.CREATE | Mode.WRONLY).set_view(
            filetype=tstate, num_pages=3).write_at_all("kv", tstate)
        assert len(rec["fragments"]) == 2 * 3  # (bf16, int32) groups x pages
        out = jio.open(path).set_view(filetype=jstate, num_pages=3).read_at_all("kv")
        assert int(np.asarray(out.step)) == 7
        np.testing.assert_array_equal(np.asarray(out.keys, np.float32),
                                      np.asarray(jstate.keys, np.float32))


def test_view_mismatch_and_etype_storage(tmp_path):
    path = str(tmp_path / "d")
    f = tio.open(path, Mode.CREATE | Mode.WRONLY)
    f.set_view(filetype=_kv(torch), num_pages=2).write_at_all("kv", _kv(torch))
    f.set_view(etype=np.int32)
    f.write_at_all("x", torch.arange(6, dtype=torch.float32))
    r = tio.open(path)
    with pytest.raises(terrors.IoError, match="file view"):
        r.read_at_all("kv")
    other = KVState(keys=torch.ones((3, 3)), values=torch.zeros((3, 3)), step=1)
    with pytest.raises(terrors.IoError, match="view mismatch"):
        r.set_view(filetype=other).read_at_all("kv")
    x = tio.open(path).read_at_all("x")  # stored as int32, read as its float32
    assert x.dtype == torch.float32 and torch.equal(x, torch.arange(6, dtype=torch.float32))
    with pytest.raises(terrors.TypeError_):
        tio.open(path, Mode.CREATE | Mode.WRONLY).set_view(etype=torch.bfloat16)


def test_split_collectives_and_open_modes(tmp_path):
    path = str(tmp_path / "d")
    f = tio.open(path, Mode.CREATE | Mode.WRONLY)
    f.write_at_all_begin("a", torch.ones(3))
    with pytest.raises(terrors.RequestError):
        f.write_at_all_begin("b", torch.ones(3))  # one split collective per handle
    with pytest.raises(terrors.RequestError):
        f.write_at_all_end("b")
    assert f.write_at_all_end("a")["name"] == "a"
    with pytest.raises(terrors.RequestError):
        f.write_at_all_end("a")
    r = tio.open(path)
    r.read_at_all_begin("a")
    assert torch.equal(r.read_at_all_end("a"), torch.ones(3))
    with pytest.raises(terrors.FileError):
        r.write_at_all("c", torch.ones(1))  # read-only
    with pytest.raises(terrors.FileError):
        tio.open(path, Mode.CREATE | Mode.EXCL | Mode.WRONLY)


def test_integrity_checks(tmp_path):
    """A corrupted fragment fails its checksum; a fragment of a foreign
    dtype is refused, not reinterpreted: ERR_IO either way."""

    path = str(tmp_path / "d")
    f = tio.open(path, Mode.CREATE | Mode.WRONLY, checksum=True)
    f.write_at_all("x", torch.arange(8, dtype=torch.float32))
    f.write_at_all("y", torch.arange(8, dtype=torch.float32))
    np.save(os.path.join(path, "x.0.npy"), np.arange(8, dtype=np.float32) + 1)
    with pytest.raises(terrors.IoError, match="checksum"):
        tio.open(path, checksum=True).read_at_all("x")
    np.save(os.path.join(path, "y.0.npy"), np.arange(8, dtype=np.float64))
    with pytest.raises(terrors.IoError, match="refusing"):
        tio.open(path, checksum=False).read_at_all("y")


def test_iwrite_iread_and_failed_iwrite(tmp_path):
    path = str(tmp_path / "d")
    f = tio.open(path, Mode.CREATE | Mode.WRONLY)
    reqs = [f.iwrite_at_all(n, torch.full((4,), float(i))) for i, n in enumerate("abc")]
    recs = when_all(reqs).get()
    assert [r["name"] for r in recs] == ["a", "b", "c"] and f.names() == ["a", "b", "c"]
    assert torch.equal(tio.open(path).iread_at_all("b").get(), torch.full((4,), 1.0))
    f.write_hook = FaultInjector(fail_fragments=("d.",)).check_io
    req = f.iwrite_at_all("d", torch.ones(2))
    with pytest.raises(terrors.IoError, match="injected"):
        req.then(lambda r: r.get()).get()


def test_deferred_future_semantics():
    """Resolved once, at the wait; ``then`` is lazy; a resolver error
    propagates through the chain and through ``when_all``."""

    calls = []
    d = DeferredFuture(lambda: calls.append(1) or 5, probe=lambda: False)
    chained = d.then(lambda f: f.get() * 2)
    assert calls == [] and not d.valid() and not chained.test()
    assert chained.get() == 10 and calls == [1]
    with pytest.raises(terrors.RequestError):
        chained.get()

    def boom():
        terrors.fail(terrors.ErrorClass.ERR_IO, "disk gone")

    joined = when_all([Future(torch.ones(1)), DeferredFuture(boom)])
    with pytest.raises(terrors.IoError, match="disk gone"):
        joined.get()
    assert DeferredFuture(lambda: 3).then(lambda f: f).get() == 3
