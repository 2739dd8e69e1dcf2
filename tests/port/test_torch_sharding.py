"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``): for every arch's smoke config, on
several (data, model) meshes, with ``fsdp``, ``shard_experts`` and
``seq_shard_cache`` on and off, each parameter, cache and batch leaf gets
the mesh axes the reference's ``PartitionSpec`` holds — leaf for leaf, with
no ranks.  Also the divisibility property of
``tests/test_sharding_rules.py`` and the placements a spec turns into."""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.core._compat import abstract_mesh
from repro.launch import specs as jspecs
from repro.models import api as japi
from repro.sharding import rules as jrules
from repro_torch.configs import base as tbase
from repro_torch.core import errors
from repro_torch.models import api as tapi
from repro_torch.sharding import rules

torch.set_num_threads(1)

ARCHS = list(tbase.ARCHITECTURES)
MESHES = [(1, 1), (2, 2), (1, 4), (4, 1), (2, 4)]
TOGGLES = [dict(fsdp=f, shard_experts=e, seq_shard_cache=s)
           for f in (True, False) for e in (True, False) for s in (True, False)]


def _jax_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", ""))) for k in path): tuple(s)
            for path, s in flat}


def _port_paths(tree) -> dict:
    out = {}

    def walk(node, path):
        if node is None:
            return
        if rules._is_spec(node):
            out["/".join(path)] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, path + ("",))
        else:
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), path + (f.name,))

    walk(tree, ())
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    """Both packages' parameter and cache trees for ``arch``'s smoke config
    (the reference's as shapes, the port's built on the CPU), and a batch."""

    jcfg = jbase.get_smoke_config(arch)
    tcfg = tbase.get_smoke_config(arch)
    jb, tb = japi.build(jcfg), tapi.build(tcfg)
    jparams = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0)))
    with torch.no_grad():
        tparams = tb.init(torch.Generator().manual_seed(0))
    shape = jbase.ShapeConfig("t", 16, 4, "decode")
    pcfg_j, pcfg_t = jbase.get_parallel(arch), tbase.get_parallel(arch)
    jcache = jspecs.cache_structs(jb, jcfg, pcfg_j, shape)
    if tcfg.family == "encdec":
        batch = {"frames": torch.zeros((4, 16, tcfg.d_model)),
                 "tokens": torch.zeros((4, 16), dtype=torch.int32)}
        with torch.no_grad():
            _, tcache = tb.prefill(tparams, batch, pcfg_t)
    else:
        tcache = tb.init_cache(pcfg_t, 4, 16)
    return jcfg, tcfg, jparams, tparams, jcache, tcache


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_the_references(arch, mesh):
    jcfg, tcfg, jparams, tparams, jcache, tcache = _trees(arch)
    jmesh = abstract_mesh(mesh, ("data", "model"))
    shape = {"data": mesh[0], "model": mesh[1]}
    for toggle in TOGGLES:
        jp = dataclasses.replace(jbase.get_parallel(arch), **toggle)
        tp = dataclasses.replace(tbase.get_parallel(arch), **toggle)
        want = _jax_paths(jrules.param_specs(jparams, jmesh, jp))
        got = _port_paths(rules.param_specs(tparams, shape, tp))
        assert got == want, (arch, mesh, toggle)
        want = _jax_paths(jrules.cache_specs(jcache, jmesh, jp, jcfg))
        got = _port_paths(rules.cache_specs(tcache, shape, tp, tcfg))
        # a None leaf (the bf16 cache's scales) is no leaf in the reference
        assert got == want, (arch, mesh, toggle)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_batch_specs_equal_the_references(mesh):
    jmesh = abstract_mesh(mesh, ("data", "model"))
    shape = {"data": mesh[0], "model": mesh[1]}
    for b in (1, 2, 4, 8, 6):
        jbatch = {"tokens": jax.ShapeDtypeStruct((b, 16), np.int32),
                  "frames": jax.ShapeDtypeStruct((b, 8, 32), np.float32)}
        tbatch = {"tokens": torch.zeros((b, 16)), "frames": torch.zeros((b, 8, 32))}
        for fsdp in (True, False):
            want = _jax_paths(jrules.batch_spec(jbatch, jmesh, jbase.ParallelConfig(fsdp=fsdp)))
            got = _port_paths(rules.batch_spec(tbatch, shape, tbase.ParallelConfig(fsdp=fsdp)))
            assert got == want


def test_logical_to_spec_drops_what_does_not_divide():
    shape = {"data": 4, "model": 2}
    pcfg = tbase.ParallelConfig()
    assert rules.logical_to_spec(("fsdp", "model"), (8, 6), shape, pcfg) == ("data", "model")
    assert rules.logical_to_spec(("fsdp", "model"), (6, 3), shape, pcfg) == (None, None)
    assert rules.logical_to_spec(("experts", None), (4, 3), shape, pcfg) == (None, None)
    pcfg = tbase.ParallelConfig(shard_experts=True, data_axes=("pod", "data"))
    shape = {"pod": 2, "data": 2, "model": 2}
    assert rules.logical_to_spec(("batch", "experts"), (8, 4), shape, pcfg) == \
        (("pod", "data"), "model")
    jmesh = abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    jp = jbase.ParallelConfig(shard_experts=True, data_axes=("pod", "data"))
    assert tuple(jrules.logical_to_spec(("batch", "experts"), (8, 4), jmesh, jp)) == \
        (("pod", "data"), "model")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")

    assert rules.placements(("data", None, "model"), Mesh()) == (Shard(0), Shard(2))
    assert rules.placements((None, "model"), Mesh()) == (Replicate(), Shard(1))
    assert rules.placements((), Mesh()) == (Replicate(), Replicate())
    with pytest.raises(errors.Error) as ei:
        rules.placements(("model", "model"), Mesh())
    assert ei.value.klass == errors.ErrorClass.ERR_DIMS
    with pytest.raises(errors.Error):
        rules.placements(("pod",), Mesh())


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=20, deadline=None)
@given(
    data=st.sampled_from([1, 2, 4, 16]),
    model=st.sampled_from([1, 2, 4, 16]),
    batch=st.sampled_from([1, 2, 8, 256]),
    seq=st.sampled_from([16, 4096]),
)
def test_batch_spec_divisibility_property(data, model, batch, seq):
    """A spec never maps a dim onto an axis group that does not divide it
    (``tests/test_sharding_rules.py``'s property, on the port's rules)."""

    shape = {"data": data, "model": model}
    spec = rules.batch_spec({"tokens": torch.zeros((batch, seq))}, shape,
                            tbase.ParallelConfig())["tokens"]
    for dim, axes in zip((batch, seq), spec):
        if axes is not None:
            n = np.prod([shape[a] for a in ((axes,) if isinstance(axes, str) else axes)])
            assert dim % n == 0
