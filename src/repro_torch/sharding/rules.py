"""Sharding rules: logical axis names → mesh axes per tensor dim, and the
DTensor placements that carry them — :mod:`repro.sharding.rules` over a
PyTorch ``DeviceMesh``.

Every parameter leaf gets a spec derived from its *path* (what it is) and
the :class:`~repro_torch.configs.base.ParallelConfig` plan:

* FSDP — the largest weight dimension shards over the data axes;
* TP — heads / d_ff / vocab over the ``model`` axis where divisible;
* EP — the expert dimension over ``model`` when ``shard_experts``;
* caches — batch over data axes; heads or sequence over ``model`` per
  ``seq_shard_cache``;
* anything indivisible stays replicated on that axis, as the reference
  drops a mapping that does not divide.

A spec is what the reference's ``PartitionSpec`` holds: one entry per
tensor dim, ``None``, a mesh axis name, or a tuple of them.  The rules take
the mesh's shape as ``{axis: size}``, so they need no ranks;
:func:`shardings` turns specs into placements on a ``DeviceMesh`` and
:func:`distribute` places a tree whole.  DTensor's sharding propagation
then plays GSPMD's role: every op on the placed tree computes the value
the unsharded op would.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import errors

Spec = tuple
_STACKED = ("layers", "ssm_layers", "encoder", "decoder", "ssm_tail")


def _axis_size(mesh_shape: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return int(mesh_shape[axes])
    return math.prod(int(mesh_shape[a]) for a in axes)


def _fits(dim: int, mesh_shape: dict, axes) -> bool:
    return dim % _axis_size(mesh_shape, axes) == 0


def logical_to_spec(logical: tuple, shape: tuple, mesh_shape: dict, pcfg) -> Spec:
    """Map logical dim names to mesh axes, dropping non-divisible mappings."""

    table: dict[str, Any] = {
        "batch": pcfg.data_axes,
        "fsdp": pcfg.data_axes if pcfg.fsdp else None,
        "model": pcfg.model_axis,
        "experts": pcfg.model_axis if pcfg.shard_experts else None,
        "seq_model": pcfg.model_axis,
    }
    out = []
    for name, dim in zip(logical, shape):
        axes = table.get(name) if name else None
        if axes is not None and not _fits(dim, mesh_shape, axes):
            axes = None
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]   # as a PartitionSpec holds a group of one axis
        out.append(axes)
    return tuple(out)


# -- tree walking ---------------------------------------------------------------


def _map_with_path(fn: Callable, node: Any, path: tuple = ()) -> Any:
    """``fn(names, leaf)`` over a nest of dicts, lists, tuples and
    dataclasses, ``names`` the dict keys and dataclass fields from the root
    (a sequence index adds ``""``, as a JAX ``SequenceKey`` reads); ``None``
    stays ``None``."""

    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_with_path(fn, v, path + ("",)) for v in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: _map_with_path(fn, getattr(node, f.name), path + (f.name,))
            for f in dataclasses.fields(node)})
    return fn(list(path), node)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


# -- specs --------------------------------------------------------------------------


def param_specs(params: Any, mesh_shape: dict, pcfg) -> Any:
    """Specs for a parameter tree by leaf path conventions."""

    def spec_for(names: list, leaf) -> Spec:
        name = names[-1] if names else ""
        shape = _shape(leaf)
        nd = len(shape)
        # stacked layers add a leading scan dim: never shard it
        lead: tuple = ()
        core = shape
        if any(n in _STACKED for n in names):
            k_lead = 2 if "ssm_layers" in names else 1  # (groups, per) for hybrid
            lead = (None,) * min(k_lead, nd)
            core = shape[len(lead):]
        logical = _logical_for(name, names, core, pcfg)
        return logical_to_spec(lead + logical, shape, mesh_shape, pcfg)

    return _map_with_path(spec_for, params)


def _logical_for(name: str, names: list, core: tuple, pcfg) -> tuple:
    nd = len(core)
    tp_heads = pcfg.attn_plan == "tp_heads"
    if name == "embed":
        return ("model", "fsdp")
    if name == "lm_head":
        return ("fsdp", "model")
    if name == "mm_proj":
        return ("fsdp", "model") if nd == 2 else (None,) * nd
    if name in ("wq", "wk", "wv"):
        # (d, heads, head_dim)
        return ("fsdp", "model" if tp_heads else None, None)
    if name == "wo":
        return ("model" if tp_heads else None, None, "fsdp")
    if name in ("bq", "bk", "bv"):
        return ("model" if tp_heads else None, None)
    # MLA
    if name == "wq_a":
        return ("fsdp", "model")
    if name == "wq_b":
        return ("fsdp", "model" if tp_heads else None, None)
    if name == "wkv_a":
        return ("fsdp", None)
    if name in ("wk_b", "wv_b"):
        return ("fsdp", "model" if tp_heads else None, None)
    # MLPs (dense): (d, f) / (f, d); MoE adds leading expert dim
    if name in ("w_gate", "w_up"):
        if nd == 3:
            return ("experts", "fsdp", None if pcfg.shard_experts else "model")
        return ("fsdp", "model")
    if name == "w_down":
        if nd == 3:
            return ("experts", None if pcfg.shard_experts else "model", "fsdp")
        return ("model", "fsdp")
    if name == "router":
        return ("fsdp", None)
    # mamba2
    if name == "w_in":
        return ("fsdp", "model")
    if name == "w_out":
        return ("model", "fsdp")
    if name in ("conv_w", "conv_b"):
        return (None,) * (nd - 1) + ("model",)
    return (None,) * nd


def batch_spec(batch: Any, mesh_shape: dict, pcfg) -> Any:
    """Input batch: leading batch dim over the data axes (replicated when
    it does not divide)."""

    def spec_for(names: list, leaf) -> Spec:
        shape = _shape(leaf)
        if not shape:
            return ()
        return logical_to_spec(("batch",) + (None,) * (len(shape) - 1), shape, mesh_shape, pcfg)

    return _map_with_path(spec_for, batch)


def cache_specs(cache: Any, mesh_shape: dict, pcfg, cfg) -> Any:
    """KV / SSM / latent caches.  Layout (L, B, S, H, D) for KV; batch over
    data axes; then either heads over model (tp) or sequence over model
    (``seq_shard_cache``); SSM states (L, B, H, P, N) shard heads over
    model."""

    def spec_for(names: list, leaf) -> Spec:
        name = names[-1] if names else ""
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return ()
        if name == "conv":
            return logical_to_spec((None, "batch", None, "model"), shape, mesh_shape, pcfg)
        if name == "state":
            return logical_to_spec((None, "batch", "model", None, None), shape, mesh_shape, pcfg)
        if name in ("ckv", "k_rope"):
            seq = "seq_model" if pcfg.seq_shard_cache else None
            return logical_to_spec((None, "batch", seq, None), shape, mesh_shape, pcfg)
        if name in ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v"):
            if pcfg.seq_shard_cache:
                return logical_to_spec(
                    (None, "batch", "seq_model", None, None)[:nd], shape, mesh_shape, pcfg)
            return logical_to_spec(
                (None, "batch", None, "model", None)[:nd], shape, mesh_shape, pcfg)
        return ()

    return _map_with_path(spec_for, cache)


# -- placements -------------------------------------------------------------------------


def mesh_shape(device_mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` with named dims."""

    return dict(zip(device_mesh.mesh_dim_names, device_mesh.mesh.shape))


def placements(spec: Spec, device_mesh) -> tuple:
    """One spec as DTensor placements: ``Shard(dim)`` on every mesh dim the
    spec names for tensor dim ``dim``, ``Replicate()`` on the others.  A
    mesh dim named twice, or an axis the mesh lacks, is refused."""

    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else tuple(axes):
            errors.check(
                a in names and isinstance(out[names.index(a)], Replicate),
                errors.ErrorClass.ERR_DIMS,
                f"spec {spec} maps axis {a!r} twice or onto a mesh without it "
                f"(mesh axes {names})",
            )
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def shardings(specs: Any, device_mesh) -> Any:
    """A spec tree as a tree of placement tuples on ``device_mesh``."""

    return _zip_spec(lambda s, _: placements(s, device_mesh), specs, specs)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) or (isinstance(a, tuple) and all(
            isinstance(b, str) for b in a)) for a in x)


def distribute(tree: Any, specs: Any, device_mesh) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``device_mesh`` under
    its spec.  Every rank holds the same whole leaf (the same seed, or a
    restore): each keeps its own shard, with no communication.  The dicts
    of ``tree`` are updated in place, leaf by leaf, so that a whole leaf
    held nowhere else is released as soon as its shard exists (a model one
    card holds only sharded is placed one leaf at a time); the placed tree
    is returned.  A leaf that is already a DTensor is redistributed."""

    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        pl = placements(spec, device_mesh)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(device_mesh, pl)
        out = distribute_tensor(leaf, device_mesh, pl, src_data_rank=None)
        local = out.to_local()
        if local.numel() < leaf.numel() and _shares_storage(local, leaf):
            # a leading-dim shard is a view: its own copy lets the leaf go
            out = DTensor.from_local(local.clone(), device_mesh, pl, run_check=False,
                                     shape=out.shape, stride=out.stride())
        return out

    return _zip_spec(place, tree, specs, inplace=True)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` is a view into ``b``'s storage.  A fake tensor (the dry run's
    stand-ins) has no data pointer: a view of one is taken as sharing."""

    if is_fake(a) or is_fake(b):
        return a._is_view()
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _zip_spec(fn: Callable, tree: Any, specs: Any, inplace: bool = False) -> Any:
    """``fn(leaf, spec)`` over ``tree`` and its spec tree (the same nest,
    where a spec tuple is a leaf); ``inplace`` updates ``tree``'s dicts."""

    if tree is None:
        return None
    if isinstance(tree, dict):
        out = tree if inplace else {}
        for k in list(tree):
            out[k] = _zip_spec(fn, tree[k], specs[k], inplace)
        return out
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return type(tree)(_zip_spec(fn, v, s, inplace) for v, s in zip(tree, specs))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _zip_spec(fn, getattr(tree, f.name), getattr(specs, f.name), inplace)
            for f in dataclasses.fields(tree)})
    return fn(tree, specs)

def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in :func:`repro_torch.core.futures.flatten`'s
    leaf order (dict keys sorted, dataclass fields in order)."""

    out: list = []

    def walk(node):
        if node is None:
            return
        if _is_spec(node):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))

    walk(specs)
    return out
