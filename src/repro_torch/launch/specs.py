"""Input stand-ins for the dry run, :mod:`repro.launch.specs` for the port:
every model input as a fake tensor (shape, dtype and device, no storage;
``models/api.param_structs``), with its spec under
:mod:`repro_torch.sharding.rules` and, on a communicator, placed as a
DTensor on its ``device_mesh``.

``input_specs(arch, shape, comm)`` returns the arguments of the matching
step (:mod:`repro_torch.launch.steps`: ``train_step`` / ``prefill_step`` /
``decode_step``), so the dry run is literally::

    step(*(kwargs[k] for k in ORDER[kind]))

traced once over fake tensors.  :func:`cell_structs` gives the same
stand-ins unplaced, with their specs, on a ``{axis: size}`` grid: no
process group is needed to check them (``shard_shape`` gives a leaf's
local shape under its spec).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import base
from repro_torch.core.futures import flatten
from repro_torch.models import api as model_api
from repro_torch.optim import AdamW
from repro_torch.sharding import rules

SIGLIP_DIM = 1152  # the VLM vision-stub feature width (SigLIP-So400m)

#: the step's argument order per kind, as the reference's dry run orders them
ORDER = {
    "train": ("params", "opt_state", "batch"),
    "prefill": ("params", "batch"),
    "decode": ("params", "cache", "token"),
}


def batch_structs(cfg: base.ModelConfig, shape: base.ShapeConfig, *, with_labels: bool,
                  device="cpu", mode=None) -> dict:
    """The input-batch stand-in for a full-sequence (train/prefill) step."""

    B, S = shape.global_batch, shape.seq_len
    with mode or model_api.fake_mode():
        def empty(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=device)

        batch: dict[str, Any] = {"tokens": empty((B, S), torch.int32)}
        if cfg.family == "vlm":
            # text tokens + precomputed patch embeddings; total trunk length
            # is num_image_tokens + S_text = S
            batch["tokens"] = empty((B, S - cfg.num_image_tokens), torch.int32)
            batch["image_embeds"] = empty((B, cfg.num_image_tokens, SIGLIP_DIM),
                                          torch.bfloat16)
        if cfg.family == "encdec":
            # precomputed frame embeddings (modality-frontend stub), source
            # length == target length == S
            batch["frames"] = empty((B, S, cfg.d_model), torch.bfloat16)
        if with_labels:
            batch["labels"] = empty(tuple(batch["tokens"].shape), torch.int32)
    return batch


def param_structs(bundle, device="cpu", mode=None) -> Any:
    return model_api.param_structs(bundle, device, mode=mode)


def opt_structs(opt: AdamW, params: Any, mode=None) -> Any:
    with mode or model_api.fake_mode(), torch.no_grad():
        return opt.init(params)


def cache_structs(bundle, cfg, pcfg, shape: base.ShapeConfig, device="cpu", mode=None) -> Any:
    """Decode-cell cache stand-ins (KV / MLA latent / SSM state / hybrid /
    an encoder-decoder's, from a prefill over S frames)."""

    return model_api.cache_structs(bundle, pcfg, shape.global_batch, shape.seq_len,
                                   device=device, mode=mode)


def token_struct(shape: base.ShapeConfig, device="cpu", mode=None) -> torch.Tensor:
    with mode or model_api.fake_mode():
        return torch.empty((shape.global_batch, 1), dtype=torch.int32, device=device)


def shard_shape(shape: tuple, spec: tuple, mesh_shape: dict) -> tuple:
    """A leaf's local shape on the first rank under ``spec``: each dim
    divided, rounding up, by the sizes of the axes it is split over — the
    local shape of its DTensor placements, and ``NamedSharding.
    shard_shape`` of the reference's sharding."""

    out = []
    for i, n in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        for a in () if axes is None else (axes,) if isinstance(axes, str) else axes:
            n = -(-n // mesh_shape[a])
        out.append(n)
    return tuple(out)


# ---------------------------------------------------------------------------
# assembled per-cell stand-ins + specs
# ---------------------------------------------------------------------------


def cell_structs(arch: str, shape: str | base.ShapeConfig, mesh_shape: dict,
                 pcfg: base.ParallelConfig | None = None, *, opt: AdamW | None = None,
                 device="cpu", cfg: base.ModelConfig | None = None, mode=None):
    """``(kind, structs, specs)`` of one cell: the step's arguments as fake
    tensors (whole, unplaced) by name, and their spec trees on the grid
    ``mesh_shape``.  ``cfg`` overrides the arch's published config (a
    smoke config, a cut depth)."""

    cfg = cfg or base.get_config(arch)
    shape = base.SHAPES[shape] if isinstance(shape, str) else shape
    pcfg = pcfg or base.get_parallel(arch, multi_pod="pod" in mesh_shape)
    bundle = model_api.build(cfg)
    mode = mode or model_api.fake_mode()

    params = param_structs(bundle, device, mode)
    pspecs = rules.param_specs(params, mesh_shape, pcfg)

    if shape.kind == "train":
        opt = opt or AdamW(lr=1e-4, moment_dtype=pcfg.moment_dtype)
        opt_state = opt_structs(opt, params, mode)
        ospecs = _moment_specs(params, pspecs, opt_state, mesh_shape)
        batch = batch_structs(cfg, shape, with_labels=True, device=device, mode=mode)
        bspecs = rules.batch_spec(batch, mesh_shape, pcfg)
        return "train", ({"params": params, "opt_state": opt_state, "batch": batch},
                         {"params": pspecs, "opt_state": ospecs, "batch": bspecs})

    if shape.kind == "prefill":
        batch = batch_structs(cfg, shape, with_labels=False, device=device, mode=mode)
        bspecs = rules.batch_spec(batch, mesh_shape, pcfg)
        return "prefill", ({"params": params, "batch": batch},
                           {"params": pspecs, "batch": bspecs})

    cache = cache_structs(bundle, cfg, pcfg, shape, device, mode)
    cspecs = rules.cache_specs(cache, mesh_shape, pcfg, cfg)
    tok = token_struct(shape, device, mode)
    tspec = rules.batch_spec({"t": tok}, mesh_shape, pcfg)["t"]
    return "decode", ({"params": params, "cache": cache, "token": tok},
                      {"params": pspecs, "cache": cspecs, "token": tspec})


def input_specs(arch: str, shape: str | base.ShapeConfig, comm,
                pcfg: base.ParallelConfig | None = None, *, opt: AdamW | None = None,
                device="cpu", cfg: base.ModelConfig | None = None, microbatches: int = 1):
    """``(kind, kwargs, specs)`` for one cell on ``comm``: the stand-ins of
    :func:`cell_structs` placed on ``comm.device_mesh`` under their specs
    (plain, on ``comm=None``: one rank)
    (every rank holds the same whole stand-in and keeps its shard, as the
    port's trainer and server place their state; a prefill or decode cell
    on a grid whose model axis is one rank stays plain and whole, as the
    port's server keeps whole weights and runs the whole batch there).  With ``microbatches``
    > 1 a train cell's batch is a list of that many placed microbatches,
    split along the batch before placement (the reference splits it inside
    its step)."""

    mesh = comm.device_mesh if comm is not None else None
    shp = rules.mesh_shape(mesh) if mesh is not None else {"data": 1, "model": 1}
    kind, (structs, specs) = cell_structs(arch, shape, shp, pcfg, opt=opt, device=device,
                                          cfg=cfg)
    if kind != "train" and shp.get(getattr(pcfg, "model_axis", "model"), 1) == 1:
        # a server whose model axis is one rank keeps whole weights as plain
        # tensors, and runs the whole batch, on every rank (runtime/server.py)
        specs = {name: _replicated(sp) for name, sp in specs.items()}
        mesh = None
    if mesh is None:
        # one rank: plain tensors, as the port's trainer and server keep them
        if kind == "train" and microbatches > 1:
            structs["batch"] = [{k: v.chunk(microbatches)[i] for k, v in structs["batch"].items()}
                                for i in range(microbatches)]
        if kind == "train":
            for leaf in _leaves(structs["params"]):
                leaf.requires_grad_(True)
        return kind, structs, specs
    placed = {}
    with torch.no_grad():
        for name, tree in structs.items():
            if name == "batch" and kind == "train" and microbatches > 1:
                pieces = [{k: v.chunk(microbatches)[i] for k, v in tree.items()}
                          for i in range(microbatches)]
                placed[name] = [rules.distribute(b, rules.batch_spec(b, shp, pcfg or
                                                                     base.get_parallel(arch)),
                                                 mesh) for b in pieces]
            elif name == "token":
                placed[name] = rules.distribute({"t": tree}, {"t": specs[name]}, mesh)["t"]
            else:
                placed[name] = rules.distribute(tree, specs[name], mesh)
    if kind == "train":
        for leaf in _leaves(placed["params"]):
            leaf.requires_grad_(True)
    return kind, placed, specs


def _replicated(specs):
    """``specs`` with every leaf's spec replicated (no axis named)."""

    if rules._is_spec(specs):
        return (None,) * len(specs)
    if isinstance(specs, dict):
        return {k: _replicated(v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_replicated(v) for v in specs)
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return dataclasses.replace(specs, **{
            f.name: _replicated(getattr(specs, f.name)) for f in dataclasses.fields(specs)})
    return specs


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _moment_specs(params, pspecs, opt_state, mesh_shape: dict):
    """Adam moments inherit the matching parameter's spec (ZeRO), as the
    reference's ``_moment_shardings`` gives them: a moment (an int8
    moment's payload) its own parameter's spec — by path, as the port's
    trainer places it (``runtime/trainer.state_specs``, ROADMAP C23; the
    reference matches by shape, which differs only where two parameters of
    one shape are split differently) — and every other leaf by shape, else
    a 1-D leaf of at least 1024 elements split over every grid axis it
    divides (its flat split, as placements), else replicated.  An int8
    moment's per-row scales are matched that way too (the port's trainer
    splits them as their payload's rows instead; the dry run keeps the
    reference's)."""

    by_shape: dict = {}
    for leaf, spec in zip(flatten(params)[0], rules.spec_leaves(pspecs)):
        by_shape.setdefault(tuple(leaf.shape), spec)

    def flat_spec(n: int) -> tuple:
        axes: list = []
        total = 1
        for a, s in mesh_shape.items():
            if n % (total * s) == 0:
                axes.append(a)
                total *= s
        return (tuple(axes),) if axes else (None,)

    def spec_for(leaf: torch.Tensor) -> tuple:
        shape = tuple(leaf.shape)
        hit = by_shape.get(shape)
        if hit is not None:
            return hit
        if len(shape) == 1 and shape[0] >= 1024:
            return flat_spec(shape[0])
        return (None,) * len(shape)

    def own(node, ps):
        # a moment tree beside its parameters' specs
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: own(v, ps[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not rules._is_spec(ps):
            return type(node)(own(v, s) for v, s in zip(node, ps))
        if isinstance(node, torch.Tensor):
            return ps
        return dataclasses.replace(node, **{
            f.name: ps if f.name == "q" else walk(getattr(node, f.name))
            for f in dataclasses.fields(node)})

    def walk(node):
        if node is None:
            return None
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return dataclasses.replace(node, **{
                f.name: own(getattr(node, f.name), pspecs) if f.name in ("mu", "nu")
                else walk(getattr(node, f.name)) for f in dataclasses.fields(node)})
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name)) for f in dataclasses.fields(node)})
        return spec_for(node)

    return walk(opt_state)
