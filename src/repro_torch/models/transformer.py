"""Decoder-only LM trunk: dense (qwen/phi4/granite), gemma-2's local-global
alternation with softcaps, MoE (grok-1), MLA + MoE with a leading dense
layer (deepseek-v2) and the prefix-LM VLM (paligemma), with forward / loss /
prefill / decode entry points and the pipeline's stage decomposition
(:func:`pipeline_stage_fns`) — :mod:`repro.models.transformer`.

The parameter tree is the reference's: ``params["layers"][name]`` stacks
every leaf of one sub-layer along a leading unit dimension.  The reference
``scan``\\ s over that dimension; eager PyTorch loops over it.  Remat
(``pcfg.remat``) wraps each unit of the loss path in
``torch.utils.checkpoint`` (:func:`_maybe_remat`).  The VLM projects its
image embeddings through ``mm_proj`` and puts them before the text, a
bidirectional prefix of ``num_image_tokens`` under ``prefix_lm``.  The
``first_dense_layers`` blocks (``params["dense_{i}"]``) run before the
stack, unstacked and not rematted, as in the reference; the MoE blocks'
aux metrics are summed over the stacked units.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.core import errors
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.common import dense_init
from repro_torch.sharding.local import is_dtensor, local_map

_AUX = ("load_balance_loss", "router_z_loss", "dropped_fraction")


# ---------------------------------------------------------------------------
# layer units
# ---------------------------------------------------------------------------


def _init_block(gen, cfg, dtype, *, kind: str, stack: tuple[int, ...] = ()) -> common.Params:
    """One residual block: attention (GQA or MLA) + (dense|moe) MLP with
    pre-norms (+ gemma-2 post-norms); ``stack`` prepends the unit dimension
    to every leaf."""

    def norm():
        return torch.zeros(stack + (cfg.d_model,), dtype=dtype, device=gen.device)

    p: common.Params = {"ln_attn": norm(), "ln_mlp": norm()}
    if cfg.post_norms:
        p["ln_attn_post"] = norm()
        p["ln_mlp_post"] = norm()
    p["attn"] = (attn.init_mla(gen, cfg, dtype, stack=stack) if cfg.mla
                 else attn.init_attention(gen, cfg, dtype, stack=stack))
    if kind == "moe":
        p["mlp"] = mlp.init_moe(gen, cfg, dtype, stack=stack)
    else:
        p["mlp"] = mlp.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, stack=stack)
    return p


def _block_full(
    p, x, cfg, pcfg, *, kind, sliding_window, positions, prefix_len, mesh, collect_cache
):
    """Full-sequence block.  Returns (x, cache_entry, aux)."""

    h = common.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    cache_entry = None
    if cfg.mla:
        if collect_cache:
            a, cache_entry = attn.mla_attention_full(
                p["attn"], h, cfg, pcfg, positions=positions, mesh=mesh, return_cache=True
            )
        else:
            a = attn.mla_attention_full(p["attn"], h, cfg, pcfg, positions=positions, mesh=mesh)
    elif collect_cache:
        a, cache_entry = attn.attention_prefill(
            p["attn"], h, cfg, pcfg, positions=positions,
            sliding_window=sliding_window, prefix_len=prefix_len, mesh=mesh,
        )
    else:
        a = attn.attention_full(
            p["attn"], h, cfg, pcfg, positions=positions,
            sliding_window=sliding_window, prefix_len=prefix_len, mesh=mesh,
        )
    if cfg.post_norms:
        a = common.rms_norm(a, p["ln_attn_post"], cfg.norm_eps)
    x = x + a

    h = common.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    aux = {}
    if kind == "moe":
        m, aux = mlp.moe(p["mlp"], h, cfg, pcfg=pcfg)
    else:
        m = mlp.mlp(p["mlp"], h, cfg.act)
    if cfg.post_norms:
        m = common.rms_norm(m, p["ln_mlp_post"], cfg.norm_eps)
    return x + m, cache_entry, aux


def _block_decode(p, x1, cache_slices, pos, cfg, pcfg, *, kind, sliding_window, mesh):
    """Single-token block.  ``cache_slices``: layer slices of the cache
    arrays, updated in place.  Returns (x1, cache_slices)."""

    h = common.rms_norm(x1, p["ln_attn"], cfg.norm_eps)
    if cfg.mla:
        ckv_l, krope_l = cache_slices
        a, new_slices = attn.mla_attention_decode(
            p["attn"], h, ckv_l, krope_l, pos, cfg, pcfg, mesh=mesh
        )
    else:
        k_l, v_l, ks_l, vs_l = cache_slices
        a, new_slices = attn.attention_decode(
            p["attn"], h, k_l, v_l, ks_l, vs_l, pos, cfg, pcfg,
            sliding_window=sliding_window, mesh=mesh,
        )
    if cfg.post_norms:
        a = common.rms_norm(a, p["ln_attn_post"], cfg.norm_eps)
    x1 = x1 + a

    h = common.rms_norm(x1, p["ln_mlp"], cfg.norm_eps)
    if kind == "moe":
        m, _ = mlp.moe(p["mlp"], h, cfg, pcfg=pcfg)
    else:
        m = mlp.mlp(p["mlp"], h, cfg.act)
    if cfg.post_norms:
        m = common.rms_norm(m, p["ln_mlp_post"], cfg.norm_eps)
    return x1 + m, new_slices


# ---------------------------------------------------------------------------
# layer-stack layout
# ---------------------------------------------------------------------------


def _unit_plan(cfg) -> list[tuple[str, str, int | None]]:
    """The sub-layers of one unit: list of (name, kind, window)."""

    if cfg.layer_pattern == "local_global":
        return [
            ("local", _mlp_kind(cfg), cfg.sliding_window),
            ("global", _mlp_kind(cfg), None),
        ]
    return [("layer", _mlp_kind(cfg), cfg.sliding_window)]


def _mlp_kind(cfg) -> str:
    return "moe" if cfg.num_experts else "dense"


def _num_units(cfg) -> int:
    """Stacked units: the layers after the ``first_dense_layers``."""

    n_scanned = cfg.num_layers - cfg.first_dense_layers
    per_unit = len(_unit_plan(cfg))
    errors.check(
        n_scanned >= 0 and n_scanned % per_unit == 0,
        errors.ErrorClass.ERR_DIMS,
        f"{n_scanned} stacked layers do not fold into units of {per_unit}",
    )
    return n_scanned // per_unit


def _unit(tree: Any, i: int) -> Any:
    """Unit ``i`` of a stacked parameter tree (views, no copy)."""

    if isinstance(tree, dict):
        return {k: _unit(v, i) for k, v in tree.items()}
    return tree[i]


def _units(tree: Any) -> list:
    """Every unit of a stacked parameter tree (views, no copy), by one
    ``torch.unbind`` per leaf.  Under autograd its backward stacks the
    units' gradients once; taking the units one by one (:func:`_unit`)
    would give each its own zero-filled gradient of the whole stack, summed
    unit by unit — a stack's worth of memory traffic per layer."""

    if isinstance(tree, dict):
        parts = {k: _units(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products without batch dimensions (the
    weight projections, which reach ``aten.mm`` / ``aten.addmm``); recompute
    everything else — the reference's ``dots_with_no_batch_dims_saveable``."""

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, pcfg):
    """``pcfg.remat`` on one unit: ``"none"`` runs ``fn`` as it is;
    ``"full"`` keeps only the unit's inputs and recomputes its forward in
    the backward (``torch.utils.checkpoint``); ``"dots"`` also keeps the
    outputs of its weight products (a selective checkpoint).  Without grad
    (serving) the unit runs plainly."""

    if pcfg.remat == "none":
        return fn
    kw = {}
    if pcfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the units draw no random numbers, so the recompute needs no saved
        # RNG state: exact, and reading the CUDA RNG state is a host sync that
        # CUDA graph capture refuses
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run


def init_lm(gen: torch.Generator, cfg) -> common.Params:
    """Random parameters on ``gen.device``, drawn from ``gen``."""

    dtype = common.dtype_of(cfg)
    params: common.Params = {
        "embed": common.trunc_normal(gen, (cfg.padded_vocab, cfg.d_model), 1.0, dtype),
        "final_norm": common.init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, (cfg.d_model, cfg.padded_vocab), dtype)
    n_units = _num_units(cfg)
    params["layers"] = {
        name: _init_block(gen, cfg, dtype, kind=kind, stack=(n_units,))
        for name, kind, _ in _unit_plan(cfg)
    }
    for i in range(cfg.first_dense_layers):
        params[f"dense_{i}"] = _init_block(gen, cfg, dtype, kind="dense")
    if cfg.family == "vlm":
        # multimodal projector (SigLIP stub dim 1152 → d_model)
        params["mm_proj"] = dense_init(gen, 1152, (1152, cfg.d_model), dtype)
    return params


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg):
    x = common.embed(params["embed"], tokens)
    if cfg.embed_scale:
        # a fill kernel (capturable in a CUDA graph), rounded to x's dtype as
        # the reference's constant is
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _head(params, x, cfg, pcfg=None):
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].t())
    else:
        logits = torch.matmul(x, params["lm_head"])
    if pcfg is not None:
        logits = common.constrain(logits, pcfg, logits=True)
    return logits


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _prepare_inputs(params, batch: dict, cfg):
    """tokens (+ image embeds for VLM) → (x, positions, prefix_len)."""

    x = _embed(params, batch["tokens"], cfg)
    prefix_len = None
    if cfg.family == "vlm":
        img = torch.matmul(batch["image_embeds"].to(x.dtype), params["mm_proj"])
        x = torch.cat([img, x], dim=1)
        prefix_len = cfg.num_image_tokens if cfg.prefix_lm else None
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions, prefix_len


def lm_forward(params, batch: dict, cfg, pcfg, mesh=None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward → (logits, aux metrics).  The leading dense
    blocks run first and are not rematted; the aux metrics are summed over
    the stacked units."""

    x, positions, prefix_len = _prepare_inputs(params, batch, cfg)
    x = common.constrain(x, pcfg)
    for i in range(cfg.first_dense_layers):
        x, _, _ = _block_full(
            params[f"dense_{i}"], x, cfg, pcfg, kind="dense", sliding_window=None,
            positions=positions, prefix_len=prefix_len, mesh=mesh, collect_cache=False,
        )
    plan = _unit_plan(cfg)

    def unit(x, unit_params):
        aux_l = {}
        x = common.constrain(x, pcfg)
        for name, kind, window in plan:
            x, _, aux = _block_full(
                unit_params[name], x, cfg, pcfg, kind=kind, sliding_window=window,
                positions=positions, prefix_len=prefix_len, mesh=mesh, collect_cache=False,
            )
            x = common.constrain(x, pcfg)
            for k_, v_ in aux.items():
                aux_l[k_] = aux_l[k_] + v_ if k_ in aux_l else v_
        return x, aux_l

    unit = _maybe_remat(unit, pcfg)
    units = _units(params["layers"])
    errors.check(len(units) == _num_units(cfg), errors.ErrorClass.ERR_DIMS,
                 f"{len(units)} stacked units, the config folds {_num_units(cfg)}")
    per_unit = []
    for unit_params in units:
        x, aux_l = unit(x, unit_params)
        per_unit.append(aux_l)
    logits = _head(params, x, cfg, pcfg)
    aux = {k_: 0.0 for k_ in _AUX}
    if per_unit and per_unit[0]:
        aux.update({k_: torch.stack([a[k_] for a in per_unit]).sum() for k_ in per_unit[0]})
    return logits, aux


def lm_loss(params, batch: dict, cfg, pcfg, mesh=None) -> tuple[torch.Tensor, dict]:
    logits, aux = lm_forward(params, batch, cfg, pcfg, mesh)
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        # labels cover only the text region (image prefix contributes no loss)
        logits = logits[:, cfg.num_image_tokens:]
    loss = common.cross_entropy(
        logits[:, :-1], tokens[:, 1:], softcap_val=cfg.final_logit_softcap
    )
    if cfg.num_experts:
        loss = loss + 1e-2 * aux["load_balance_loss"] + 1e-3 * aux["router_z_loss"]
    metrics = {"loss": loss, **{k: torch.as_tensor(v) for k, v in aux.items()}}
    return loss, metrics


# -- pipeline-parallel stage decomposition (MPI 4.0 ch. 8 fabric) -------------


def pipeline_stage_fns(cfg, pcfg):
    """Decompose the LM into the three pieces the pipeline schedule
    (:func:`repro_torch.core.overlap.pipeline_spmd`) streams microbatches
    through: ``embed_mb`` (stage-0 injection), ``apply_units`` (each stage's
    local slice of the stacked layers), ``loss_mb`` (last-stage head + CE).

    They run on this rank's local tensors (the stage's slice of
    ``params['layers']``, the replicated leaves whole), so the model's
    sharding constraints are neutralised (``data_axes=()``), as the
    reference's are inside ``shard_map``.  Requires the fully stacked
    layout (``first_dense_layers == 0``): the stage split is a slice of the
    stacked ``params['layers']`` leading dim."""

    errors.check(
        cfg.first_dense_layers == 0,
        errors.ErrorClass.ERR_TOPOLOGY,
        "pipeline stages require a fully-scanned layer stack "
        f"(first_dense_layers={cfg.first_dense_layers})",
    )
    errors.check(
        cfg.family in ("dense", "moe"),
        errors.ErrorClass.ERR_TOPOLOGY,
        f"pipeline stage decomposition supports dense/moe LMs, not {cfg.family!r}",
    )
    local_pcfg = dataclasses.replace(pcfg, data_axes=())
    plan = _unit_plan(cfg)

    def embed_mb(params, tokens_mb):
        """(mb, T) tokens → (mb, T, D) stage-0 activations."""

        return _embed(params, tokens_mb, cfg)

    def apply_units(layers_local, x):
        """Apply this stage's local stacked units to the in-flight
        activation (positions are full-sequence — microbatches split the
        batch dim, never the sequence)."""

        positions = torch.arange(x.shape[1], device=x.device)

        def unit(x, unit_params):
            for name, kind, window in plan:
                x, _, _ = _block_full(
                    unit_params[name], x, cfg, local_pcfg, kind=kind,
                    sliding_window=window, positions=positions, prefix_len=None,
                    mesh=None, collect_cache=False,
                )
            return x

        unit = _maybe_remat(unit, local_pcfg)
        for unit_params in _units(layers_local):
            x = unit(x, unit_params)
        return x

    def loss_mb(params, x, tokens_mb):
        """Last-stage head + token-mean CE for one microbatch."""

        logits = _head(params, x, cfg, None)
        return common.cross_entropy(
            logits[:, :-1], tokens_mb[:, 1:], softcap_val=cfg.final_logit_softcap
        )

    return embed_mb, apply_units, loss_mb


# -- caches -------------------------------------------------------------------


def init_cache(cfg, pcfg, batch: int, length: int, device=None) -> dict[str, Any]:
    """Cache tree for decode: one entry per unit sub-layer name and per
    leading dense block (``dense_{i}``).  MLA's latent cache stays in the
    model's dtype under an int8 ``kv_cache_dtype`` too, as the reference's
    (ROADMAP C13)."""

    n_units = _num_units(cfg)
    dtype = common.dtype_of(cfg)
    quant = pcfg.kv_cache_dtype == "int8"
    caches: dict[str, Any] = {}
    if cfg.mla:
        caches["layer"] = MLACache.init(
            n_units, batch, length, cfg.kv_lora, cfg.rope_head_dim, dtype, device
        )
        for i in range(cfg.first_dense_layers):
            caches[f"dense_{i}"] = MLACache.init(
                1, batch, length, cfg.kv_lora, cfg.rope_head_dim, dtype, device
            )
        return caches
    for name, _, window in _unit_plan(cfg):
        cap = min(length, window) if window else length
        caches[name] = KVCache.init(
            n_units, batch, cap, cfg.num_kv_heads, cfg.head_dim, dtype=dtype,
            quantized=quant, device=device,
        )
    for i in range(cfg.first_dense_layers):
        caches[f"dense_{i}"] = KVCache.init(
            1, batch, length, cfg.num_kv_heads, cfg.head_dim, dtype=dtype,
            quantized=quant, device=device,
        )
    return caches


def lm_prefill(params, batch: dict, cfg, pcfg, mesh=None, extra_capacity: int = 0):
    """Prefill: full forward that also builds the cache.  Returns
    (last-token logits, cache dict)."""

    x, positions, prefix_len = _prepare_inputs(params, batch, cfg)
    x = common.constrain(x, pcfg)
    seq = x.shape[1]
    caches: dict[str, Any] = {}
    for i in range(cfg.first_dense_layers):
        x, entry, _ = _block_full(
            params[f"dense_{i}"], x, cfg, pcfg, kind="dense", sliding_window=None,
            positions=positions, prefix_len=prefix_len, mesh=mesh, collect_cache=True,
        )
        caches[f"dense_{i}"] = _entry_to_cache(
            entry, cfg, pcfg, stack=True, extra=extra_capacity
        )
    plan = _unit_plan(cfg)
    entries: dict[str, list] = {name: [] for name, _, _ in plan}
    for u in range(_num_units(cfg)):
        unit_params = _unit(params["layers"], u)
        x = common.constrain(x, pcfg)
        for name, kind, window in plan:
            x, entry, _ = _block_full(
                unit_params[name], x, cfg, pcfg, kind=kind, sliding_window=window,
                positions=positions, prefix_len=prefix_len, mesh=mesh, collect_cache=True,
            )
            x = common.constrain(x, pcfg)
            entries[name].append(entry)
    pos = torch.tensor(seq, dtype=torch.int32, device=x.device)
    for name, _, window in plan:
        # windowed layers use a fixed ring buffer — no headroom needed
        extra = 0 if (window is not None and seq > window) else extra_capacity
        stacked = tuple(torch.stack(parts) for parts in zip(*entries[name]))
        caches[name] = _entry_to_cache(stacked, cfg, pcfg, stack=False, extra=extra)
    caches = {name: dataclasses.replace(c, pos=pos) for name, c in caches.items()}
    logits = _head(params, x[:, -1:], cfg, pcfg)
    if cfg.final_logit_softcap:
        logits = common.softcap(logits, cfg.final_logit_softcap)
    return logits, caches


def _pad_seq(arr, extra: int):
    """Decode headroom: grow the cache's sequence axis (axis 2 of the
    stacked layout) by ``extra`` zero slots so decode never writes past
    capacity."""

    if not extra:
        return arr
    if is_dtensor(arr):
        # padded on each rank's shard: the sequence is whole there (DTensor's
        # own padding decomposition fails over a split dim on torch 2.11)
        from torch.distributed.tensor import Replicate

        pl = [Replicate() if p.is_shard(2) or p.is_partial() else p for p in arr.placements]
        return local_map(lambda a: _pad_seq(a, extra), out_placements=pl, in_placements=(pl,),
                         device_mesh=arr.device_mesh, redistribute_inputs=True)(arr)
    return torch.nn.functional.pad(arr, (0, 0) * (arr.dim() - 3) + (0, extra))


def _entry_to_cache(entry, cfg, pcfg, *, stack: bool, extra: int = 0):
    """Stacked (L, B, S, Hk, Dh) entries (MLA: (L, B, S, kv_lora) and
    (L, B, S, rope)) → cache.  The int8 cache pads, then quantizes, as the
    reference does: the headroom's zero rows carry scale 1.0, and each of k
    and v is one quantize call over all layers; MLA's latents are not
    quantized."""

    dtype = common.dtype_of(cfg)
    pos = torch.zeros((), dtype=torch.int32, device=entry[0].device)
    if cfg.mla:
        ckv, krope = entry
        if stack:
            ckv, krope = ckv[None], krope[None]
        ckv, krope = _pad_seq(ckv, extra), _pad_seq(krope, extra)
        return MLACache(ckv=ckv.to(dtype), k_rope=krope.to(dtype), pos=pos)
    k, v = entry
    if stack:
        k, v = k[None], v[None]
    k, v = _pad_seq(k, extra), _pad_seq(v, extra)
    if pcfg.kv_cache_dtype == "int8":
        kq, ksc = attn._quantize_kv(k)
        vq, vsc = attn._quantize_kv(v)
        return KVCache(k=kq, v=vq, k_scale=ksc, v_scale=vsc, pos=pos)
    return KVCache(k=k.to(dtype), v=v.to(dtype), k_scale=None, v_scale=None, pos=pos)


def _cache_xs(cache) -> tuple:
    """The stacked arrays of one cache, in the order a block reads them."""

    if isinstance(cache, MLACache):
        return (cache.ckv, cache.k_rope)
    return (cache.k, cache.v, cache.k_scale, cache.v_scale)


def lm_decode(params, caches: dict, token: torch.Tensor, cfg, pcfg, mesh=None):
    """One decode step.  token: (B, 1) int32.  Returns (logits, caches); the
    cache tensors are updated in place and every cache's ``pos`` (the shared
    scalar, or the engine's per-row (B,) vector) advances.  A VLM's image
    prefix already lives in the cache."""

    pos = next(iter(caches.values())).pos
    x = _embed(params, token, cfg)
    x = common.constrain(x, pcfg)
    for i in range(cfg.first_dense_layers):
        slices = tuple(None if a is None else a[0] for a in _cache_xs(caches[f"dense_{i}"]))
        x, _ = _block_decode(
            params[f"dense_{i}"], x, slices, pos, cfg, pcfg,
            kind="dense", sliding_window=None, mesh=mesh,
        )
    plan = _unit_plan(cfg)
    for u in range(_num_units(cfg)):
        unit_params = _unit(params["layers"], u)
        for name, kind, window in plan:
            slices = tuple(None if a is None else a[u] for a in _cache_xs(caches[name]))
            x, _ = _block_decode(
                unit_params[name], x, slices, pos, cfg, pcfg,
                kind=kind, sliding_window=window, mesh=mesh,
            )
    new_pos = pos + 1
    caches = {name: dataclasses.replace(c, pos=new_pos) for name, c in caches.items()}
    logits = _head(params, x, cfg, pcfg)
    if cfg.final_logit_softcap:
        logits = common.softcap(logits, cfg.final_logit_softcap)
    return logits, caches
