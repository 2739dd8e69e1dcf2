"""Attention-free Mamba-2 LM (mamba2-2.7b) and the Mamba-2 + shared-attention
hybrid (zamba2-7b) — :mod:`repro.models.ssm_lm` in eager PyTorch.

The parameter tree is the reference's: ``layers`` stacks every leaf over
``num_layers``; the hybrid's ``ssm_layers`` are shaped ``(groups,
attn_every, …)``, ``ssm_tail`` ``(rest, …)`` and ``shared_attn`` is not
stacked.  Python loops stand in for the reference's nested ``scan``\\ s.
Decode updates the cache tensors in place, as the reference's donated
buffers are; ``pos`` advances.  The loss paths remat each layer (and each
shared-attention group) as the reference does (``transformer._maybe_remat``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, ssm
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import _entry_to_cache, _maybe_remat, _unit, _units


# ---------------------------------------------------------------------------
# pure SSM LM
# ---------------------------------------------------------------------------


def _init_ssm_layer(gen, cfg, dtype, stack: tuple[int, ...]) -> common.Params:
    return {
        "ln": torch.zeros(stack + (cfg.d_model,), dtype=dtype, device=gen.device),
        "mixer": ssm.init_mamba2(gen, cfg, dtype, stack=stack),
    }


def init_ssm_lm(gen: torch.Generator, cfg) -> common.Params:
    """Random parameters on ``gen.device``, drawn from ``gen``."""

    dtype = common.dtype_of(cfg)
    return {
        "embed": common.trunc_normal(gen, (cfg.padded_vocab, cfg.d_model), 1.0, dtype),
        "final_norm": common.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "layers": _init_ssm_layer(gen, cfg, dtype, (cfg.num_layers,)),
    }


def _ssm_layer_full(lp, x, cfg, pcfg, *, collect_cache=False):
    h = common.rms_norm(x, lp["ln"], cfg.norm_eps)
    if collect_cache:
        y, cache = ssm.mamba2_full(lp["mixer"], h, cfg, pcfg, return_cache=True)
        return x + y, cache
    return x + ssm.mamba2_full(lp["mixer"], h, cfg, pcfg), None


def _ssm_layer_decode(lp, x, cache: SSMCache, layer: int, cfg, pcfg):
    """One layer's decode step; writes its conv window and state into
    ``cache`` at ``layer``."""

    h = common.rms_norm(x, lp["ln"], cfg.norm_eps)
    y, (conv, state) = ssm.mamba2_decode(
        lp["mixer"], h, cache.conv[layer], cache.state[layer], cfg, pcfg
    )
    cache.conv[layer].copy_(conv)
    cache.state[layer].copy_(state)
    return x + y


def _logits(params, x, cfg):
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.matmul(x, params["embed"].t())


def _ssm_cache(convs, states, pos, cfg) -> SSMCache:
    return SSMCache(conv=torch.stack(convs).to(common.dtype_of(cfg)),
                    state=torch.stack(states), pos=pos)


def ssm_lm_loss(params, batch, cfg, pcfg, mesh=None):
    tokens = batch["tokens"]
    x = common.embed(params["embed"], tokens)

    def unit(x, lp):
        return _ssm_layer_full(lp, x, cfg, pcfg)[0]

    unit = _maybe_remat(unit, pcfg)
    for lp in _units(params["layers"]):
        x = unit(x, lp)
    logits = _logits(params, x, cfg)
    loss = common.cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss, {"loss": loss}


def ssm_lm_prefill(params, batch, cfg, pcfg, mesh=None, extra_capacity: int = 0):
    """Returns (last-token logits, :class:`SSMCache`); the state needs no
    headroom, so ``extra_capacity`` is unused, as in the reference."""

    tokens = batch["tokens"]
    x = common.embed(params["embed"], tokens)
    convs, states = [], []
    for i in range(cfg.num_layers):
        x, (conv, state) = _ssm_layer_full(
            _unit(params["layers"], i), x, cfg, pcfg, collect_cache=True
        )
        convs.append(conv)
        states.append(state)
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    return _logits(params, x[:, -1:], cfg), _ssm_cache(convs, states, pos, cfg)


def ssm_lm_decode(params, cache: SSMCache, token, cfg, pcfg, mesh=None):
    x = common.embed(params["embed"], token)
    for i in range(cfg.num_layers):
        x = _ssm_layer_decode(_unit(params["layers"], i), x, cache, i, cfg, pcfg)
    cache = dataclasses.replace(cache, pos=cache.pos + 1)
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# hybrid (zamba2): Mamba-2 backbone + one shared attention block applied
# every `attn_every` layers (weights shared across applications)
# ---------------------------------------------------------------------------


def _hybrid_split(cfg) -> tuple[int, int]:
    groups = cfg.num_layers // cfg.attn_every
    rest = cfg.num_layers - groups * cfg.attn_every
    return groups, rest


def init_hybrid_lm(gen: torch.Generator, cfg) -> common.Params:
    dtype = common.dtype_of(cfg)
    groups, rest = _hybrid_split(cfg)

    def norm():
        return common.init_rmsnorm(cfg.d_model, dtype, gen.device)

    params: common.Params = {
        "embed": common.trunc_normal(gen, (cfg.padded_vocab, cfg.d_model), 1.0, dtype),
        "final_norm": norm(),
        "ssm_layers": _init_ssm_layer(gen, cfg, dtype, (groups, cfg.attn_every)),
        "shared_attn": {
            "ln_attn": norm(),
            "attn": attn.init_attention(gen, cfg, dtype),
            "ln_mlp": norm(),
            "mlp": mlp.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
        },
    }
    if rest:
        params["ssm_tail"] = _init_ssm_layer(gen, cfg, dtype, (rest,))
    return params


def _ssm_units(params, cfg):
    """(layer index, layer params) of every Mamba-2 layer, grouped as the
    hybrid runs them: one list per shared-attention application, then the
    tail."""

    groups, rest = _hybrid_split(cfg)
    per = cfg.attn_every
    grouped = [[(g * per + j, lp) for j, lp in enumerate(_units(group))]
               for g, group in enumerate(_units(params["ssm_layers"]))]
    tail = [(groups * per + t, lp)
            for t, lp in enumerate(_units(params["ssm_tail"]) if rest else [])]
    return grouped, tail


def _shared_attn_full(sp, x, cfg, pcfg, *, positions, mesh, collect_cache):
    h = common.rms_norm(x, sp["ln_attn"], cfg.norm_eps)
    if collect_cache:
        a, entry = attn.attention_prefill(
            sp["attn"], h, cfg, pcfg, positions=positions, sliding_window=None, mesh=mesh
        )
    else:
        a = attn.attention_full(
            sp["attn"], h, cfg, pcfg, positions=positions, sliding_window=None, mesh=mesh
        )
        entry = None
    x = x + a
    h = common.rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
    return x + mlp.mlp(sp["mlp"], h, cfg.act), entry


def hybrid_lm_loss(params, batch, cfg, pcfg, mesh=None):
    tokens = batch["tokens"]
    x = common.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    grouped, tail = _ssm_units(params, cfg)

    def group_unit(x, units):
        x, _ = _shared_attn_full(params["shared_attn"], x, cfg, pcfg, positions=positions,
                                 mesh=mesh, collect_cache=False)
        for _, lp in units:
            x, _ = _ssm_layer_full(lp, x, cfg, pcfg)
        return x

    def inner_tail(x, lp):
        return _ssm_layer_full(lp, x, cfg, pcfg)[0]

    group_unit, inner_tail = _maybe_remat(group_unit, pcfg), _maybe_remat(inner_tail, pcfg)
    for units in grouped:
        x = group_unit(x, units)
    for _, lp in tail:
        x = inner_tail(x, lp)
    logits = _logits(params, x, cfg)
    loss = common.cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss, {"loss": loss}


@dataclasses.dataclass
class HybridCache:
    attn: KVCache          # (groups, B, S, Hk, Dh)
    ssm: SSMCache          # (groups*per + rest, ...)

    @property
    def pos(self):
        return self.ssm.pos


def init_hybrid_cache(cfg, pcfg, batch: int, length: int, device=None) -> HybridCache:
    groups, _ = _hybrid_split(cfg)
    dtype = common.dtype_of(cfg)
    return HybridCache(
        attn=KVCache.init(
            groups, batch, length, cfg.num_kv_heads, cfg.head_dim,
            dtype=dtype, quantized=pcfg.kv_cache_dtype == "int8", device=device,
        ),
        ssm=SSMCache.init(cfg.num_layers, batch, cfg, dtype, device),
    )


def hybrid_lm_prefill(params, batch, cfg, pcfg, mesh=None, extra_capacity: int = 0):
    """Returns (last-token logits, :class:`HybridCache`); the KV cache gets
    ``extra_capacity`` empty slots of decode headroom."""

    tokens = batch["tokens"]
    x = common.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    grouped, tail = _ssm_units(params, cfg)
    entries, convs, states = [], [], []
    for units in grouped:
        x, entry = _shared_attn_full(params["shared_attn"], x, cfg, pcfg,
                                     positions=positions, mesh=mesh, collect_cache=True)
        entries.append(entry)
        for _, lp in units:
            x, (conv, state) = _ssm_layer_full(lp, x, cfg, pcfg, collect_cache=True)
            convs.append(conv)
            states.append(state)
    for _, lp in tail:
        x, (conv, state) = _ssm_layer_full(lp, x, cfg, pcfg, collect_cache=True)
        convs.append(conv)
        states.append(state)

    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    k = torch.stack([e[0] for e in entries])
    v = torch.stack([e[1] for e in entries])
    kv = dataclasses.replace(
        _entry_to_cache((k, v), cfg, pcfg, stack=False, extra=extra_capacity), pos=pos
    )
    cache = HybridCache(attn=kv, ssm=_ssm_cache(convs, states, pos, cfg))
    return _logits(params, x[:, -1:], cfg), cache


def hybrid_lm_decode(params, cache: HybridCache, token, cfg, pcfg, mesh=None):
    x = common.embed(params["embed"], token)
    pos = cache.pos
    sp = params["shared_attn"]
    grouped, tail = _ssm_units(params, cfg)
    kv = cache.attn
    for g, units in enumerate(grouped):
        h = common.rms_norm(x, sp["ln_attn"], cfg.norm_eps)
        slices = tuple(None if a is None else a[g] for a in (kv.k, kv.v, kv.k_scale, kv.v_scale))
        a, _ = attn.attention_decode(
            sp["attn"], h, *slices, pos, cfg, pcfg, sliding_window=None, mesh=mesh,
        )
        x = x + a
        h = common.rms_norm(x, sp["ln_mlp"], cfg.norm_eps)
        x = x + mlp.mlp(sp["mlp"], h, cfg.act)
        for layer, lp in units:
            x = _ssm_layer_decode(lp, x, cache.ssm, layer, cfg, pcfg)
    for layer, lp in tail:
        x = _ssm_layer_decode(lp, x, cache.ssm, layer, cfg, pcfg)
    new_pos = pos + 1
    cache = HybridCache(attn=dataclasses.replace(cache.attn, pos=new_pos),
                        ssm=dataclasses.replace(cache.ssm, pos=new_pos))
    return _logits(params, x, cfg), cache
