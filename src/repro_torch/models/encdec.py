"""Encoder-decoder transformer (seamless-m4t backbone), the port of
:mod:`repro.models.encdec`.  The speech frontend is a stub, as in the
reference: ``batch["frames"]`` holds precomputed frame embeddings
(B, S_enc, D); the model is the transformer backbone with a bidirectional
encoder (the flash kernel with ``causal=False``), a causal decoder and a
plain fp32 cross-attention.

The parameter tree is the reference's: ``encoder`` and ``decoder`` stack
every leaf along a leading layer dimension, as its ``jax.vmap`` init does.
The decode step updates the decoder's self-attention cache in place and
reads the cross-attention K/V the prefill made; its position is a device
tensor, so the step is capturable as a CUDA graph.  As in the reference,
the cache is always in the model's dtype: ``kv_cache_dtype="int8"`` does
not reach it (ROADMAP C11)."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, transformer
from repro_torch.models.attention import KVCache
from repro_torch.sharding import local as _local


def _init_enc_layer(gen, cfg, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    """``stack`` prepends the layer dimension to every leaf."""

    def norm():
        return torch.zeros(stack + (cfg.d_model,), dtype=dtype, device=gen.device)

    return {
        "ln_attn": norm(),
        "attn": attn.init_attention(gen, cfg, dtype, stack=stack),
        "ln_mlp": norm(),
        "mlp": mlp.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, stack=stack),
    }


def _init_dec_layer(gen, cfg, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    p = _init_enc_layer(gen, cfg, dtype, stack=stack)
    p["ln_cross"] = torch.zeros(stack + (cfg.d_model,), dtype=dtype, device=gen.device)
    p["cross"] = attn.init_attention(gen, cfg, dtype, stack=stack)
    return p


def init_encdec(gen: torch.Generator, cfg) -> common.Params:
    """Random parameters on ``gen.device``, drawn from ``gen``."""

    dtype = common.dtype_of(cfg)
    return {
        "embed": common.trunc_normal(gen, (cfg.padded_vocab, cfg.d_model), 1.0, dtype),
        "enc_norm": common.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "final_norm": common.init_rmsnorm(cfg.d_model, dtype, gen.device),
        "encoder": _init_enc_layer(gen, cfg, dtype, stack=(cfg.encoder_layers,)),
        "decoder": _init_dec_layer(gen, cfg, dtype, stack=(cfg.num_layers,)),
    }


def _maybe_remat(fn, pcfg):
    """Any ``pcfg.remat`` but ``"none"`` is a full checkpoint of the layer:
    the reference's encoder-decoder has no ``"dots"`` policy."""

    if pcfg.remat == "none":
        return fn
    return transformer._maybe_remat(fn, dataclasses.replace(pcfg, remat="full"))


def _self_attention(p, h, cfg, pcfg, positions, *, causal):
    q = attn._proj(h, p["wq"])
    k = attn._proj(h, p["wk"])
    v = attn._proj(h, p["wv"])
    q = common.rope(q, positions, theta=cfg.rope_theta)
    k = common.rope(k, positions, theta=cfg.rope_theta)
    # on placed heads the kernel runs on this rank's shards (``local_map``):
    # the custom op has no sharding rule of its own (ROADMAP C25)
    out = attn._flash(q, k, v, pcfg, causal=causal, scale=1.0 / math.sqrt(cfg.head_dim))
    return attn._out(out, p["wo"])


def _cross_attention(p, h, enc_k, enc_v, cfg):
    """Decoder → encoder attention against precomputed encoder K/V, a plain
    fp32 softmax as in the reference."""

    q = attn._proj(h, p["wq"])

    def attend(q, enc_k, enc_v):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), enc_k.float())
        s = s / math.sqrt(cfg.head_dim)
        pr = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", pr, enc_v.float()).to(h.dtype)

    # on placed heads, on this rank's rows and heads: the einsums flatten
    # (b, h), and DTensor cannot flatten a split head dim on every torch
    # (ROADMAP C26)
    out = (_local.attention_heads(attend, q, enc_k, enc_v) if _local.is_dtensor(q)
           else attend(q, enc_k, enc_v))
    return attn._out(out, p["wo"])


def encode(params, frames: torch.Tensor, cfg, pcfg, mesh=None) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings → encoder states."""

    x = frames.to(common.dtype_of(cfg))
    positions = torch.arange(x.shape[1], device=x.device)

    def unit(x, lp):
        h = common.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        x = x + _self_attention(lp["attn"], h, cfg, pcfg, positions, causal=False)
        h = common.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        return x + mlp.mlp(lp["mlp"], h, cfg.act)

    unit = _maybe_remat(unit, pcfg)
    for lp in transformer._units(params["encoder"]):
        x = unit(x, lp)
    return common.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _decoder_full(params, enc_out, tokens, cfg, pcfg, *, collect_cache, mesh=None):
    """The teacher-forced decoder → (x, ys): with ``collect_cache``, ys is
    ((k, v), (cross_k, cross_v)), each stacked over the layers."""

    x = common.embed(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def unit(x, lp):
        # encoder K/V for this layer (recomputed per layer from enc_out)
        ek = attn._proj(enc_out, lp["cross"]["wk"])
        ev = attn._proj(enc_out, lp["cross"]["wv"])
        h = common.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        if collect_cache:
            a, entry = attn.attention_prefill(
                lp["attn"], h, cfg, pcfg, positions=positions, sliding_window=None, mesh=mesh
            )
        else:
            a = attn.attention_full(
                lp["attn"], h, cfg, pcfg, positions=positions, sliding_window=None, mesh=mesh
            )
            entry = None
        x = x + a
        h = common.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + _cross_attention(lp["cross"], h, ek, ev, cfg)
        h = common.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + mlp.mlp(lp["mlp"], h, cfg.act)
        return x, ((entry, (ek, ev)) if collect_cache else ())

    unit = _maybe_remat(unit, pcfg)
    ys = []
    for lp in transformer._units(params["decoder"]):
        x, y = unit(x, lp)
        ys.append(y)
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return x, ()
    k = torch.stack([y[0][0] for y in ys])
    v = torch.stack([y[0][1] for y in ys])
    ck = torch.stack([y[1][0] for y in ys])
    cv = torch.stack([y[1][1] for y in ys])
    return x, ((k, v), (ck, cv))


def encdec_loss(params, batch, cfg, pcfg, mesh=None):
    enc_out = encode(params, batch["frames"], cfg, pcfg, mesh)
    tokens = batch["tokens"]
    x, _ = _decoder_full(params, enc_out, tokens, cfg, pcfg, collect_cache=False, mesh=mesh)
    logits = torch.matmul(x, params["embed"].t())
    loss = common.cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss, {"loss": loss}


@dataclasses.dataclass
class EncDecCache:
    self_kv: KVCache             # decoder self-attention (L, B, S_dec, Hk, Dh)
    cross_k: torch.Tensor        # (L, B, S_enc, Hk, Dh)
    cross_v: torch.Tensor

    @property
    def pos(self):
        return self.self_kv.pos


def encdec_prefill(params, batch, cfg, pcfg, mesh=None, extra_capacity: int = 0):
    """Encode + teacher-forced decoder prefill over the target prefix.
    Returns (last-token logits, :class:`EncDecCache`)."""

    enc_out = encode(params, batch["frames"], cfg, pcfg, mesh)
    tokens = batch["tokens"]
    x, ((k, v), (ck, cv)) = _decoder_full(
        params, enc_out, tokens, cfg, pcfg, collect_cache=True, mesh=mesh
    )
    k, v = transformer._pad_seq(k, extra_capacity), transformer._pad_seq(v, extra_capacity)
    dtype = common.dtype_of(cfg)
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32, device=x.device)
    cache = EncDecCache(
        self_kv=KVCache(k=k.to(dtype), v=v.to(dtype), k_scale=None, v_scale=None, pos=pos),
        cross_k=ck.to(dtype),
        cross_v=cv.to(dtype),
    )
    logits = torch.matmul(x[:, -1:], params["embed"].t())
    return logits, cache


def encdec_decode(params, cache: EncDecCache, token, cfg, pcfg, mesh=None):
    """One decode step.  token: (B, 1) int32.  Returns (logits, cache): the
    self-attention cache is updated in place, ``pos`` advances, and the
    cross-attention K/V are handed on as they are."""

    x = common.embed(params["embed"], token)
    kv = cache.self_kv
    pos = kv.pos
    for i, lp in enumerate(transformer._units(params["decoder"])):
        h = common.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        a, _ = attn.attention_decode(
            lp["attn"], h, kv.k[i], kv.v[i], None, None, pos, cfg, pcfg,
            sliding_window=None, mesh=mesh,
        )
        x = x + a
        h = common.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + _cross_attention(lp["cross"], h, cache.cross_k[i], cache.cross_v[i], cfg)
        h = common.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + mlp.mlp(lp["mlp"], h, cfg.act)
    cache = EncDecCache(
        self_kv=dataclasses.replace(kv, pos=pos + 1),
        cross_k=cache.cross_k,
        cross_v=cache.cross_v,
    )
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(x, params["embed"].t())
    return logits, cache
