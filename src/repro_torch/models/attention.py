"""Attention: GQA/MQA (+ RoPE, sliding window, softcap), MLA (deepseek-v2)
and the KV caches (bf16 or int8, linear or ring-buffer; MLA's compressed
latent cache), the serving path of :mod:`repro.models.attention`.  The
int8 cache quantizes and dequantizes through
:mod:`repro_torch.kernels.quant` (the CUDA kernels on the card).  With
``pcfg.ring_attention`` and a communicator (the reference's ``mesh``
argument), layers with no softcap, window or prefix shard the sequence
over the ring kernel (:mod:`repro_torch.kernels.ring_attention`).  MLA's
full-sequence attention runs the flash kernel with values narrower than
the keys; its absorbed decode is plain fp32, as the reference's.  Decode
takes the shared scalar position of the fixed-batch ``Server`` or a per-row
``(B,)`` vector (the continuous-batching engine's slot table).

On DTensor parameters (:mod:`repro_torch.sharding`) the projections run
through DTensor's sharding propagation and every kernel call sees this
rank's shard through ``local_map`` (:mod:`repro_torch.sharding.local`):
flash over the local batch rows and heads, the int8 quantize and
dequantize over whole rows.  With ``seq_shard_cache`` and
``flash_decode_merge`` and a communicator, decode attends over this rank's
slice of a sequence-sharded cache and merges the partial softmaxes
(:func:`_flash_decode_sharded`).  The ring on placed projections
(:func:`_ring_attention_placed`) moves them from heads to this rank's
sequence block over ``model`` for the kernel and back."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import collectives, datatypes, errors, overlap, topology
from repro_torch.core.descriptors import CollectiveSpec
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.kernels.ring_attention import ops as ring_ops
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.sharding import local as _local


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Per-model stacked KV cache.  ``k``/``v``: (L, B, S, Hk, Dh) in
    ``dtype`` (int8 with per-(token, head) fp32 ``*_scale`` (L, B, S, Hk, 1)
    when quantised, else ``None``).  ``pos``: () int32 tensor, the global
    position count; sliding-window layers use S == window with ring
    addressing."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None
    pos: torch.Tensor

    @staticmethod
    def init(
        num_layers: int,
        batch: int,
        length: int,
        kv_heads: int,
        head_dim: int,
        *,
        dtype=torch.bfloat16,
        quantized: bool = False,
        device=None,
    ) -> "KVCache":
        shape = (num_layers, batch, length, kv_heads, head_dim)
        pos = torch.zeros((), dtype=torch.int32, device=device)
        if quantized:
            return KVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
                v_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
                pos=pos,
            )
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            k_scale=None,
            v_scale=None,
            pos=pos,
        )


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x (..., Dh) → (int8, fp32 scale
    (..., 1)), one quantize call over all rows."""

    if _local.is_dtensor(x):
        return _local.rowwise(_quantize_kv, x, n_out=2)
    q, s = quant_ops.quantize_int8_rows(x.reshape(-1, x.shape[-1]))
    return q.reshape(x.shape), s.reshape(x.shape[:-1] + (1,))


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    if _local.is_dtensor(q):
        return _local.rowwise(lambda ql, sl: _dequantize_kv(ql, sl, dtype), q, scale, n_out=1)
    x = quant_ops.dequantize_int8_rows(q.reshape(-1, q.shape[-1]), scale.reshape(-1, 1), dtype)
    return x.reshape(q.shape)


def _row_update(layer: torch.Tensor, new: torch.Tensor, write_pos: torch.Tensor) -> None:
    """Per-row cache write in place: ``layer`` (B, S, ...), ``new`` (B, T,
    ...), ``write_pos`` () or (B,): row b writes its T tokens at its own
    position, clamped into [0, S - T] as ``jax.lax.dynamic_update_slice``
    clamps its start.  The engine never resets an idle slot's position, so
    an empty or retired row's position grows past S; its write lands at the
    end of its row, where the reference's does, instead of indexing out of
    bounds (a device-side assert inside a CUDA graph).  One scatter over all
    rows, with the positions on the device: no host sync, so it can be
    captured."""

    if _local.is_dtensor(layer):
        _row_update_sharded(layer, new, write_pos)
        return
    _row_write(layer, new, write_pos, layer.shape[1], 0)


def _row_write(layer, new, write_pos, s: int, off: int) -> None:
    """:func:`_row_update` on a (local) layer that holds slots ``[off, off
    + layer.shape[1])`` of a sequence of ``s``: a slot another rank holds
    is written with its own value (one token a row, so no two writes of a
    row meet)."""

    t = new.shape[1]
    start = torch.clamp(write_pos.long().expand(layer.shape[0]), 0, s - t)
    cols = start[:, None] + torch.arange(t, device=layer.device)
    rows = torch.arange(layer.shape[0], device=layer.device)[:, None].expand_as(cols)
    new = new.to(layer.dtype)
    if off or layer.shape[1] != s:
        cols = cols - off
        held = (cols >= 0) & (cols < layer.shape[1])
        cols = torch.clamp(cols, 0, layer.shape[1] - 1)
        held = held.reshape(held.shape + (1,) * (new.dim() - 2))
        new = torch.where(held, new, layer[rows, cols])
    layer.index_put_((rows, cols), new)


def _row_update_sharded(layer, new, write_pos) -> None:
    """:func:`_row_update` of a DTensor cache layer, in place in each
    rank's shard: batch rows and heads as the layer holds them, the
    sequence (``seq_shard_cache``) by each rank's slot offset."""

    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = layer.device_mesh, tuple(layer.placements)
    s = layer.shape[1]
    off, _ = _local.shard_range(pl, mesh, 1, s)
    errors.check(
        new.shape[1] == 1 or not any(p.is_shard(1) for p in pl),
        errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
        f"a sequence-sharded cache takes one token a row, got {new.shape[1]}",
    )
    # a plain position is the server's shared scalar, every rank's whole
    # one; the engine's per-row vector comes as a replicated DTensor
    # (``engine._positions``), split here as the layer's rows are
    errors.check(
        _local.is_dtensor(write_pos) or write_pos.dim() == 0,
        errors.ErrorClass.ERR_DIMS,
        f"a placed cache takes per-row positions as a DTensor, got {tuple(write_pos.shape)}",
    )
    new_pl = [Replicate() if p.is_shard(1) else p for p in pl]
    pos_pl = [Shard(0) if p.is_shard(0) and write_pos.dim() == 1 else Replicate() for p in pl]

    def body(ll, nl, wp):
        _row_write(ll, nl, wp, s, off)
        return ll

    _local.local_map(
        body, out_placements=list(pl),
        in_placements=(pl, new_pl, pos_pl if _local.is_dtensor(write_pos) else None),
        device_mesh=mesh, redistribute_inputs=True,
    )(layer, new, write_pos)


def cache_layer_update(k_layer, v_layer, k_scale_l, v_scale_l, k_new, v_new, pos, *, ring: bool):
    """Write k_new/v_new (B, T, Hk, Dh) at ``pos`` (ring: pos % capacity),
    quantized with their scales into an int8 cache (one quantize call over
    all rows).  ``pos`` is a shared scalar or a per-row ``(B,)`` vector
    (:func:`_row_update`, clamped as the reference's).  The write is in
    place: it stands in for the reference's donated cache buffers, so
    decode allocates no new cache."""

    capacity = k_layer.shape[1]
    write_pos = (pos % capacity) if ring else pos
    if k_layer.dtype == torch.int8:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        writes = ((k_layer, kq), (v_layer, vq), (k_scale_l, ks), (v_scale_l, vs))
    else:
        writes = ((k_layer, k_new), (v_layer, v_new))
    for layer, new in writes:
        _row_update(layer, new, write_pos)
    return k_layer, v_layer, k_scale_l, v_scale_l


def cache_layer_read(k_layer, v_layer, k_scale_l, v_scale_l, dtype):
    if k_layer.dtype == torch.int8:
        return (_dequantize_kv(k_layer, k_scale_l, dtype),
                _dequantize_kv(v_layer, v_scale_l, dtype))
    return k_layer.to(dtype), v_layer.to(dtype)


# ---------------------------------------------------------------------------
# GQA parameters
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    """``stack`` prepends leading dims (the scanned unit stack)."""

    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, stack + (d, h, dh), dtype, stacked=bool(stack)),
        "wk": dense_init(gen, d, stack + (d, hk, dh), dtype, stacked=bool(stack)),
        "wv": dense_init(gen, d, stack + (d, hk, dh), dtype, stacked=bool(stack)),
        "wo": dense_init(gen, h * dh, stack + (h, dh, d), dtype, stacked=bool(stack)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(stack + (h, dh), dtype=dtype, device=gen.device)
        p["bk"] = torch.zeros(stack + (hk, dh), dtype=dtype, device=gen.device)
        p["bv"] = torch.zeros(stack + (hk, dh), dtype=dtype, device=gen.device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""

    d, h, k = w.shape
    return common.split_dim(torch.matmul(x, w.reshape(d, h * k)), -1, (h, k))


def _out(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""

    h, k, d = w.shape
    return torch.matmul(y.flatten(-2), w.reshape(h * k, d))


def _project_qkv(p, x, cfg, positions):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = common.rope(q, positions, theta=cfg.rope_theta)
    k = common.rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _scale(cfg) -> float:
    return cfg.query_scale if cfg.query_scale is not None else 1.0 / math.sqrt(cfg.head_dim)


def _flash(q, k, v, pcfg, **kw):
    """The flash call of a layer: on DTensors, the kernel over this rank's
    batch rows and heads (``local_map``).  The ``sp`` plan's query-block
    constraint is the reference's chunked form's (``impl="chunked"``): on
    the CPU that form runs on the DTensors themselves, with the constraint
    as a redistribution."""

    impl = getattr(pcfg, "attn_impl", "ref")
    sp = pcfg.model_axis if pcfg.attn_plan == "sp" else None
    if not _local.is_dtensor(q):
        return fa_ops.flash_attention(q, k, v, impl=impl, **kw)
    if sp is not None and impl == "chunked" and not q.is_cuda:
        return fa_ops.flash_attention(q, k, v, impl=impl, q_block_axis=sp, **kw)
    return _local.attention_heads(
        lambda ql, kl, vl: fa_ops.flash_attention(ql, kl, vl, impl=impl, **kw), q, k, v)


def _attend(q, k, v, cfg, pcfg, sliding_window, prefix_len, mesh):
    if pcfg.ring_attention and mesh is not None and not cfg.attn_logit_softcap and \
            sliding_window is None and prefix_len is None:
        ring = _ring_attention_placed if _local.is_dtensor(q) else _ring_attention_sharded
        return ring(q, k, v, pcfg, mesh, scale=_scale(cfg))
    return _flash(
        q,
        k,
        v,
        pcfg,
        causal=True,
        sliding_window=sliding_window,
        prefix_len=prefix_len,
        logit_softcap=cfg.attn_logit_softcap,
        scale=_scale(cfg),
    )


# ---------------------------------------------------------------------------
# full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------


def attention_full(
    p: common.Params,
    x: torch.Tensor,         # (B, S, D)
    cfg,
    pcfg,
    *,
    positions: torch.Tensor,  # (S,) or (B, S)
    sliding_window: int | None,
    prefix_len: int | None = None,
    mesh=None,
) -> torch.Tensor:
    q, k, v = _project_qkv(p, x, cfg, positions)
    return _out(_attend(q, k, v, cfg, pcfg, sliding_window, prefix_len, mesh), p["wo"])


class _Blocks(torch.autograd.Function):
    """This rank's ``(rows, seq)`` block of tensors every rank of ``comm``
    holds whole; the backward scatters each block's cotangent into zeros
    and sums over ``comm`` (the blocks tile the whole), so every rank ends
    with the whole tensors' gradients, as the sharded step's transpose
    gives them."""

    @staticmethod
    def forward(ctx, comm, rows, seq, *xs):
        ctx.comm, ctx.rows, ctx.seq = comm, rows, seq
        ctx.shapes = [x.shape for x in xs]
        return tuple(x[rows, seq].contiguous() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        whole = []
        for g, shape in zip(gs, ctx.shapes):
            z = g.new_zeros(shape)
            z[ctx.rows, ctx.seq] = g
            whole.append(z)
        if ctx.comm.size() > 1:
            whole = datatypes.apply_packed(ctx.comm.allreduce, tuple(whole))
        return (None, None, None, *whole)


class _Gathered(torch.autograd.Function):
    """The output blocks all-gathered over the ring (sequence, dim 1), then
    over each data axis (rows, dim 0); the backward takes this rank's block
    of the cotangent, which is the same on every rank."""

    @staticmethod
    def forward(ctx, out, cart, lines, rows, seq):
        ctx.rows, ctx.seq = rows, seq
        if cart.size() > 1:
            out = collectives.allgather(cart, out, spec=CollectiveSpec(axis=1))
        for line in lines:
            out = collectives.allgather(line, out, spec=CollectiveSpec(axis=0))
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows, ctx.seq].contiguous(), None, None, None, None


def _ring_attention_sharded(q, k, v, pcfg, comm, *, scale, causal=True):
    """Sequence parallelism for training and long prefill: this rank takes
    its batch rows by its coordinate on the data axes of ``comm`` (those of
    ``pcfg.data_axes`` it has) and its sequence shard by its
    ``pcfg.model_axis`` coordinate (the reference's ``P(data_axes, axis)``
    spec), runs the fused ring (``kernels/ring_attention``) on a periodic
    cart over the model axis, and all-gathers the output over both.  Global
    lengths that do not divide the ring are padded here (the kernel masks
    the tail) and sliced back.  Differentiable: every rank of ``comm`` ends
    with the whole ``q, k, v``'s gradients (``_Blocks``, ``_Gathered``).

    The server and the trainer hand it their whole communicator and a
    replicated batch (the trainer's whole state only on a world of one)."""

    axis = pcfg.model_axis
    n = comm.axis_size(axis)
    cart = topology.CartComm(comm, (axis,), dims=(n,), periods=(True,), tag="ring-attn")
    s = q.shape[1]
    pad = (-s) % n
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    shard = (s + pad) // n
    coords = dict(zip(comm.axis_names, comm.coords()))
    data_axes = tuple(a for a in pcfg.data_axes if a in comm.axis_names)
    data = math.prod(comm.axis_size(a) for a in data_axes)
    b = q.shape[0]
    errors.check(
        b % data == 0,
        errors.ErrorClass.ERR_COUNT,
        f"ring attention splits the batch over {data_axes}: {b} rows over {data} ranks",
    )
    row = 0
    for a in data_axes:
        row = row * comm.axis_size(a) + coords[a]
    rows = slice(row * (b // data), (row + 1) * (b // data))
    seq = slice(coords[axis] * shard, (coords[axis] + 1) * shard)
    ql, kl, vl = _Blocks.apply(comm, rows, seq, q, k, v)
    out = ring_ops.ring_attention(cart, ql, kl, vl, causal=causal, scale=scale, global_len=s)
    lines = [comm.split(a) for a in reversed(data_axes) if comm.axis_size(a) > 1]
    out = _Gathered.apply(out, cart, lines, rows, seq)
    return out[:, :s] if pad else out


def _ring_attention_placed(q, k, v, pcfg, comm, *, scale, causal=True):
    """:func:`_ring_attention_sharded` on DTensor projections (placed
    weights): ``q, k, v`` (B, S, H, D) come sharded by heads over the model
    axis (``tp_heads``) and by rows over the data axes.  They are
    redistributed to this rank's sequence block of every head (an
    all-to-all over ``model``), the ring kernel runs on the local blocks
    (rows as the data axes split them) over the cart's model line, and the
    output goes back to the query's placement, the one the following
    ``wo`` projection expects.  A global length that does not divide the
    ring is padded first (the kernel masks the tail).  Differentiable
    through the redistributions and the ring's own backward."""

    from torch.distributed.tensor import Replicate, Shard

    axis = pcfg.model_axis
    n = comm.axis_size(axis)
    cart = topology.CartComm(comm, (axis,), dims=(n,), periods=(True,), tag="ring-attn")
    dm = q.device_mesh
    names = dm.mesh_dim_names
    errors.check(
        axis in names and dm.size(names.index(axis)) == n,
        errors.ErrorClass.ERR_TOPOLOGY,
        f"placed ring attention needs the {axis!r} axis of {n} ranks in the tensors' mesh "
        f"{dict(zip(names, dm.mesh.shape))}",
    )
    s = q.shape[1]
    pad = (-s) % n
    if pad:
        q, k, v = (_pad_sequence(t, pad) for t in (q, k, v))
    blocks = tuple(
        Shard(1) if name == axis else
        (Shard(0) if p.is_shard(0) and q.shape[0] % dm.size(i) == 0 else Replicate())
        for i, (name, p) in enumerate(zip(names, q.placements)))

    def body(ql, kl, vl):
        return ring_ops.ring_attention(cart, ql, kl, vl, causal=causal, scale=scale,
                                       global_len=s)

    out = _local.local_map(body, out_placements=list(blocks), in_placements=(blocks,) * 3,
                           device_mesh=dm, redistribute_inputs=True)(q, k, v)
    # the query's placement, a pending sum (DTensor's choice on an axis of
    # one rank) taken as done
    back = [Replicate() if p.is_partial() else p for p in q.placements]
    out = out.redistribute(dm, back)
    return out[:, :s] if pad else out


def _pad_sequence(t, pad: int):
    """A DTensor (B, S, ...) whose sequence is not split, padded by ``pad``
    zero positions at its end, in each rank's shard."""

    errors.check(
        not any(p.is_shard(1) for p in t.placements),
        errors.ErrorClass.ERR_DIMS,
        f"a ring over a split sequence ({tuple(t.placements)}) cannot be padded",
    )
    pl = list(t.placements)
    return _local.local_map(lambda x: F.pad(x, (0, 0, 0, 0, 0, pad)), out_placements=pl,
                            in_placements=(pl,), device_mesh=t.device_mesh)(t)


def attention_prefill(
    p, x, cfg, pcfg, *, positions, sliding_window, prefix_len=None, mesh=None
):
    """Full-sequence attention that also returns the layer's new KV entries
    (B, S_cache, Hk, Dh) — S_cache is min(S, window) for windowed layers.
    The entries are ``k`` and ``v`` as the projections place them (on
    placed weights the batch rows over data and the heads over model,
    ``cache_specs``'s layout: ROADMAP C27 found them so), never the ring's
    sequence blocks, so decode is the same with or without the ring."""

    q, k, v = _project_qkv(p, x, cfg, positions)
    y = _out(_attend(q, k, v, cfg, pcfg, sliding_window, prefix_len, mesh), p["wo"])
    if sliding_window is not None and k.shape[1] > sliding_window:
        # ring-buffer layout: global position p lives in slot p % window
        s = k.shape[1]
        start = s - sliding_window
        roll = s % sliding_window
        return y, (_roll_seq(k[:, start:], roll), _roll_seq(v[:, start:], roll))
    return y, (k, v)


def _roll_seq(t: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(t, shift, dims=1)`` as the concatenation of its two
    slices, which DTensor carries on any placement (it has no rule for
    ``aten.roll`` on every torch: ROADMAP C26)."""

    cut = t.shape[1] - shift
    return torch.cat([t[:, cut:], t[:, :cut]], dim=1)


def attention_decode(
    p,
    x1: torch.Tensor,         # (B, 1, D)
    k_layer,
    v_layer,
    k_scale_l,
    v_scale_l,
    pos: torch.Tensor,        # () int32 tokens already cached, or (B,) per row
    cfg,
    pcfg,
    *,
    sliding_window: int | None,
    mesh=None,
):
    """Single-token attention against a cached layer (updated in place).
    Returns (y (B,1,D), cache slices).  The fixed-batch path's scalar
    ``pos`` (every row at one depth) is taken as the ``(B,)`` vector that
    gives each row its own depth and validity mask (B, capacity)."""

    dtype = x1.dtype
    pos = pos.expand(x1.shape[0])
    q, k_new, v_new = _project_qkv(p, x1, cfg, pos[:, None])
    ring = sliding_window is not None and k_layer.shape[1] == sliding_window
    k_layer, v_layer, k_scale_l, v_scale_l = cache_layer_update(
        k_layer, v_layer, k_scale_l, v_scale_l, k_new, v_new, pos, ring=ring
    )
    capacity = k_layer.shape[1]
    slots = torch.arange(capacity, device=k_layer.device)
    pos_b = pos[:, None]   # against the slots: a (B, capacity) mask
    if ring:
        # slot i holds global position p_i = pos - ((pos - i) mod capacity)
        slot_pos = pos_b - torch.remainder(pos_b - slots, capacity)
        valid = slot_pos >= torch.clamp(pos_b - capacity + 1, min=0)
        valid = valid & (slot_pos <= pos_b)
    else:
        slot_pos = slots
        valid = slot_pos <= pos_b
    if sliding_window is not None:
        valid = valid & (pos_b - slot_pos < sliding_window)
    if pcfg.seq_shard_cache and pcfg.flash_decode_merge and mesh is not None and not ring \
            and _local.is_dtensor(k_layer):
        y = _flash_decode_sharded(q, k_layer, v_layer, k_scale_l, v_scale_l, valid, cfg,
                                  pcfg, mesh, dtype)
    else:
        kc, vc = cache_layer_read(k_layer, v_layer, k_scale_l, v_scale_l, dtype)
        if _local.is_dtensor(q):
            # on this rank's rows and heads: the scores' einsum flattens
            # (b, h), and DTensor cannot flatten a split head dim on every
            # torch (ROADMAP C26)
            y = _local.attention_heads(
                lambda ql, kl, vl, ml: _decode_attend(ql, kl, vl, ml, cfg), q, kc, vc, valid)
        else:
            y = _decode_attend(q, kc, vc, valid, cfg)
    return _out(y, p["wo"]), (k_layer, v_layer, k_scale_l, v_scale_l)


def _decode_scores(q, kc, valid, cfg):
    """fp32 masked scores (B, H, 1, capacity) of one decode step."""

    kc = fa_ref._repeat_heads(kc, q.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float())
    s = s * _scale(cfg)
    s = common.softcap(s, cfg.attn_logit_softcap)
    return torch.where(valid[:, None, None, :], s, fa_ref.NEG_INF)


def _decode_attend(q, kc, vc, valid, cfg):
    pattn = torch.softmax(_decode_scores(q, kc, valid, cfg), dim=-1)
    vc = fa_ref._repeat_heads(vc, q.shape[2])
    return torch.einsum("bhqk,bkhd->bqhd", pattn, vc.float()).to(q.dtype)


def _flash_decode_sharded(q, k_layer, v_layer, k_scale_l, v_scale_l, valid, cfg, pcfg,
                          comm, dtype):
    """Sequence-sharded KV cache decode: each model-axis shard attends over
    its slice of the cache, then the exact softmax merge
    (:func:`~repro_torch.core.overlap.merge_partial_attention`) combines
    the partial ``(o, m, l)`` (O(B·H) payload instead of all-gathering the
    cache).  The cache layer is a DTensor; batch rows stay on the data
    axes, and q is whole on the model axis."""

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    axis = pcfg.model_axis
    mesh = k_layer.device_mesh
    names = mesh.mesh_dim_names
    b = q.shape[0]
    kv_pl = tuple(Shard(1) if name == axis else
                  (Shard(0) if name in pcfg.data_axes and b % mesh.size(i) == 0
                   else Replicate())
                  for i, name in enumerate(names))
    q_pl = tuple(Replicate() if name == axis else pl for name, pl in zip(names, kv_pl))
    errors.check(
        k_layer.shape[1] % mesh.size(names.index(axis)) == 0,
        errors.ErrorClass.ERR_DIMS,
        f"a cache of {k_layer.shape[1]} slots does not split over {axis!r}",
    )
    merge_comm = comm.split(axis)

    def body(ql, kl, vl, ksl, vsl, validl):
        kc, vc = cache_layer_read(kl, vl, ksl, vsl, dtype)
        s = _decode_scores(ql, kc, validl, cfg)
        # the shard's normalised output as the unsharded decode computes it,
        # and its (max, normaliser) for the merge
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                         fa_ref._repeat_heads(vc, ql.shape[2]).float())
        m = torch.amax(s, dim=-1)
        l_ = torch.sum(torch.exp(s - m[..., None]), dim=-1)
        return overlap.merge_partial_attention(o, m, l_, merge_comm).to(ql.dtype)

    if not _local.is_dtensor(valid):
        valid = distribute_tensor(valid, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    sc_pl = None if k_scale_l is None else kv_pl
    # valid (B, capacity) splits as the cache's (B, S) dims
    return _local.local_map(
        body, out_placements=list(q_pl),
        in_placements=(q_pl, kv_pl, kv_pl, sc_pl, sc_pl, kv_pl),
        device_mesh=mesh, redistribute_inputs=True,
    )(q, k_layer, v_layer, k_scale_l, v_scale_l, valid)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank Q/KV with compressed cache + absorbed decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MLACache:
    """Compressed latent cache: ``ckv`` (L, B, S, kv_lora), ``k_rope``
    (L, B, S, rope_dim), ``pos`` () int32 tensor.  Written in place by
    decode.  Like the reference's, it has no int8 form: an MLA model keeps
    its cache in the model's dtype under ``kv_cache_dtype="int8"`` too."""

    ckv: torch.Tensor
    k_rope: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(num_layers, batch, length, kv_lora, rope_dim, dtype=torch.bfloat16,
             device=None) -> "MLACache":
        return MLACache(
            ckv=torch.zeros((num_layers, batch, length, kv_lora), dtype=dtype, device=device),
            k_rope=torch.zeros((num_layers, batch, length, rope_dim), dtype=dtype, device=device),
            pos=torch.zeros((), dtype=torch.int32, device=device),
        )


def init_mla(gen, cfg, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    """``stack`` prepends leading dims (the scanned unit stack)."""

    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    st = bool(stack)

    def norm(n):
        return torch.zeros(stack + (n,), dtype=dtype, device=gen.device)

    return {
        "wq_a": dense_init(gen, d, stack + (d, cfg.q_lora), dtype, stacked=st),
        "q_norm": norm(cfg.q_lora),
        "wq_b": dense_init(gen, cfg.q_lora, stack + (cfg.q_lora, h, dn + dr), dtype, stacked=st),
        "wkv_a": dense_init(gen, d, stack + (d, cfg.kv_lora + dr), dtype, stacked=st),
        "kv_norm": norm(cfg.kv_lora),
        "wk_b": dense_init(gen, cfg.kv_lora, stack + (cfg.kv_lora, h, dn), dtype, stacked=st),
        "wv_b": dense_init(gen, cfg.kv_lora, stack + (cfg.kv_lora, h, dv), dtype, stacked=st),
        "wo": dense_init(gen, h * dv, stack + (h, dv, d), dtype, stacked=st),
    }


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)


def _mla_latents(p, x, cfg, positions):
    """Shared q/kv latent computation.  Returns (q_nope, q_rope, ckv, k_rope)."""

    cq = common.rms_norm(torch.matmul(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = _proj(cq, p["wq_b"])
    q_nope, q_rope = q[..., : cfg.nope_head_dim], q[..., cfg.nope_head_dim:]
    q_rope = common.rope(q_rope, positions, theta=cfg.rope_theta)

    kv = torch.matmul(x, p["wkv_a"])
    ckv, k_rope = kv[..., : cfg.kv_lora], kv[..., cfg.kv_lora:]
    ckv = common.rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = common.rope(k_rope[:, :, None, :], positions, theta=cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def mla_attention_full(p, x, cfg, pcfg, *, positions, mesh=None, return_cache=False):
    """Training/prefill MLA: expand the latents and run causal attention
    over keys of width nope + rope and values of width v (the flash kernel
    takes the narrower values as they are)."""

    q_nope, q_rope, ckv, k_rope = _mla_latents(p, x, cfg, positions)
    k_nope = _proj(ckv, p["wk_b"])
    v = _proj(ckv, p["wv_b"])
    h = cfg.num_heads
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], h, cfg.rope_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1)
    out = _flash(q_full, k_full, v, pcfg, causal=True, scale=_mla_scale(cfg))
    y = _out(out, p["wo"])
    if return_cache:
        return y, (ckv, k_rope)
    return y


def mla_attention_decode(p, x1, ckv_layer, krope_layer, pos, cfg, pcfg, *, mesh=None):
    """Absorbed decode: attend in the compressed latent space (the W^UK
    absorption: no per-step expansion), in fp32.  The new latents are
    written into the cached layer in place, at each row's own position of a
    ``(B,)`` ``pos`` (a scalar is every row's)."""

    pos = pos.expand(x1.shape[0])
    q_nope, q_rope, ckv_new, krope_new = _mla_latents(p, x1, cfg, pos[:, None])
    _row_update(ckv_layer, ckv_new, pos)
    _row_update(krope_layer, krope_new, pos)
    capacity = ckv_layer.shape[1]
    valid = torch.arange(capacity, device=ckv_layer.device) <= pos[:, None]

    # absorb: q_latent = q_nope @ W^UK  → (B, 1, H, kv_lora)
    q_latent = torch.einsum("bshn,khn->bshk", q_nope, p["wk_b"])
    ckv_f = ckv_layer.float()
    s = torch.einsum("bshk,btk->bhst", q_latent.float(), ckv_f)
    s = s + torch.einsum("bshr,btr->bhst", q_rope.float(), krope_layer.float())
    s = s * _mla_scale(cfg)
    s = torch.where(valid[:, None, None, :], s, fa_ref.NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o_latent = torch.einsum("bhst,btk->bshk", pattn, ckv_f)
    out = torch.einsum("bshk,khv->bshv", o_latent.to(x1.dtype), p["wv_b"])
    return _out(out, p["wo"]), (ckv_layer, krope_layer)
