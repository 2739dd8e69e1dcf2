"""Plain PyTorch versions of the flash-attention forward kernel: the CPU path,
the oracle ``chip_smoke.py`` holds the CUDA kernel against, and the
recompute target of the backward pass.  Numerically the fp32-softmax oracle
of :mod:`repro.kernels.flash_attention.ref`."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # finite mask value: keeps fully-masked rows NaN-free


def attention_mask(
    q_len: int,
    k_len: int,
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    prefix_len: int | None = None,
    q_offset: int = 0,
    device=None,
) -> torch.Tensor:
    """(q_len, k_len) boolean mask. ``q_offset`` positions queries globally."""

    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(k_len, device=device)[None, :]
    mask = torch.ones((q_len, k_len), dtype=torch.bool, device=device)
    if causal:
        mask = q_pos >= k_pos
    if sliding_window is not None:
        mask = mask & (q_pos - k_pos < sliding_window)
    if prefix_len is not None:
        mask = mask | (k_pos < prefix_len)
    return mask


def _repeat_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    hk = x.shape[2]
    return x if hk == h else x.repeat_interleave(h // hk, dim=2)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    prefix_len: int | None = None,
    logit_softcap: float | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Reference attention.  q: (b, sq, h, d); k: (b, sk, hk, d); v: (b, sk,
    hk, dv) with ``h % hk == 0`` (GQA).  Returns (b, sq, h, dv) in q's
    dtype."""

    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k = _repeat_heads(k, h)
    v = _repeat_heads(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = attention_mask(
        sq,
        k.shape[1],
        causal=causal,
        sliding_window=sliding_window,
        prefix_len=prefix_len,
        q_offset=q_offset,
        device=q.device,
    )
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def chunked_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    prefix_len: int | None = None,
    logit_softcap: float | None = None,
    scale: float | None = None,
    q_block: int = 1024,
    k_block: int = 1024,
    q_block_axis: str | None = None,
) -> torch.Tensor:
    """Memory-efficient (online-softmax) attention: never materialises the
    (S, S) score matrix.  The same blockwise schedule as the kernel, written
    as loops over query blocks and key blocks; ragged shapes fall back to
    :func:`mha`, as in the reference.  Like the reference's, it needs v as
    wide as q and k (ROADMAP C14): with narrower values on whole blocks its
    accumulator does not take the products and it raises."""

    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if sq % q_block or sk % k_block:
        return mha(q, k, v, causal=causal, sliding_window=sliding_window,
                   prefix_len=prefix_len, logit_softcap=logit_softcap, scale=scale)
    kf = _repeat_heads(k, h).float()
    vf = _repeat_heads(v, h).float()
    q_blocks = _q_block_constraint(q.reshape(b, sq // q_block, q_block, h, d).transpose(0, 1)
                                   if q_block_axis is not None else None, q_block_axis)
    outs = []
    for q0 in range(0, sq, q_block):
        qb = (q_blocks[q0 // q_block] if q_blocks is not None else q[:, q0:q0 + q_block]).float()
        o = torch.zeros((b, h, q_block, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, k_block):
            kb, vb = kf[:, k0:k0 + k_block], vf[:, k0:k0 + k_block]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if logit_softcap is not None:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            # global offsets for this (q, k) block pair
            q_pos = q0 + torch.arange(q_block, device=q.device)[:, None]
            k_pos = k0 + torch.arange(k_block, device=q.device)[None, :]
            mask = torch.ones((q_block, k_block), dtype=torch.bool, device=q.device)
            if causal:
                mask = q_pos >= k_pos
            if sliding_window is not None:
                mask = mask & (q_pos - k_pos < sliding_window)
            if prefix_len is not None:
                mask = mask | (k_pos < prefix_len)
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.transpose(1, 2))
    if q_blocks is not None:
        o_blocks = _q_block_constraint(torch.stack(outs), q_block_axis)
        return o_blocks.transpose(0, 1).flatten(1, 2).to(q.dtype)
    return torch.cat(outs, dim=1).to(q.dtype)


def _q_block_constraint(blocks, axis):
    """The reference's ``with_sharding_constraint`` of the stacked query
    blocks (nq, b, q_block, h, d) over mesh axis ``axis``: their dim 0 split
    over it when they are a DTensor on a mesh with that axis and it divides;
    otherwise they are returned as they are (``None`` stays ``None``)."""

    from repro_torch.sharding.local import is_dtensor

    if blocks is None or not is_dtensor(blocks):
        return blocks
    from torch.distributed.tensor import Replicate, Shard

    mesh = blocks.device_mesh
    names = mesh.mesh_dim_names
    if axis not in names or mesh.size(names.index(axis)) <= 1 or \
            blocks.shape[0] % mesh.size(names.index(axis)):
        return blocks
    pl = [Shard(0) if n == axis else Replicate() for n in names]
    return blocks.redistribute(mesh, pl)
