"""Plain PyTorch version of one ring step: the CPU path, and the oracle
``chip_smoke.py`` holds the CUDA kernel against.  The exact twin of
:func:`repro.kernels.ring_attention.kernel.ring_step_ref`: the same
head-major layout, the finite ``NEG_INF`` mask, no tile skipping, fp32.

Its scores are a (b, h, sq, sk) fp32 tensor; rows are independent, so a
caller that cannot hold them runs it one Q chunk at a time, moving
``q_offset`` by the chunk's start."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def ring_step_ref(q, k, v, m, l, acc, *, q_offset, k_offset, kv_len, scale, causal):
    """Fold ``softmax(q @ k.T) @ v`` of this KV shard into the carry.
    q: (b, h, sq, d); k/v: (b, hk, sk, d); m, l: (b, h, sq, 1) fp32; acc:
    (b, h, sq, d) fp32, unnormalised.  ``q_offset`` / ``k_offset`` are the
    shards' global starts, ``kv_len`` the shard's valid rows (ints or
    0-d tensors).  Returns the new ``(m, l, acc)``."""

    qf = q.float()
    h, hk = q.shape[1], k.shape[1]
    kf = k.float()
    vf = v.float()
    if hk != h:
        rep = h // hk
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    sk = s.shape[-1]
    k_local = torch.arange(sk, device=q.device)[None, :]
    mask = k_local < kv_len
    if causal:
        q_pos = q_offset + torch.arange(s.shape[-2], device=q.device)[:, None]
        k_pos = k_offset + k_local
        mask = mask & (q_pos >= k_pos)
    s = torch.where(mask[None, None], s, NEG_INF)
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return m_new, l_new, acc_new
