"""Mamba-2 block (SSD): projections, causal depthwise conv, the SSD scan
(the CUDA kernel on the card, the chunked form on the CPU), gated RMS norm,
plus the O(1)-state decode step and its cache — :mod:`repro.models.ssm`.

On DTensor parameters the scan's inputs are pinned with their heads over
the model axis (batch over the data axes) and the kernel runs on this
rank's heads through ``local_map`` (:func:`repro_torch.sharding.local.
ssd_heads`)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.sharding import local as _local


@dataclasses.dataclass
class SSMCache:
    """Per-model stacked SSM cache: ``conv`` (L, B, K-1, conv_dim) rolling
    conv window, ``state`` (L, B, H, P, N) fp32 SSD state, ``pos`` () int32."""

    conv: torch.Tensor
    state: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(num_layers, batch, cfg, dtype=torch.bfloat16, device=None) -> "SSMCache":
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return SSMCache(
            conv=torch.zeros((num_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                             device=device),
            state=torch.zeros(
                (num_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                dtype=torch.float32, device=device,
            ),
            pos=torch.zeros((), dtype=torch.int32, device=device),
        )


def init_mamba2(gen, cfg, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    """``stack`` prepends leading dims (the stacked layers) to every leaf."""

    d = cfg.d_model
    di = cfg.ssm_d_inner
    g, n, nh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    dev = gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev))
    return {
        # in_proj → [z (di), xBC (conv_dim), dt (nh)]
        "w_in": dense_init(gen, d, stack + (d, 2 * di + 2 * g * n + nh), dtype,
                           stacked=bool(stack)),
        "conv_w": dense_init(gen, cfg.ssm_conv, stack + (cfg.ssm_conv, conv_dim), dtype,
                             stacked=bool(stack)),
        "conv_b": torch.zeros(stack + (conv_dim,), dtype=dtype, device=dev),
        "a_log": a_log.expand(stack + (nh,)).clone(),  # A = -exp(a_log)
        "dt_bias": torch.zeros(stack + (nh,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones(stack + (nh,), dtype=torch.float32, device=dev),
        "out_norm": torch.zeros(stack + (di,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, di, stack + (di, d), dtype, stacked=bool(stack)),
    }


def _split_proj(zxbcdt, cfg):
    di = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn :]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, *, history=None):
    """Depthwise causal conv over the sequence.  ``history``: (B, K-1, C)
    left context (decode); returns (out, new_history)."""

    k = conv_w.shape[0]
    b, s, c = xbc.shape
    if history is None:
        history = torch.zeros((b, k - 1, c), dtype=xbc.dtype, device=xbc.device)
    full = torch.cat([history, xbc], dim=1)                   # (B, K-1+S, C)
    out = torch.zeros((b, s, c), dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + full[:, i : i + s].float() * conv_w[i].float()
    out = F.silu(out + conv_b.float()).to(xbc.dtype)
    # a copy, not a view: a view of the last K-1 rows would keep the whole
    # (B, K-1+S, C) concatenation alive for as long as the cache entry
    new_hist = full[:, -(k - 1):].clone() if k > 1 else history
    return out, new_hist


def _gated_out(p, y, z, xh, cfg, dtype):
    """D skip, gate, norm and out-projection of a block's scan output."""

    y = y + xh.float() * p["d_skip"][:, None]
    y = y.flatten(-2).to(dtype)
    y = common.rms_norm(y * F.silu(z.float()).to(dtype), p["out_norm"], cfg.norm_eps)
    return torch.matmul(y, p["w_out"])


def mamba2_full(p, x, cfg, pcfg, *, conv_history=None, return_cache=False):
    """Full-sequence Mamba-2 block.  x: (B, S, D) → (B, S, D); with
    ``return_cache`` → (out, (conv window, final SSD state)), both from one
    scan (one kernel launch on the card)."""

    di = cfg.ssm_d_inner
    g, n, nh, hp = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, p["w_in"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, new_hist = _causal_conv(xbc, p["conv_w"], p["conv_b"], history=conv_history)
    # x, B and C stay views of the conv output: the kernel reads them by strides
    xh = common.split_dim(xbc[..., :di], -1, (nh, hp))
    B = common.split_dim(xbc[..., di : di + g * n], -1, (g, n))
    C = common.split_dim(xbc[..., di + g * n :], -1, (g, n))
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B, S, nh)
    A = -torch.exp(p["a_log"])

    chunk = min(128, x.shape[1])
    if _local.is_dtensor(xh):
        xh = common.pin(xh, ("data", None, "model", None), pcfg)
        scan = ssd_ops.ssd_scan_with_state if return_cache else ssd_ops.ssd_scan
        out = _local.ssd_heads(lambda *a: scan(*a, chunk=chunk), xh, dt, A, B, C,
                               with_state=return_cache)
        y, final_state = out if return_cache else (out, None)
    elif return_cache:
        y, final_state = ssd_ops.ssd_scan_with_state(xh, dt, A, B, C, chunk=chunk)
    else:
        y = ssd_ops.ssd_scan(xh, dt, A, B, C, chunk=chunk)
    out = _gated_out(p, y, z, xh, cfg, x.dtype)
    if return_cache:
        return out, (new_hist, final_state)
    return out


def mamba2_decode(p, x1, conv_hist, state, cfg, pcfg):
    """Single-token step.  x1 (B, 1, D); conv_hist (B, K-1, C); state
    (B, H, P, N).  Returns (y (B,1,D), (conv_hist, state))."""

    di = cfg.ssm_d_inner
    g, n, nh, hp = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = torch.matmul(x1, p["w_in"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, conv_hist = _causal_conv(xbc, p["conv_w"], p["conv_b"], history=conv_hist)
    xs = xbc[:, 0, :di]
    B = common.split_dim(xbc[:, 0, di : di + g * n], -1, (g, n))
    C = common.split_dim(xbc[:, 0, di + g * n :], -1, (g, n))
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])            # (B, nh)
    A = -torch.exp(p["a_log"])

    xh = common.split_dim(xs, -1, (nh, hp))
    y, state = ssd_ops.ssd_decode_step(state, xh, dt, A, B, C)
    out = _gated_out(p, y.float()[:, None], z, xh[:, None], cfg, x1.dtype)
    return out, (conv_hist, state)
