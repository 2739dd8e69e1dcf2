"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) scan: the
CPU path, the oracle ``chip_smoke.py`` holds the CUDA kernel against, and
the recompute target of the backward pass.  Numerically the fp32 oracles
of :mod:`repro.kernels.ssd_scan.ref`.

* :func:`ssd_sequential` — the literal recurrence, a loop over time;
* :func:`ssd_chunked` — the chunked matrix form (intra-chunk dense products
  plus the inter-chunk state recurrence), the form the kernel computes.

Conventions (Mamba-2 §6): per head, state ``H`` is ``(p, n)``;
``H_t = exp(dt_t A) H_{t-1} + dt_t x_t ⊗ B_t``; ``y_t = H_t C_t``.
``A < 0`` (decay), ``dt > 0``.
"""

from __future__ import annotations

import torch

from repro_torch.core import errors


def _expand_groups(B: torch.Tensor, h: int) -> torch.Tensor:
    """(b, l, g, n) → (b, l, h, n) by repeating groups over their heads."""

    g = B.shape[2]
    if g == h:
        return B
    return B.repeat_interleave(h // g, dim=2)


def _initial_state(initial_state, b, h, p, n, device) -> torch.Tensor:
    if initial_state is None:
        return torch.zeros((b, h, p, n), dtype=torch.float32, device=device)
    return initial_state.float()


def ssd_sequential(
    x: torch.Tensor,       # (b, l, h, p)
    dt: torch.Tensor,      # (b, l, h)
    A: torch.Tensor,       # (h,)
    B: torch.Tensor,       # (b, l, g, n)
    C: torch.Tensor,       # (b, l, g, n)
    initial_state: torch.Tensor | None = None,  # (b, h, p, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth recurrence.  Returns (y (b,l,h,p), final_state)."""

    b, l, h, p = x.shape
    n = B.shape[-1]
    Bh = _expand_groups(B, h).float()
    Ch = _expand_groups(C, h).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = _initial_state(initial_state, b, h, p, n, x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * Af[None])[:, :, None, None]            # (b,h,1,1)
        outer = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) * Bh[:, t, :, None, :]
        state = decay * state + outer                                       # (b,h,p,n)
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)  # (b, l, h, p)
    return y, state


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (matrix form).  Same signature/returns as sequential."""

    b, l, h, p = x.shape
    errors.check(
        chunk >= 1 and l % chunk == 0,
        errors.ErrorClass.ERR_DIMS,
        f"ssd_chunked: sequence length {l} is not a multiple of chunk {chunk}",
    )
    nc, q = l // chunk, chunk
    n = B.shape[-1]
    Bh = _expand_groups(B, h).float().reshape(b, nc, q, h, n)
    Ch = _expand_groups(C, h).float().reshape(b, nc, q, h, n)
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Af = A.float()

    dA = dtf * Af[None, None, None]                     # (b,nc,q,h)
    cum = torch.cumsum(dA, dim=2)                       # inclusive
    total = cum[:, :, -1]                               # (b,nc,h)

    # intra-chunk: y_i += sum_{j<=i} (C_i·B_j) exp(cum_i-cum_j) dt_j x_j.
    # The EXPONENT is masked (j>i → -inf), not the exp result: cum_i-cum_j
    # is positive above the diagonal and exp() overflows there, which
    # poisons the backward of where() with inf·0 = NaN.
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)     # (b,nc,h,q,q)
    cum_t = cum.transpose(2, 3)                         # (b,nc,h,q)
    seg = cum_t[..., :, None] - cum_t[..., None, :]     # cum_i - cum_j
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(mask, seg, float("-inf")))
    L = L * dtf.transpose(2, 3)[..., None, :]           # × dt_j
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", cb * L, xf)

    # chunk-local state contribution: S_c = sum_j exp(total-cum_j) dt_j x_j ⊗ B_j
    w = torch.exp(total[:, :, None] - cum) * dtf        # (b,nc,q,h)
    S = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", w, xf, Bh)

    # inter-chunk recurrence over c: H_c = exp(total_c) H_{c-1} + S_c; each
    # chunk reads the state at its start
    state = _initial_state(initial_state, b, h, p, n, x.device)
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = torch.exp(total[:, c])[:, :, None, None] * state + S[:, c]
    H_in = torch.stack(h_in, dim=1)                     # (b,nc,h,p,n)

    # inter-chunk output: y_i += exp(cum_i) * (H_in C_i)
    y_inter = torch.exp(cum)[..., None] * torch.einsum("bchpn,bcqhn->bcqhp", H_in, Ch)

    y = (y_intra + y_inter).reshape(b, l, h, p).to(x.dtype)
    return y, state


def ssd_decode_step(
    state: torch.Tensor,   # (b, h, p, n)
    x: torch.Tensor,       # (b, h, p)
    dt: torch.Tensor,      # (b, h)
    A: torch.Tensor,       # (h,)
    B: torch.Tensor,       # (b, g, n)
    C: torch.Tensor,       # (b, g, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step (the serving path).  Returns (y, state)."""

    h = x.shape[1]
    g = B.shape[1]
    if g != h:
        B = B.repeat_interleave(h // g, dim=1)
        C = C.repeat_interleave(h // g, dim=1)
    decay = torch.exp(dt.float() * A[None])[:, :, None, None]
    outer = (dt[..., None, None] * x[..., None]).float() * B[:, :, None, :]
    state = decay * state + outer
    y = torch.einsum("bhpn,bhn->bhp", state, C.float())
    return y.to(x.dtype), state
