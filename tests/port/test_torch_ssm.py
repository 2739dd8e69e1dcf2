"""The port's SSD scan on CPU tensors against the reference: the jnp oracles
(``ssd_chunked``, ``ssd_sequential``, ``ssd_decode_step``) and the Pallas
kernel in interpret mode, y and the final state; the recompute backward of
the card's ``autograd.Function`` against ``jax.vjp`` through the reference;
the kernel wrapper's contract.  Inputs are numpy arrays from a seed, handed
to both frameworks.

Tolerance 5e-5, as in ``tests/test_kernels.py``: both sides compute the
same fp32 products and exponentials in different summation orders.  dt
is drawn about 0.1, as Mamba-2 initialises it (its range is [0.001, 0.1]).
With the softplus(N(0, 1)) draws of ``tests/test_kernels.py`` the inclusive
cumsum of dt·A reaches |cum| ≈ 480 in a chunk; there one fp32 ulp (3e-5) is
a relative error of exp(cum_i - cum_j), and the two frameworks take the
cumsum in different orders, so those draws would test rounding, not the
port."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan import ref as jref
from repro_torch.core import errors
from repro_torch.kernels.ssd_scan import kernel as tkernel
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref

torch.set_num_threads(1)

TOL = 5e-5


def _inputs(seed, B, S, H, P, N, groups=1):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, S, H, P), dtype=np.float32),
        0.1 * np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32),
        -np.exp(rng.standard_normal((H,))).astype(np.float32),
        rng.standard_normal((B, S, groups, N), dtype=np.float32),
        rng.standard_normal((B, S, groups, N), dtype=np.float32),
    )


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# the shapes of tests/test_kernels.py, a grouped case and chunks under 128
SHAPES = [
    (1, 256, 4, 32, 16, 1, 128),
    (2, 128, 2, 16, 32, 1, 64),
    (1, 384, 8, 64, 16, 1, 128),   # S not a multiple of 256
    (2, 128, 4, 16, 16, 2, 64),    # grouped B/C: 2 groups of 2 heads
    (1, 96, 2, 16, 16, 1, 48),     # chunk 48, as a 48-token prompt runs
    (2, 24, 2, 8, 8, 1, 24),       # one chunk of 24
]


@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SHAPES)
def test_ssd_chunked_matches_reference(B, S, H, P, N, G, chunk):
    j, t = _both(_inputs(0, B, S, H, P, N, G))
    ty, tstate = tref.ssd_chunked(*t, chunk=chunk)
    jy, jstate = jref.ssd_chunked(*j, chunk=chunk)
    _close(ty, jy)
    _close(tstate, jstate)


@pytest.mark.parametrize("B,S,H,P,N,G,chunk", SHAPES)
def test_ssd_scan_matches_pallas(B, S, H, P, N, G, chunk):
    """``ops.ssd_scan`` on the CPU against the Pallas kernel in interpret
    mode; ``ssd_scan_with_state`` also against the final state."""

    j, t = _both(_inputs(1, B, S, H, P, N, G))
    _close(tops.ssd_scan(*t, chunk=chunk), jops.ssd_scan(*j, chunk=chunk, impl="pallas"))
    y, state = tops.ssd_scan_with_state(*t, chunk=chunk)
    _close(y, jops.ssd_scan(*j, chunk=chunk, impl="pallas"))
    _close(state, jref.ssd_chunked(*j, chunk=chunk)[1])


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_sequential_and_decode_step_match_reference(G):
    j, t = _both(_inputs(2, 2, 32, 4, 8, 4, G))
    ty, tstate = tref.ssd_sequential(*t)
    jy, jstate = jref.ssd_sequential(*j)
    _close(ty, jy)
    _close(tstate, jstate)
    # the chunked form equals the recurrence
    _close(tref.ssd_chunked(*t, chunk=8)[0], jy, 1e-4)
    # decode steps carry a state the reference decode gives too
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = j, t
    js = jnp.asarray(np.asarray(jstate))
    ts = tstate.clone()
    for step in range(3):
        jy1, js = jref.ssd_decode_step(js, jx[:, step], jdt[:, step], jA, jB[:, step], jC[:, step])
        ty1, ts = tref.ssd_decode_step(ts, tx[:, step], tdt[:, step], tA, tB[:, step], tC[:, step])
        _close(ty1, jy1)
        _close(ts, js)


def test_ssd_chunked_refuses_a_ragged_chunk():
    _, t = _both(_inputs(3, 1, 100, 2, 8, 4))
    with pytest.raises(errors.Error) as ei:
        tref.ssd_chunked(*t, chunk=64)
    assert ei.value.klass == errors.ErrorClass.ERR_DIMS


@pytest.mark.parametrize("with_state", [False, True])
def test_function_backward_matches_reference_vjp(with_state):
    """The backward of the card's ``autograd.Function`` (recompute through
    ``ref.ssd_chunked``) against ``jax.vjp`` through the reference — called
    directly, since its forward launches the kernel."""

    B, S, H, P, N, G, chunk = 1, 64, 4, 8, 8, 2, 32
    arrs = _inputs(4, B, S, H, P, N, G)
    rng = np.random.default_rng(5)
    g_y = rng.standard_normal((B, S, H, P), dtype=np.float32)
    g_state = rng.standard_normal((B, H, P, N), dtype=np.float32)
    j, t = _both(arrs)
    ctx = types.SimpleNamespace(saved_tensors=tuple(t), chunk=chunk)
    grads = tops._SSDScan.backward(
        ctx, torch.from_numpy(g_y), torch.from_numpy(g_state) if with_state else None
    )
    assert grads[5:] == (None, None)
    if with_state:
        _, vjp = jax.vjp(lambda *a: jref.ssd_chunked(*a, chunk=chunk), *j)
        j_grads = vjp((jnp.asarray(g_y), jnp.asarray(g_state)))
    else:
        _, vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=chunk), *j)
        j_grads = vjp(jnp.asarray(g_y))
    for tg, jg in zip(grads[:5], j_grads):
        _close(tg, jg, 2e-4)


def test_cpu_path_grads_match_reference():
    """On the CPU ``ssd_scan`` differentiates through the chunked form; its
    grads equal the reference's ``custom_vjp``."""

    arrs = _inputs(6, 1, 32, 2, 8, 4)
    j, _ = _both(arrs)
    t = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tops.ssd_scan(*t, chunk=16).sum().backward()
    j_grads = jax.grad(lambda *a: jops.ssd_scan(*a, chunk=16).sum(), argnums=(0, 1, 2, 3, 4))(*j)
    for tg, jg in zip(t, j_grads):
        _close(tg.grad, jg, 2e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; it raises before any
    build on anything else."""

    _, t = _both(_inputs(7, 1, 16, 2, 8, 4))
    with pytest.raises(errors.Error) as ei:
        tkernel.ssd_scan_fwd(*t, chunk=16)
    assert ei.value.klass == errors.ErrorClass.ERR_ARG
    assert tkernel.LAUNCHES == 0


# ---------------------------------------------------------------------------
# The arithmetic of the tensor-core body.  On the card, bf16 inputs run the
# kernel's bf16 body: 64-row tiles in order from a zero state, the state split
# into p tiles of 16 columns (each recomputes C B^T and the cumsum), the four
# products on wgmma with fp32 sums.  y rounds two fp32 operands to bf16 once
# each: M = (C B^T) exp(seg) dt_j and the carried state H_in for C H_in^T.
# Every decay factor is non-negative, so y moves by at most 2^-8 times the
# plain version run on |x|, |B| and |C|; chip_smoke.py adds that term to a
# bf16 y's limit.  The state keeps the fp32 limits: X w enters its update as
# two bf16 terms, hi = bf16(X w) and lo = bf16(X w - hi).  Here that
# arithmetic, emulated in plain torch, is held within the same limits.
# ---------------------------------------------------------------------------

BF16_RTOL = TERM = 2.0 ** -8  # chip_smoke.py's bf16 rtol term and derived factor
TC_TILE, TC_P_TILE = 64, 16


def _bf16(t):
    return t.bfloat16().float()


def _tensor_core_emulation(x, dt, A, B, C, *, split_xw=True):
    """(y rounded to bf16, fp32 final state) as the bf16 body computes them:
    the state as two accumulators that decay alike, one summing B^T hi(X w),
    the other B^T lo(X w), added where the state is read; with ``split_xw``
    False, X w enters one accumulator rounded to bf16 once."""

    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = -l % TC_TILE  # zero rows with dt 0: the state and cum stand still
    x, B, C = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bh, Ch = (t.repeat_interleave(h // g, dim=2) for t in (B, C))
    below = torch.tril(torch.ones((TC_TILE, TC_TILE), dtype=torch.bool))
    y = torch.zeros((b, l + pad, h, p))
    state = torch.zeros((b, h, p, n))
    for c0 in range(0, p, TC_P_TILE):
        xs = x[..., c0:c0 + TC_P_TILE]
        Hs = [torch.zeros((b, h, xs.shape[-1], n)) for _ in range(2 if split_xw else 1)]
        for t0 in range(0, l + pad, TC_TILE):
            rows = slice(t0, t0 + TC_TILE)
            cum = torch.cumsum(dt[:, rows] * A, dim=1).transpose(1, 2)  # (b, h, q)
            total = cum[..., -1]
            cb = torch.einsum("bihn,bjhn->bhij", Ch[:, rows], Bh[:, rows])
            seg = torch.where(below, cum[..., :, None] - cum[..., None, :], float("-inf"))
            M = _bf16(cb * torch.exp(seg) * dt[:, rows].transpose(1, 2)[..., None, :])
            y_in = torch.einsum("bihn,bhpn->bhip", Ch[:, rows], _bf16(sum(Hs)))
            y_t = torch.exp(cum)[..., None] * y_in + torch.einsum("bhij,bjhp->bhip", M, xs[:, rows])
            y[:, rows, :, c0:c0 + TC_P_TILE] = y_t.transpose(1, 2)
            w = torch.exp(total[..., None] - cum) * dt[:, rows].transpose(1, 2)  # (b, h, q)
            xw = xs[:, rows] * w.transpose(1, 2)[..., None]
            parts = (_bf16(xw), _bf16(xw - _bf16(xw))) if split_xw else (_bf16(xw),)
            Hs = [torch.exp(total)[..., None, None] * H
                  + torch.einsum("bjhp,bjhn->bhpn", part, Bh[:, rows])
                  for H, part in zip(Hs, parts)]
        state[:, :, c0:c0 + TC_P_TILE] = sum(Hs)
    return _bf16(y[:, :l]), state


_TC_CASES = {
    # (B, S, H, P, N, G, chunk): grouped B/C on the n 128 template
    "grouped": (2, 256, 4, 32, 128, 2, 64),
    # a ragged last tile (200 rows in 64-row tiles), a last p tile of 8
    # columns, n 96 zero-padded to 128
    "ragged_tail": (1, 200, 3, 40, 96, 1, 40),
    # zamba2's state size, on the n 64 template
    "zamba2_n64": (1, 256, 4, 64, 64, 1, 64),
}


def _tc_case(case, **kw):
    """(|y - plain|, y's old limit, y's limit with the term, |state - plain|,
    the state's limit) on bf16-valued x, B and C."""

    B_, S, H, P, N, G, chunk = _TC_CASES[case]
    x, dt, A, B, C = (torch.from_numpy(a) for a in _inputs(40 + sorted(_TC_CASES).index(case),
                                                            B_, S, H, P, N, G))
    x, B, C = _bf16(x), _bf16(B), _bf16(C)
    y, state = _tensor_core_emulation(x, dt, A, B, C, **kw)
    py, pstate = tref.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    abs_y = tref.ssd_chunked(x.abs(), dt, A, B.abs(), C.abs(), chunk=chunk)[0]
    old = TOL + (TOL + BF16_RTOL) * py.abs()
    return ((y - py).abs(), old, old + TERM * abs_y, (state - pstate).abs(),
            TOL + TOL * pstate.abs())


@pytest.mark.parametrize("case", sorted(_TC_CASES))
def test_tensor_core_arithmetic_within_the_derived_limit(case):
    dy, _, y_limit, dstate, state_limit = _tc_case(case)
    assert bool((dy <= y_limit).all()), (dy / y_limit).max().item()
    assert bool((dstate <= state_limit).all()), (dstate / state_limit).max().item()


def test_tensor_core_arithmetic_breaks_the_old_y_limit():
    """Without the 2^-8 plain(|x|, |B|, |C|) term y's limit does not hold:
    the term is needed, not slack."""

    assert any(bool((dy > old).any()) for dy, old, *_ in map(_tc_case, sorted(_TC_CASES)))


def test_one_bf16_pass_of_xw_breaks_the_state_limit():
    """Rounding X w to bf16 once, in place of the hi + lo split, would move
    the state past its fp32 limits: the split is needed."""

    assert any(bool((ds > lim).any())
               for *_, ds, lim in (_tc_case(c, split_xw=False) for c in sorted(_TC_CASES)))
