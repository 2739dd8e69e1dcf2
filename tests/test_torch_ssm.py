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
