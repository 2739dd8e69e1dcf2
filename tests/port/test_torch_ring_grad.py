"""The ring's gradient and the differentiable cart shift against the
reference.

The port's ``ring_attention`` is a ``torch.autograd.Function`` whose
backward recomputes the ring through the plain step, each rotation a
differentiable shift (``topology.shift_differentiable``).  Its ``dq, dk,
dv`` are held within 2e-4 (the reference's own gradient parity limit,
``tests/test_ring_attention.py``) of ``jax.vjp`` through the reference's
ring (its ``custom_vjp``, the Pallas step in interpret mode) and of the
dense plain attention's, on one rank and on 4 gloo ranks (one process
each) beside 4 virtual JAX devices under ``shard_map``.  The cases: the
reference's gradient case (S 96, causal) and a ragged global length of 101
(padded to 4 shards of 26), causal and not.  A random cotangent stands in
for the reference's ``sum``; it is zero on the padded rows the caller
slices off.

One rank hides a missing gradient (an exchange with oneself is a clone,
which autograd differentiates); 4 ranks cannot.  The shift's gradient is
the reverse shift: on a periodic ring each rank gets its receiver's
cotangent, on a line the last rank gets zeros (its destination is
``PROC_NULL``).
"""

from __future__ import annotations

import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import _compat
from repro.core import topology as jtopo
from repro.kernels.flash_attention import ops as jfa
from repro.kernels.ring_attention import ops as jring
from repro_torch.core import topology
from repro_torch.core.communicator import world
from repro_torch.kernels.ring_attention import ops as tring

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import finish_jax, run_ranks, start_jax  # noqa: E402

torch.set_num_threads(1)

WORLD = 4
TOL = 2e-4
#: (name, S, causal, q shape (b, S, h, d), kv heads)
CASES = [("s96", 96, True, (1, 96, 2, 16), 2),
         ("s101causal", 101, True, (1, 101, 4, 16), 2),
         ("s101full", 101, False, (1, 101, 4, 16), 2)]


def _case(i: int, pad_to: int):
    """q, k, v and the cotangent of a case, padded to a multiple of
    ``pad_to`` (the cotangent is zero on the padded rows)."""

    _, s, _, (b, _, h, d), hk = CASES[i]
    rng = np.random.default_rng(7 + i)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, hk, d), dtype=np.float32) for _ in range(2))
    g = rng.standard_normal((b, s, h, d), dtype=np.float32)
    pad = ((0, 0), (0, (-s) % pad_to), (0, 0), (0, 0))
    return tuple(np.pad(a, pad) for a in (q, k, v, g))


def _dense_grads(i: int, q, k, v, g):
    s, causal = CASES[i][1], CASES[i][2]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal, impl="ref"),
                     *(jnp.asarray(x[:, :s]) for x in (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g[:, :s]))]


def _close(got, want, s):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:, :s], b[:, :s], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_ring_of_one_gradient_matches_reference(i):
    name, s, causal = CASES[i][:3]
    q, k, v, g = _case(i, 1)
    mesh = _compat.make_mesh((1,), ("ring",))
    jcart = jtopo.CartComm(mesh, ("ring",), dims=(1,), periods=(True,), managed=False,
                           tag="r1")
    with mesh:
        _, vjp = jax.vjp(lambda a, b, c: jring.ring_attention(
            jcart, a, b, c, causal=causal, global_len=s, impl="pallas", block_q=16,
            block_k=16), *(jnp.asarray(x) for x in (q, k, v)))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    cart = topology.cart_create(world(device_type="cpu"), (1,), (True,), tag="ring-of-one")
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tring.ring_attention(cart, qt, kt, vt, causal=causal, global_len=s, block_q=16,
                               block_k=16)
    got = [d.numpy() for d in torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))]
    _close(got, want, s)
    _close(got, _dense_grads(i, q, k, v, g), s)


JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core import _compat, topology
    from repro.kernels.ring_attention import ops as ring_ops

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    N = 4
    mesh = _compat.make_mesh((N,), ("ring",))
    cart = topology.CartComm(mesh, ("ring",), dims=(N,), periods=(True,), managed=False,
                             tag="ring-test")
    spec = P(None, "ring", None, None)
    out = {}
    for name in sorted({k.split(":")[0] for k in inp if ":" in k}):
        q, k, v, g = (jnp.asarray(inp[name + ":" + t]) for t in "qkvg")
        S, causal = int(inp[name + ":S"]), bool(inp[name + ":causal"])

        def body(ql, kl, vl):
            return ring_ops.ring_attention(cart, ql, kl, vl, causal=causal, global_len=S,
                                           impl="pallas", block_q=16, block_k=16)

        ring = _compat.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
        with mesh:
            _, vjp = jax.vjp(jax.jit(ring), q, k, v)
            for t, d in zip("qkv", vjp(g)):
                out[name + ":d" + t] = np.asarray(d)
    np.savez(work + "/jax.npz", **out)
    print("JAX_RING_GRAD_OK")
""")


@pytest.fixture(scope="module")
def ring_grads(tmp_path_factory):
    work = tmp_path_factory.mktemp("ring_grad")
    inputs = {}
    for i, (name, s, causal, _, _) in enumerate(CASES):
        for t, a in zip("qkvg", _case(i, WORLD)):
            inputs[f"{name}:{t}"] = a
        inputs[f"{name}:S"], inputs[f"{name}:causal"] = np.array(s), np.array(causal)
    rng = np.random.default_rng(5)
    inputs["shift_x"] = rng.standard_normal((WORLD, 3, 5), dtype=np.float32)
    inputs["shift_w"] = rng.standard_normal((WORLD, 3, 5), dtype=np.float32)
    np.savez(work / "inputs.npz", **inputs)
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("ring_grad", WORLD, work)
    finish_jax(jax_proc, "JAX_RING_GRAD_OK")
    return inputs, ranks, dict(np.load(work / "jax.npz"))


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_four_rank_ring_gradient_matches_reference(ring_grads, i):
    inputs, ranks, ref = ring_grads
    name, s = CASES[i][:2]
    got = [np.concatenate([r[f"{name}:d{t}"] for r in ranks], axis=1) for t in "qkv"]
    _close(got, [ref[f"{name}:d{t}"] for t in "qkv"], s)
    _close(got, _dense_grads(i, *(inputs[f"{name}:{t}"] for t in "qkvg")), s)


def test_shift_gradient_is_the_reverse_shift(ring_grads):
    inputs, ranks, _ = ring_grads
    x, w = inputs["shift_x"], inputs["shift_w"]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["shift_ring:y"], x[(r - 1) % WORLD])
        np.testing.assert_array_equal(got["shift_ring:dx"], w[(r + 1) % WORLD])
        np.testing.assert_array_equal(got["shift_line:y"],
                                      x[r - 1] if r > 0 else np.zeros_like(x[0]))
        np.testing.assert_array_equal(got["shift_line:dx"],
                                      w[r + 1] if r < WORLD - 1 else np.zeros_like(w[0]))


def test_shift_of_one_rank_gradient():
    for periodic in (True, False):
        cart = topology.cart_create(world(device_type="cpu"), (1,), (periodic,),
                                    tag=f"shift-of-one-{periodic}")
        x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
        y = topology.shift_differentiable(cart, x, 0, 1)
        (dx,) = torch.autograd.grad((y * 3.0).sum(), x)
        want = 3.0 if periodic else 0.0
        torch.testing.assert_close(y.detach(), x.detach() if periodic else torch.zeros_like(x))
        torch.testing.assert_close(dx, torch.full_like(x, want))
