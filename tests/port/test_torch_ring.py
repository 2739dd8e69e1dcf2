"""The port's ring attention on CPU tensors against the reference: the
plain ring step against the JAX twin and the Pallas kernel in interpret
mode, the skip invariants, the ring of one against the reference's
degenerate ring, and the fused ring on 4 gloo ranks (one process each)
against the reference's ring under ``shard_map`` on 4 virtual devices — the
two sides run at once.  Inputs are numpy arrays from a seed.

Tolerances: 1e-5 for one step (as ``tests/test_ring_attention.py``), 2e-5
for the ring of one (fp32 attention) and 5e-5 across the 4-rank schedule
(the reference's own ring parity limit): both sides keep an exact fp32
softmax state and sum in different orders."""

from __future__ import annotations

import ctypes
import re
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import _compat
from repro.core import topology as jtopo
from repro.kernels.flash_attention import ops as jfa
from repro.kernels.ring_attention import kernel as jrk
from repro.kernels.ring_attention import ops as jring
from repro_torch.core import errors, topology
from repro_torch.core.communicator import world
from repro_torch.kernels.ring_attention import kernel as trk
from repro_torch.kernels.ring_attention import ops as tring
from repro_torch.kernels.ring_attention import ref as tref
from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)

WORLD = 4


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _step_inputs(seed, Hk, B=1, S=64, H=4, D=16):
    """Head-major q/k/v and a mid-schedule carry: m finite, l and acc
    nonzero."""

    q, k, v, m, acc = _arrays(seed, (B, H, S, D), (B, Hk, S, D), (B, Hk, S, D), (B, H, S, 1),
                              (B, H, S, D))
    l = np.random.default_rng(seed + 1).uniform(1.0, 2.0, (B, H, S, 1)).astype(np.float32)
    return q, k, v, 0.5 * m, l, acc


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hk", [4, 2])
def test_ring_step_matches_reference_twin_and_pallas(causal, Hk):
    arrs = _step_inputs(0, Hk)
    kw = dict(q_offset=64, k_offset=32, kv_len=50, scale=0.25, causal=causal)
    jx = [jnp.asarray(a) for a in arrs]
    want_ref = jrk.ring_step_ref(*jx, **kw)
    want_pallas = jrk.ring_step_fwd(*jx, block_q=32, block_k=32, interpret=True,
                                    **{k: (jnp.int32(v) if k.endswith(("offset", "len")) else v)
                                       for k, v in kw.items()})
    got = trk.ring_step_fwd(*(torch.from_numpy(a) for a in arrs), **kw)
    for g, r, p in zip(got, want_ref, want_pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-5, rtol=1e-5)
    assert trk.LAUNCHES == 0  # CPU tensors take the plain twin


@pytest.mark.parametrize("case", ["future", "empty"])
def test_ring_step_skip_invariants(case):
    """A KV shard wholly in the causal future, or with no valid row, leaves
    a mid-schedule carry exactly as it was, on the plain path as in the
    Pallas kernel (which skips such tiles)."""

    arrs = _step_inputs(1, 2)
    kw = {"future": dict(q_offset=0, k_offset=512, kv_len=64, causal=True),
          "empty": dict(q_offset=0, k_offset=0, kv_len=0, causal=False)}[case]
    got = trk.ring_step_fwd(*(torch.from_numpy(a) for a in arrs), scale=0.25, **kw)
    for g, a in zip(got, arrs[3:]):
        np.testing.assert_array_equal(g.numpy(), a)
    pallas = jrk.ring_step_fwd(*(jnp.asarray(a) for a in arrs), block_q=32, block_k=32,
                               scale=0.25, interpret=True,
                               **{k: (jnp.int32(v) if k != "causal" else v)
                                  for k, v in kw.items()})
    for p, a in zip(pallas, arrs[3:]):
        np.testing.assert_array_equal(np.asarray(p), a)


def test_ring_step_plain_twin_matches_in_q_chunks():
    """Rows are independent: the plain twin over Q chunks, each with
    ``q_offset`` moved by the chunk's start, equals one call (how the card's
    check holds the kernel at full width)."""

    q, k, v, m, l, acc = (torch.from_numpy(a) for a in _step_inputs(2, 2, S=96))
    kw = dict(k_offset=40, kv_len=90, scale=0.25, causal=True)
    whole = tref.ring_step_ref(q, k, v, m, l, acc, q_offset=60, **kw)
    for c0 in (0, 32, 64):
        rows = slice(c0, c0 + 32)
        part = tref.ring_step_ref(q[:, :, rows], k, v, m[:, :, rows], l[:, :, rows],
                                  acc[:, :, rows], q_offset=60 + c0, **kw)
        for p, w in zip(part, whole):
            torch.testing.assert_close(p, w[:, :, rows], rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_of_one_matches_reference(causal):
    q, k, v = _arrays(5, (2, 48, 4, 16), (2, 48, 2, 16), (2, 48, 2, 16))
    mesh = _compat.make_mesh((1,), ("ring",))
    jcart = jtopo.CartComm(mesh, ("ring",), dims=(1,), periods=(True,), managed=False,
                           tag="r1")
    with mesh:
        want = jring.ring_attention(jcart, *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                    impl="pallas", block_q=32, block_k=32)
    cart = topology.cart_create(world(device_type="cpu"), (1,), (True,), tag="ring-of-one")
    got = tring.ring_attention(cart, *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                               block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    flash = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(flash), atol=2e-5, rtol=2e-5)


def test_non_periodic_ring_raises_topology_error():
    cart = topology.cart_create(world(device_type="cpu"), (1,), (False,), tag="line-of-one")
    x = torch.zeros((1, 8, 2, 4))
    with pytest.raises(errors.Error) as ei:
        tring.ring_attention(cart, x, x, x)
    assert ei.value.klass == errors.ErrorClass.ERR_TOPOLOGY


def test_bad_global_len_raises_count_error():
    cart = topology.cart_create(world(device_type="cpu"), (1,), (True,), tag="ring-of-one")
    x = torch.zeros((1, 8, 2, 4))
    for kw in (dict(global_len=9), dict(global_len=0)):
        with pytest.raises(errors.Error) as ei:
            tring.ring_attention(cart, x, x, x, **kw)
        assert ei.value.klass == errors.ErrorClass.ERR_COUNT
    with pytest.raises(errors.Error) as ei:
        tring.ring_attention(cart, x, x[:, :4], x[:, :4])
    assert ei.value.klass == errors.ErrorClass.ERR_COUNT


def test_ring_kernel_argtypes_match_the_c_signature():
    """The ctypes declaration covers every parameter of the C entry point,
    so no pointer or stride is cut to 32 bits."""

    want = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}
    src = trk.LIBRARY.source.read_text()
    sig = re.search(r'extern "C" int ring_step_fwd\((.*?)\)\s*\{', src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(trk.ARGTYPES)
    for decl, ctype in zip(params, trk.ARGTYPES):
        base = decl.rsplit(" ", 1)[0].replace("const ", "").strip()
        assert ctype is (ctypes.c_void_p if base.endswith("*") else want[base]), decl


# ---------------------------------------------------------------------------
# 4 ranks against the reference under shard_map
# ---------------------------------------------------------------------------

_CASES = [(128, True), (128, False), (101, True), (101, False)]

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
    for name in sorted({k.split(":")[0] for k in inp}):
        q, k, v = (jnp.asarray(inp[name + ":" + t]) for t in "qkv")
        S, causal = int(inp[name + ":S"]), bool(inp[name + ":causal"])
        for impl in ("ref", "pallas"):
            def body(ql, kl, vl):
                return ring_ops.ring_attention(cart, ql, kl, vl, causal=causal, global_len=S,
                                               impl=impl, block_q=16, block_k=16)
            with mesh:
                out[name + ":" + impl] = np.asarray(jax.jit(_compat.shard_map(
                    body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))(q, k, v))
    np.savez(work + "/jax.npz", **out)
    print("JAX_RING_OK")
""")


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    work = tmp_path_factory.mktemp("ring")
    inputs = {}
    for i, (s, causal) in enumerate(_CASES):
        pad = (-s) % WORLD
        q, k, v = _arrays(s + i, (2, s, 4, 16), (2, s, 2, 16), (2, s, 2, 16))
        widths = ((0, 0), (0, pad), (0, 0), (0, 0))
        for t, a in zip("qkv", (q, k, v)):
            inputs[f"case{i}:{t}"] = np.pad(a, widths)
        inputs[f"case{i}:S"], inputs[f"case{i}:causal"] = np.array(s), np.array(causal)
    np.savez(work / "inputs.npz", **inputs)
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("ring", WORLD, work)
    finish_jax(jax_proc, "JAX_RING_OK")
    return inputs, ranks, dict(np.load(work / "jax.npz"))


@pytest.mark.parametrize("i", range(len(_CASES)), ids=[f"S{s}-{'causal' if c else 'full'}"
                                                      for s, c in _CASES])
def test_four_rank_ring_matches_reference_shard_map(rings, i):
    inputs, ranks, ref = rings
    s = _CASES[i][0]
    got = np.concatenate([r[f"case{i}:fused"] for r in ranks], axis=1)
    for impl in ("ref", "pallas"):
        want = ref[f"case{i}:{impl}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :s], want[:, :s], atol=5e-5, rtol=5e-5)
    q, k, v = (jnp.asarray(inputs[f"case{i}:{t}"][:, :s]) for t in "qkv")
    flash = jfa.flash_attention(q, k, v, causal=_CASES[i][1], impl="ref")
    np.testing.assert_allclose(got[:, :s], np.asarray(flash), atol=5e-5, rtol=5e-5)
    if f"case{i}:plain" in ranks[0]:
        plain = np.concatenate([r[f"case{i}:plain"] for r in ranks], axis=1)
        np.testing.assert_allclose(plain, got, atol=5e-5, rtol=5e-5)


# ---------------------------------------------------------------------------
# The limit of one bf16 pass of P.  On the card, bf16 inputs run the flash
# kernel's tensor-core body: key tiles folded into an fp32 online softmax,
# l summed from the fp32 P, P rounded to bf16 once for the P V product.  An
# output then moves by at most 2^-8 (sum_k p_k |v_k|) / l, the plain twin run
# on |v| (unnormalised for a carry: this step's p |v| alone).  chip_smoke.py
# adds that term to its limit; here the arithmetic, emulated in plain torch,
# is held within the same limit.
# ---------------------------------------------------------------------------

P_BF16 = 2.0 ** -8
RING_ATOL, BF16_RTOL, CARRY_RTOL = 1e-4, 2.0 ** -8, 1e-5  # chip_smoke.py's limits


def _step_one_bf16_pass(q, k, v, m, l, acc, *, q_offset, k_offset, kv_len, scale, causal,
                        block_k=128):
    """The tensor-core body's arithmetic for one step: ``ring_step_ref``'s,
    folded over key tiles of ``block_k``, with P rounded to bf16 for P V."""

    h, hk = q.shape[1], k.shape[1]
    k, v = (t.repeat_interleave(h // hk, dim=1) for t in (k, v))
    q_pos = q_offset + torch.arange(q.shape[2])[:, None]
    for k0 in range(0, k.shape[2], block_k):
        keys = slice(k0, k0 + block_k)
        k_local = torch.arange(k.shape[2])[None, keys]
        mask = k_local < kv_len
        if causal:
            mask = mask & (q_pos >= k_offset + k_local)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, keys]) * scale
        s = torch.where(mask, s, tref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v[:, :, keys])
        m = m_new
    return m, l, acc


def _bf16_values(*arrs):
    return [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrs]


def _schedule(causal, n=4, shard=48, global_len=181, B=1, H=4, Hk=2, D=32):
    """A ring of n emulated in one process, each rank's n steps chained, in
    the one-bf16-pass arithmetic, beside the twin on v and on |v|:
    (|emulated - plain|, old limit, limit with the term) over the valid
    rows."""

    q, k, v = _bf16_values(*_arrays(60 + causal, (B, H, n * shard, D),
                                    (B, Hk, n * shard, D), (B, Hk, n * shard, D)))
    lens = [max(0, min(shard, global_len - r * shard)) for r in range(n)]
    outs = {"got": [], "plain": [], "abs_v": []}
    for r in range(n):
        qr = q[:, :, r * shard:(r + 1) * shard]
        fresh = (torch.full((B, H, shard, 1), tref.NEG_INF), torch.zeros((B, H, shard, 1)),
                 torch.zeros((B, H, shard, D)))
        carries = dict.fromkeys(outs, fresh)
        for step in range(n):
            src = (r - step) % n
            kv = dict(q_offset=r * shard, k_offset=src * shard, kv_len=lens[src], scale=0.5,
                      causal=causal)
            ks, vs = (t[:, :, src * shard:(src + 1) * shard] for t in (k, v))
            carries = {"got": _step_one_bf16_pass(qr, ks, vs, *carries["got"], block_k=32,
                                                  **kv),
                       "plain": tref.ring_step_ref(qr, ks, vs, *carries["plain"], **kv),
                       "abs_v": tref.ring_step_ref(qr, ks, vs.abs(), *carries["abs_v"], **kv)}
        for name, (_, l, acc) in carries.items():
            outs[name].append(acc / l.clamp_min(1e-30))
    got, plain, abs_v = (torch.cat(outs[name], dim=2)[:, :, :global_len] for name in outs)
    old = RING_ATOL + BF16_RTOL * plain.abs()
    return (got - plain).abs(), old, old + P_BF16 * abs_v


def _mid_schedule_carry():
    """One step from a finite mid-schedule carry: the acc part."""

    q, k, v, m, l, acc = (torch.from_numpy(a) for a in _step_inputs(62, 2, S=96, D=32))
    q, k, v = (t.bfloat16().float() for t in (q, k, v))
    kw = dict(q_offset=96, k_offset=40, kv_len=90, scale=0.5, causal=True)
    got = _step_one_bf16_pass(q, k, v, m, l, acc, block_k=32, **kw)[2]
    plain = tref.ring_step_ref(q, k, v, m, l, acc, **kw)[2]
    abs_v = tref.ring_step_ref(q, k, v.abs(), m, l, torch.zeros_like(acc), **kw)[2]
    old = RING_ATOL + CARRY_RTOL * plain.abs()
    return (got - plain).abs(), old, old + P_BF16 * abs_v


_P_CASES = {"schedule_4_causal": lambda: _schedule(True),
            "schedule_4_full": lambda: _schedule(False),
            "mid_schedule_carry": _mid_schedule_carry}


@pytest.mark.parametrize("case", sorted(_P_CASES))
def test_one_bf16_pass_of_p_within_the_derived_limit(case):
    diff, _, limit = _P_CASES[case]()
    assert bool((diff <= limit).all()), (diff / limit).max().item()


def test_one_bf16_pass_of_p_breaks_the_old_limit():
    """Without the 2^-8 twin(|v|) term the limit does not hold: the term is
    needed, not slack."""

    assert any(bool((diff > old).any()) for diff, old, _ in (f() for f in _P_CASES.values()))
