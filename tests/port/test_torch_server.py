"""The port's Server against the reference Server, on CPU tensors: the same
prompts (and image embeddings or frames) through the same weights give
identical tokens at temperature 0 — in one process, and with ring
attention across gloo ranks (one process each) against the reference on
virtual devices.  Also the
persistent-request bookkeeping (the decode request donates the cache; its
CUDA graph path, stood in for on the CPU by ``graph_stub``, gives the eager
tokens), the CLI and the refusal to fall back to the CPU on a machine
without a GPU."""

from __future__ import annotations

import dataclasses
import textwrap

import jax
import numpy as np
import pytest
import torch

import graph_stub
from repro.configs import base as jbase
from repro.core import errors as jerrors
from repro.core import tool as jtool
from repro.launch import serve as jserve
from repro.launch.mesh import make_host_communicator as j_comm
from repro.runtime import server as jserver
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core import errors, tool
from repro_torch.core.futures import PersistentRequest, flatten
from repro_torch.launch import serve
from repro_torch.runtime import server as tserver
from torch_ranks import finish_jax, run_ranks, start_jax

torch.set_num_threads(1)


def _prompts(n=2, length=16, vocab=512, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=(length,), dtype=np.int32) for _ in range(n)]


def _extras(cfg, n=2, seed=11):
    """Per request, the family's stub inputs (none for a text-only model):
    the VLM's image embeddings, the encoder-decoder's 16 frames."""

    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return [{"image_embeds": rng.standard_normal((cfg.num_image_tokens, 1152),
                                                     dtype=np.float32)} for _ in range(n)]
    if cfg.family == "encdec":
        return [{"frames": rng.standard_normal((16, cfg.d_model), dtype=np.float32)}
                for _ in range(n)]
    return [{} for _ in range(n)]


def _requests(module, cfg, prompts, seed=11):
    return [module.Request(tokens=p, extra=e)
            for p, e in zip(prompts, _extras(cfg, len(prompts), seed=seed))]


@pytest.fixture(scope="module")
def servers():
    """The gemma2 smoke model in fp32 on both sides, the reference through
    its Pallas flash kernel (interpret mode), the port with the reference's
    weights."""

    scfg = dict(max_batch=2, max_new_tokens=4, temperature=0.0)
    jcfg = dataclasses.replace(jbase.get_smoke_config("gemma2_9b"), dtype="float32")
    jpcfg = dataclasses.replace(jbase.get_parallel("gemma2_9b"), attn_impl="pallas")
    js = jserver.Server(jcfg, jpcfg, jserver.ServerConfig(**scfg), j_comm())
    tcfg = dataclasses.replace(tbase.get_smoke_config("gemma2_9b"), dtype="float32")
    tpcfg = dataclasses.replace(tbase.get_parallel("gemma2_9b"), attn_impl="pallas")
    ts = tserver.Server(tcfg, tpcfg, tserver.ServerConfig(**scfg), device="cpu")
    ts.params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params), "cpu")
    return js, ts


def test_tokens_identical_to_reference_server(servers):
    """16-token prompts exceed the smoke window of 8: the local layers'
    ring-buffer cache is filled at prefill and wrapped during decode."""

    js, ts = servers
    prompts = _prompts()
    jtok, jstats = js.generate([jserver.Request(tokens=p) for p in prompts])
    ttok, tstats = ts.generate([tserver.Request(tokens=p) for p in prompts])
    np.testing.assert_array_equal(ttok, jtok)
    assert set(tstats) == set(jstats)
    assert tstats["generated_tokens"] == jstats["generated_tokens"] == 8


def test_one_request_per_signature(servers):
    _, ts = servers
    before = tool.pvar_read()
    for seed in (5, 6):
        ts.generate([tserver.Request(tokens=p) for p in _prompts(seed=seed)])
    after = tool.pvar_read()
    # the bucket of 2 x 16 prompts exists already: no new request is built
    assert after["trace:prefill_step"] == before["trace:prefill_step"]
    assert after["trace:decode_step"] == before["trace:decode_step"]
    assert after["persistent_start"] - before["persistent_start"] == 2 * 4
    # a new prompt length is a new bucket: one prefill request, one decode
    ts.generate([tserver.Request(tokens=p) for p in _prompts(length=9)])
    final = tool.pvar_read()
    assert final["trace:prefill_step"] == after["trace:prefill_step"] + 1
    assert final["trace:decode_step"] == after["trace:decode_step"] + 1
    assert len(ts._decode_reqs) == len(ts._prefill_reqs)


def test_decode_request_donates_the_cache(servers):
    """The reference's ``_decode_request`` donates the cache (argument 1);
    the prefill donates nothing and stays an eager request."""

    _, ts = servers
    ts.generate([tserver.Request(tokens=p) for p in _prompts()])
    assert ts._decode_reqs and all(r.donate_argnums == (1,) for r in ts._decode_reqs.values())
    assert all(r.donate_argnums == () for r in ts._prefill_reqs.values())
    assert not any(r.captures for r in ts._prefill_reqs.values())


@pytest.mark.parametrize("arch,kv", [("gemma2_9b", "bfloat16"), ("mamba2_2_7b", "bfloat16"),
                                     ("zamba2_7b", "int8"), ("paligemma_3b", "bfloat16"),
                                     ("seamless_m4t_large_v2", "bfloat16"),
                                     ("grok_1_314b", "int8"),
                                     ("deepseek_v2_236b", "bfloat16")])
def test_graph_decode_gives_the_eager_tokens(monkeypatch, arch, kv):
    """The decode step through the graph path (capture and replay stood in
    for by ``graph_stub``): two generates give an eager server's tokens; the
    first decode step runs eagerly, each generate captures once and releases
    its graph at the end.  The encoder-decoder's graph reads the
    cross-attention K/V of its own generate's prefill."""

    cfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    pcfg = dataclasses.replace(tbase.get_parallel(arch), kv_cache_dtype=kv)
    scfg = tserver.ServerConfig(max_batch=2, max_new_tokens=6)
    batches = [_requests(tserver, cfg, _prompts(length=24, seed=s), seed=s) for s in (8, 9)]
    eager = tserver.Server(cfg, pcfg, scfg, device="cpu")
    want = [eager.generate(b)[0] for b in batches]
    graph_stub.install(monkeypatch)
    ts = tserver.Server(cfg, pcfg, scfg, device="cpu")
    for b, w in zip(batches, want):
        np.testing.assert_array_equal(ts.generate(b)[0], w)
    (req,) = ts._decode_reqs.values()
    assert req.captures and req.captured == 2 and req.starts == 2 * 5
    assert req._graph is None and req._bound == []   # released after each generate


@pytest.mark.parametrize("arch,graph", [("gemma2_9b", False), ("gemma2_9b", True),
                                        ("seamless_m4t_large_v2", False),
                                        ("seamless_m4t_large_v2", True)],
                         ids=["False", "True", "encdec-False", "encdec-True"])
def test_generate_frees_its_cache_at_once(monkeypatch, arch, graph):
    """The prefill's cache is freed when ``generate`` returns, without the
    cyclic garbage collector: a cache kept to the next call's prefill would
    be a second cache beside the new one (and, on the graph path, the
    released graph holds none of it).  Also the encoder-decoder's
    ``EncDecCache``, the cross-attention K/V included."""

    import gc
    import weakref

    if graph:
        graph_stub.install(monkeypatch)
    cfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    ts = tserver.Server(cfg, tbase.get_parallel(arch),
                        tserver.ServerConfig(max_batch=2, max_new_tokens=4), device="cpu")
    refs = []
    prefill = ts.bundle.prefill

    def recording_prefill(*a, **k):
        logits, cache = prefill(*a, **k)
        refs.extend(weakref.ref(t) for t in flatten(cache)[0])
        return logits, cache

    ts.bundle = dataclasses.replace(ts.bundle, prefill=recording_prefill)
    gc.disable()
    try:
        ts.generate(_requests(tserver, cfg, _prompts(length=16)))
        assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()
    assert all(r.captures == graph for r in ts._decode_reqs.values())


def test_deleted_server_frees_its_weights_at_once():
    """The persistent steps do not reference the server, so dropping the
    last reference frees it (and its weights) without the cyclic garbage
    collector."""

    import gc
    import weakref

    ts = tserver.Server(tbase.get_smoke_config("gemma2_9b"), tbase.ParallelConfig(),
                        tserver.ServerConfig(max_batch=1, max_new_tokens=2), device="cpu")
    ts.generate([tserver.Request(tokens=p) for p in _prompts(n=1, length=8)])
    ref = weakref.ref(ts)
    gc.disable()
    try:
        del ts
        assert ref() is None
    finally:
        gc.enable()


def test_persistent_request_rejects_drift():
    req = PersistentRequest(lambda x, y: x + y["a"], (torch.zeros(3), {"a": torch.ones(3)}))
    req(torch.ones(3), {"a": torch.ones(3)})
    assert req.starts == 1
    drifted = [
        (torch.ones(4), {"a": torch.ones(3)}),                    # shape
        (torch.ones(3, dtype=torch.float64), {"a": torch.ones(3)}),  # dtype
        (torch.ones(3), {"b": torch.ones(3)}),                    # structure
    ]
    for args in drifted:
        with pytest.raises(errors.Error) as ei:
            req(*args)
        assert ei.value.klass == errors.ErrorClass.ERR_REQUEST
    assert req.starts == 1


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_7b"])
def test_ssm_tokens_identical_to_reference_server(arch):
    """The mamba2 and zamba2 smoke models in fp32, the reference through
    its chunked SSD form, the port with the reference's weights: a
    24-token prompt runs one chunk of 24."""

    scfg = dict(max_batch=2, max_new_tokens=4, temperature=0.0)
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    js = jserver.Server(jcfg, jbase.get_parallel(arch), jserver.ServerConfig(**scfg), j_comm())
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    ts = tserver.Server(tcfg, tbase.get_parallel(arch), tserver.ServerConfig(**scfg),
                        device="cpu")
    ts.params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params), "cpu")
    prompts = _prompts(length=24, seed=4)
    jtok, _ = js.generate([jserver.Request(tokens=p) for p in prompts])
    ttok, _ = ts.generate([tserver.Request(tokens=p) for p in prompts])
    np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.parametrize("arch", ["paligemma_3b", "seamless_m4t_large_v2"])
def test_vlm_and_encdec_tokens_identical_to_reference_server(arch):
    """The paligemma and seamless smoke models in fp32, the port with the
    reference's weights, both through the plain attention (the reference
    serves with ``attn_impl="ref"``; its Pallas kernel ignores the prefix
    in its causal tile skip, ROADMAP C1): prompts of 16 and 11 tokens, so
    the shorter one's left padding sits between the image prefix and its
    text, as in the reference; 16 frames each for the encoder."""

    scfg = dict(max_batch=2, max_new_tokens=5, temperature=0.0)
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    js = jserver.Server(jcfg, jbase.get_parallel(arch), jserver.ServerConfig(**scfg), j_comm())
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    ts = tserver.Server(tcfg, tbase.get_parallel(arch), tserver.ServerConfig(**scfg),
                        device="cpu")
    ts.params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params), "cpu")
    prompts = _prompts(seed=12)
    prompts[1] = prompts[1][:11]
    jtok, _ = js.generate(_requests(jserver, jcfg, prompts))
    ttok, _ = ts.generate(_requests(tserver, tcfg, prompts))
    np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.parametrize("arch", ["paligemma_3b", "seamless_m4t_large_v2"])
def test_vlm_and_encdec_serve_cli_draws_the_references_requests(monkeypatch, arch, capsys):
    """The serve CLIs on the smoke configs: the port's draws each request's
    tokens and then its image embeddings or frames from the one generator,
    as the reference's does, so the two hand their servers equal requests
    (extras of the reference's shapes); the port's generates."""

    seen = {}

    def recorder(cls, name):
        generate = cls.generate

        def record(self, reqs):
            seen[name] = reqs
            return generate(self, reqs)

        monkeypatch.setattr(cls, "generate", record)

    recorder(jserver.Server, "reference")
    recorder(tserver.Server, "port")
    argv = ["--arch", arch, "--smoke", "--requests", "2", "--prompt-len", "12",
            "--new-tokens", "3"]
    assert jserve.main(argv) == 0
    assert serve.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("generated shape: (2, 3)") == 2
    assert len(seen["port"]) == len(seen["reference"]) == 2
    for t, j in zip(seen["port"], seen["reference"]):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert sorted(t.extra) == sorted(j.extra) == [
            "image_embeds" if arch == "paligemma_3b" else "frames"]
        for k in t.extra:
            assert t.extra[k].dtype == j.extra[k].dtype
            np.testing.assert_array_equal(t.extra[k], j.extra[k])


@pytest.mark.parametrize("arch,prompt_len", [
    ("gemma2_9b", 16), ("phi4_mini_3_8b", 16), ("zamba2_7b", 24),
])
def test_int8_cache_tokens_identical_to_reference_server(arch, prompt_len):
    """``kv_cache_dtype="int8"`` on both sides, through the library's entry
    point (the serve CLI has no flag for it, in the reference either): the
    fp32 smoke models with the reference's weights give the same greedy
    tokens.  gemma2's 16-token prompts wrap its ring buffer."""

    scfg = dict(max_batch=2, max_new_tokens=4, temperature=0.0)
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    jpcfg = dataclasses.replace(jbase.get_parallel(arch), kv_cache_dtype="int8")
    js = jserver.Server(jcfg, jpcfg, jserver.ServerConfig(**scfg), j_comm())
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    tpcfg = dataclasses.replace(tbase.get_parallel(arch), kv_cache_dtype="int8")
    ts = tserver.Server(tcfg, tpcfg, tserver.ServerConfig(**scfg), device="cpu")
    ts.params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params), "cpu")
    prompts = _prompts(length=prompt_len, seed=7)
    jtok, _ = js.generate([jserver.Request(tokens=p) for p in prompts])
    ttok, _ = ts.generate([tserver.Request(tokens=p) for p in prompts])
    np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.parametrize("arch,kv", [("grok_1_314b", "bfloat16"), ("grok_1_314b", "int8"),
                                     ("deepseek_v2_236b", "bfloat16"),
                                     ("deepseek_v2_236b", "int8")])
def test_moe_tokens_identical_to_reference_server(arch, kv):
    """The grok and deepseek smoke models in fp32, the port with the
    reference's weights: greedy tokens from prompts of 16 and 11 tokens
    (the shorter one left-padded), with the bf16 and the int8 cache setting
    (which deepseek's latent cache ignores in both packages, ROADMAP C13)."""

    scfg = dict(max_batch=2, max_new_tokens=5, temperature=0.0)
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    jpcfg = dataclasses.replace(jbase.get_parallel(arch), kv_cache_dtype=kv)
    js = jserver.Server(jcfg, jpcfg, jserver.ServerConfig(**scfg), j_comm())
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    tpcfg = dataclasses.replace(tbase.get_parallel(arch), kv_cache_dtype=kv)
    ts = tserver.Server(tcfg, tpcfg, tserver.ServerConfig(**scfg), device="cpu")
    ts.params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params), "cpu")
    prompts = _prompts(seed=13)
    prompts[1] = prompts[1][:11]
    jtok, _ = js.generate([jserver.Request(tokens=p) for p in prompts])
    ttok, _ = ts.generate([tserver.Request(tokens=p) for p in prompts])
    np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.parametrize("arch", ["grok_1_314b", "deepseek_v2_236b"])
def test_moe_serve_cli_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                       "--prompt-len", "16", "--new-tokens", "4"]) == 0
    assert "generated shape: (2, 4)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_7b"])
def test_ssm_serve_cli_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                       "--prompt-len", "32", "--new-tokens", "4"]) == 0
    assert "generated shape: (2, 4)" in capsys.readouterr().out


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--arch", "gemma2_9b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "12", "--new-tokens", "3"]) == 0
    assert "generated shape: (2, 3)" in capsys.readouterr().out


def test_no_silent_cpu_fallback():
    """Without ``--device cpu`` the port asks for the CUDA device; this
    machine has none, so it raises instead of running on the CPU."""

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(errors.Error) as ei:
        serve.main(["--arch", "gemma2_9b", "--smoke", "--requests", "1",
                    "--prompt-len", "4", "--new-tokens", "2"])
    assert ei.value.klass == errors.ErrorClass.ERR_SESSION
    with pytest.raises(errors.Error):
        tserver.Server(tbase.get_smoke_config("gemma2_9b"), tbase.ParallelConfig(),
                       tserver.ServerConfig())


@pytest.mark.parametrize("argv,klass", [
    # --fanout takes P:D: "2" is refused by the plan parser, in both
    # packages (grok, the first case's old mode, and then the fanout mode
    # itself, are ported)
    (["--arch", "gemma2_9b", "--fanout", "2"], "ERR_ARG"),
    # the disaggregated server is ported: this mode now serves
    (["--arch", "gemma2_9b", "--disaggregate"], None),
    # the continuous-batching engine is ported; it refuses gemma2's
    # ring-buffer (local_global, sliding-window) caches, as the reference's
    # engine does
    (["--arch", "gemma2_9b", "--continuous-batching"], "ERR_UNSUPPORTED_OPERATION"),
    # the tuner behind --plan auto is ported: this mode now serves (the id
    # is the one the case had while the mode raised)
    pytest.param(["--arch", "gemma2_9b", "--plan", "auto"], None,
                 id="argv3-ERR_UNSUPPORTED_OPERATION"),
])
def test_unported_modes_raise_typed(argv, klass):
    if klass is None:
        assert serve.main(argv + ["--smoke", "--device", "cpu", "--requests", "2",
                                  "--prompt-len", "12", "--new-tokens", "3"]) == 0
        return
    with pytest.raises(errors.Error) as ei:
        serve.main(argv + ["--smoke", "--device", "cpu"])
    assert ei.value.klass.name == klass
    if "--continuous-batching" in argv or "--fanout" in argv:
        with pytest.raises(jerrors.Error) as je:
            jserve.main(argv + ["--smoke"])
        assert je.value.klass.name == klass


def test_pvar_names_are_the_references():
    """Every pvar the port registers exists in the reference registry (the
    tuner's are registered where each package's tuner is imported, as
    ``--plan auto`` above imports the port's)."""

    from repro import tune as _jtune  # noqa: F401

    assert set(tool.PVARS) <= set(jtool.PVARS)


# ---------------------------------------------------------------------------
# ring attention across ranks
# ---------------------------------------------------------------------------

SERVER_RING_JAX = textwrap.dedent("""
    import dataclasses, sys
    import jax
    import numpy as np
    from repro.configs.base import ModelConfig, ParallelConfig
    from repro.core._compat import make_mesh
    from repro.runtime.server import Request, Server, ServerConfig

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, dtype="float32")
    scfg = ServerConfig(max_batch=2, max_new_tokens=4)
    prompts = [inp["prompt0"], inp["prompt1"]]
    out = {}
    for name, pcfg in (("base", ParallelConfig()),
                       ("ring", dataclasses.replace(ParallelConfig(), ring_attention=True))):
        server = Server(cfg, pcfg, scfg, mesh)
        out[name], _ = server.generate([Request(tokens=p.copy()) for p in prompts])
    for path, leaf in jax.tree_util.tree_flatten_with_path(server.params)[0]:
        out["param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    np.savez(work + "/jax.npz", **out)
    print("JAX_SERVER_RING_OK")
""")


@pytest.fixture(scope="module")
def ring_servers(tmp_path_factory):
    """The reference's ``SERVER_RING`` setup (``tests/test_ring_attention.py``)
    on a (2, 2) mesh of virtual devices, and the port's on 2 x 2 gloo ranks
    with the reference's weights; zamba2's smoke model on 1 x 2 ranks."""

    work = tmp_path_factory.mktemp("server_ring")
    np.savez(work / "inputs.npz", prompt0=np.arange(1, 33, dtype=np.int32),
             prompt1=np.arange(5, 29, dtype=np.int32))
    jax_proc = start_jax(SERVER_RING_JAX, work)
    zwork = tmp_path_factory.mktemp("zamba2_ring")
    zprompts = _prompts(length=24, seed=9)
    np.savez(zwork / "inputs.npz", prompt0=zprompts[0], prompt1=zprompts[1])
    zamba2 = run_ranks("zamba2_ring", 2, zwork)
    finish_jax(jax_proc, "JAX_SERVER_RING_OK")
    ref = dict(np.load(work / "jax.npz"))
    np.savez(work / "inputs.npz", prompt0=np.arange(1, 33, dtype=np.int32),
             prompt1=np.arange(5, 29, dtype=np.int32),
             **{k: v for k, v in ref.items() if k.startswith("param/")})
    ranks = run_ranks("server", 4, work)
    return ref, ranks, zprompts, zamba2


def test_ring_server_tokens_identical_to_reference(ring_servers):
    """A 2 x 2 gloo ``Server`` with the ring gives the reference's greedy
    tokens (ring and non-ring, which agree), on every rank."""

    ref, ranks, _, _ = ring_servers
    np.testing.assert_array_equal(ref["ring"], ref["base"])
    assert sorted(tuple(r["coords"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        np.testing.assert_array_equal(r["ring"], ref["ring"])
        np.testing.assert_array_equal(r["base"], ref["base"])


def test_zamba2_ring_server_tokens_identical_to_single_process(ring_servers):
    """zamba2's shared attention on a ring of 2 ranks gives the tokens of
    the port's non-ring ``Server`` in one process, with the same seeded
    weights (held against the reference above)."""

    _, _, prompts, ranks = ring_servers
    cfg = dataclasses.replace(tbase.get_smoke_config("zamba2_7b"), dtype="float32")
    ts = tserver.Server(cfg, tbase.get_parallel("zamba2_7b"),
                        tserver.ServerConfig(max_batch=2, max_new_tokens=4), device="cpu")
    want, _ = ts.generate([tserver.Request(tokens=p) for p in prompts])
    for r in ranks:
        np.testing.assert_array_equal(r["ring"], want)


def test_serve_cli_folds_the_world_with_mesh(capsys):
    """``--mesh DxM`` folds the process world (a world of one here); a
    grid larger than the world raises ``ERR_DIMS``."""

    assert serve.main(["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu", "--mesh", "1x1",
                       "--requests", "2", "--prompt-len", "8", "--new-tokens", "2"]) == 0
    assert "generated shape: (2, 2)" in capsys.readouterr().out
    with pytest.raises(errors.Error) as ei:
        serve.main(["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu", "--mesh", "2x2"])
    assert ei.value.klass == errors.ErrorClass.ERR_DIMS
