"""The port's ``DisaggregatedServer`` against the reference's, on CPU
tensors: prefill and decode on disjoint groups of one process set, the KV
cache crossing through an RMA window, tokens equal to the single-group
``Server``'s at temperature 0.

* On the world of one of this process (the degenerate set: one rank is
  prefill and decode): the decode step through the graph path
  (``graph_stub``) gives the eager tokens, captured once a ``generate``;
  the split's refusals (the parity with the reference on one rank is in
  ``test_torch_disaggregated_one.py``).
* On 4 gloo ranks (one process each) against the reference on 4 virtual
  JAX devices: paired (2:2) and fan-out (1:3) on the tiny model, and
  gemma2's smoke model with the int8 cache, paired.  Every rank returns
  the reference's tokens.  The reference counts its pvars once for the
  whole set; a port rank counts the requests of the groups it belongs to:
  ``trace:prefill_step`` on prefill ranks, ``trace:decode_step`` on decode
  ranks, so those are held as the maximum over ranks, and the handoff's
  (``trace:kv_transfer``, ``rma_*``) on every rank.
* The serve CLI: ``--disaggregate`` here and ``--fanout 1:3`` on 4 ranks
  give the single-group CLI's tokens and the reference CLI's stats keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import textwrap

import jax
import numpy as np
import pytest
import torch

import graph_stub
from repro.configs import base as jbase
from repro.core import errors as jerrors
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.runtime import server as jserver
from repro_torch.configs import base as tbase
from repro_torch.core import errors
from repro_torch.launch import serve
from repro_torch.runtime import server as tserver
from torch_ranks import (
    DISAGG_CASES,
    DISAGG_PVARS,
    disagg_config,
    finish_jax,
    run_ranks,
    start_jax,
)

torch.set_num_threads(1)

WORLD = 4
NEW = 6


def _pcfg(module, arch, kv):
    pcfg = module.get_parallel(arch) if arch != "tiny" else module.ParallelConfig()
    return dataclasses.replace(pcfg, kv_cache_dtype=kv)


def _prompts(cfg, n=2):
    # 16 tokens: past gemma2's smoke window of 8, so its local layers'
    # ring-buffer caches wrap
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, size=(16,), dtype=np.int32) for _ in range(n)]


def _ref_params(arch):
    """The reference Server's weights for ``arch`` (seed 0), as numpy."""

    cfg = disagg_config(arch, jbase)
    params = jax.jit(japi.build(cfg).init)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _pvars(module, names=DISAGG_PVARS):
    counts = module.pvar_read()
    return {k: counts.get(k, 0) for k in names}


# -- the degenerate set: one rank is prefill and decode -------------------------
# (the parity of its tokens, stats and pvars with the reference:
# test_torch_disaggregated_one.py)


def test_decode_graph_after_the_handoff(monkeypatch):
    """The decode step after the window handoff through the graph path
    (``graph_stub``): the eager tokens, one capture a generate, and the
    handoff request stays eager (it donates nothing)."""

    cfg = disagg_config("tiny", tbase)
    scfg = tserver.ServerConfig(max_batch=2, max_new_tokens=NEW)
    reqs = [tserver.Request(tokens=p) for p in _prompts(cfg)]
    want, _ = tserver.Server(cfg, tbase.ParallelConfig(), scfg, device="cpu").generate(reqs)
    graph_stub.install(monkeypatch)
    dis = tserver.DisaggregatedServer(cfg, tbase.ParallelConfig(), scfg, device="cpu")
    for i in range(2):
        got, stats = dis.generate(reqs)
        np.testing.assert_array_equal(got, want)
        (decode,) = dis.decode._decode_reqs.values()
        assert decode.captures and decode.captured == i + 1
    (handoff,) = dis._transfer_reqs.values()
    assert not handoff.captures and handoff.starts == 2
    assert stats["kv_pages"] == 4


def test_split_refusals_equal_the_reference():
    """A prefill fraction outside (0, 1) is ERR_ARG, a fan-out that does not
    cover the set ERR_TOPOLOGY, in both packages."""

    cfg_t, cfg_j = disagg_config("tiny", tbase), disagg_config("tiny", jbase)
    for kw in ({"prefill_fraction": 1.0}, {"prefill_fraction": 0.0}, {"fanout": (1, 3)}):
        with pytest.raises(jerrors.Error) as je:
            jserver.DisaggregatedServer(cfg_j, jbase.ParallelConfig(), jserver.ServerConfig(),
                                        **kw)
        with pytest.raises(errors.Error) as te:
            tserver.DisaggregatedServer(cfg_t, tbase.ParallelConfig(), tserver.ServerConfig(),
                                        device="cpu", **kw)
        assert te.value.klass.name == je.value.klass.name


def _cli_stats(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    text = buf.getvalue()
    return json.loads(text[text.index("{"):])


_CLI = ["--arch", "phi4_mini_3_8b", "--smoke", "--requests", "2", "--prompt-len", "8",
        "--new-tokens", "4"]


def test_disaggregate_cli_on_cpu():
    """``--disaggregate --kv-pages 3``: the single-group CLI's tokens (the
    same seeded weights) and the reference CLI's stats keys; no fallback
    to the CPU without ``--device cpu``."""

    _, tokens, stats = serve.run(_CLI + ["--device", "cpu", "--disaggregate", "--kv-pages", "3"])
    _, plain, _ = serve.run(_CLI + ["--device", "cpu"])
    np.testing.assert_array_equal(tokens, plain)
    assert stats["kv_pages"] == 3 and stats["kv_bytes"] > 0
    ref = _cli_stats(jserve.main, _CLI + ["--disaggregate", "--kv-pages", "3"])
    assert set(stats) == set(ref)
    if not torch.cuda.is_available():
        with pytest.raises(errors.Error) as ei:
            serve.run(_CLI + ["--disaggregate"])
        assert ei.value.klass == errors.ErrorClass.ERR_SESSION


@pytest.mark.parametrize("argv", [["--plan", "1x1"], ["--plan", "data=1"]])
def test_plan_folds_onto_the_host_communicator(argv):
    """A non-fanout ``--plan`` folds its dims onto the host communicator,
    the reference's grammar, and serves the plain CLI's tokens."""

    server, tokens, _ = serve.run(_CLI + ["--device", "cpu"] + argv)
    _, plain, _ = serve.run(_CLI + ["--device", "cpu"])
    np.testing.assert_array_equal(tokens, plain)
    assert server.comm.shape == (1, 1)


@pytest.mark.parametrize("argv", [["--plan", "1x1", "--fanout", "1:3"],
                                  ["--plan", "1x1", "--mesh", "1x1"],
                                  ["--disaggregate", "--mesh", "1x1"],
                                  ["--fanout", "1:3", "--mesh", "1x1"]])
def test_layout_usage_errors_equal_the_reference(argv):
    with pytest.raises(SystemExit) as je:
        jserve.main(_CLI + argv)
    with pytest.raises(SystemExit) as te:
        serve.main(_CLI + argv + ["--device", "cpu"])
    assert te.value.code == je.value.code == 2


# -- 4 ranks ------------------------------------------------------------------


JAX_SIDE = textwrap.dedent("""
    import contextlib, dataclasses, io, json, sys
    import numpy as np
    from repro.configs import base
    from repro.core import tool
    from repro.launch import serve
    from repro.launch.mesh import make_host_communicator
    from repro.runtime.server import DisaggregatedServer, Request, Server, ServerConfig

    sys.path.insert(0, "tests/port")
    from torch_ranks import DISAGG_CASES, DISAGG_PVARS, disagg_config

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    out, bases = {}, {}
    for name, arch, kv, split, pages in DISAGG_CASES:
        cfg = disagg_config(arch, base)
        pcfg = dataclasses.replace(
            base.get_parallel(arch) if arch != "tiny" else base.ParallelConfig(),
            kv_cache_dtype=kv)
        scfg = ServerConfig(max_batch=2, max_new_tokens=6)
        reqs = [Request(tokens=inp[f"{arch}_prompt{i}"].copy()) for i in range(2)]
        # one single-group baseline a model and cache: the fan-out case
        # serves the paired case's model and prompts
        key = (arch, kv)
        if key not in bases:
            bases[key], _ = Server(cfg, pcfg, scfg, make_host_communicator()).generate(reqs)
        out[f"{name}_base"] = bases[key]
        tool.pvar_reset()
        dis = DisaggregatedServer(cfg, pcfg, scfg, kv_pages=pages, **split)
        for i in range(2):
            out[f"{name}_tokens{i}"], stats = dis.generate(reqs)
        counts = tool.pvar_read()
        out[f"{name}_pvars"] = np.array([counts.get(k, 0) for k in DISAGG_PVARS])
        out[f"{name}_stats"] = np.array([stats["kv_bytes"], stats["kv_pages"],
                                         stats["prefill_devices"], stats["decode_devices"]])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "phi4_mini_3_8b", "--smoke", "--fanout", "1:3", "--requests", "2",
                    "--prompt-len", "8", "--new-tokens", "4"])
    text = buf.getvalue()
    out["cli_keys"] = np.array(sorted(json.loads(text[text.index("{"):])))
    np.savez(work + "/jax.npz", **out)
    print("JAX_DISAGG_OK")
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("disagg")
    inputs = {}
    for arch in sorted({c[1] for c in DISAGG_CASES}):
        for path, leaf in jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]:
            inputs[f"{arch}/param/" + "/".join(str(k.key) for k in path)] = leaf
        for i, p in enumerate(_prompts(disagg_config(arch, jbase))):
            inputs[f"{arch}_prompt{i}"] = p
    np.savez(work / "inputs.npz", **inputs)
    jax_proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("disagg", WORLD, work)
    cli_work = work / "cli"
    cli_work.mkdir()
    np.savez(cli_work / "inputs.npz", unused=np.zeros(1))
    cli = run_ranks("serve_fanout", WORLD, cli_work)
    finish_jax(jax_proc, "JAX_DISAGG_OK")
    return ranks, cli, dict(np.load(work / "jax.npz"))


@pytest.mark.parametrize("case", [c[0] for c in DISAGG_CASES])
def test_four_ranks_equal_the_reference(four_ranks, case):
    ranks, _, ref = four_ranks
    np.testing.assert_array_equal(ref[f"{case}_tokens0"], ref[f"{case}_base"])
    for r in ranks:
        for i in range(2):
            np.testing.assert_array_equal(r[f"{case}_tokens{i}"], ref[f"{case}_base"])
        np.testing.assert_array_equal(r[f"{case}_stats"], ref[f"{case}_stats"])
    roles = np.array([r[f"{case}_roles"] for r in ranks])
    assert roles.any(axis=1).all() and not roles.all(axis=1).any()   # disjoint groups
    pvars = np.array([r[f"{case}_pvars"] for r in ranks])
    by_group = {"trace:prefill_step", "trace:decode_step"}
    for j, name in enumerate(DISAGG_PVARS):
        if name in by_group:
            assert pvars[:, j].max() == ref[f"{case}_pvars"][j], name
        else:
            assert (pvars[:, j] == ref[f"{case}_pvars"][j]).all(), (name, pvars[:, j])


def test_fanout_cli_on_four_ranks(four_ranks):
    """``serve --fanout 1:3`` on 4 gloo ranks: every rank prints the
    single-group CLI's tokens (the same seeded weights) and the reference
    CLI's stats keys."""

    _, cli, ref = four_ranks
    _, plain, _ = serve.run(_CLI + ["--device", "cpu"])
    for r in cli:
        np.testing.assert_array_equal(r["tokens"], plain)
        assert sorted(r["keys"].tolist()) == sorted(ref["cli_keys"].tolist())
