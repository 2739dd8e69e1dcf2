"""The continuous-batching engine over a placed server on gloo ranks
against the reference's engine on virtual devices.

``tests/test_engine.py``'s ragged-admission case (its tiny fp32 model, 6
ragged requests with budgets 6, 3, 5, 2, 4, 6 over 4 slots, a bucket of 8,
blocks of 4: the last two admitted mid-flight) served by the reference's
engine on a placed server on a 1 x 2 and a 2 x 2 grid, and by the port's
on 2 and 4 gloo ranks from the reference's weights placed under
``param_specs``, with the bf16 and the int8 cache: every request's tokens
equal, exactly (temperature 0); the reference's engine raises on 2 x 2
(ROADMAP C19), so the port's is held there to the 1 x 2 reference's
tokens.  The port's slot table is the placed
prefill's cache under ``cache_specs`` (batch over data, so the 2 x 2
grid's inserts land in another rank's rows through the placed ops), the
decode runs through one persistent request, and every rank returns the
same tokens.  ``serve --continuous-batching --mesh 1x2`` runs on two gloo
ranks.
"""

from __future__ import annotations

import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import api as japi

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import (  # noqa: E402
    ENGINE_BUDGETS,
    ENGINE_CFG,
    finish_jax,
    finish_ranks,
    run_ranks,
    start_jax,
    start_ranks,
)

torch.set_num_threads(1)

GRIDS = ((1, 2), (2, 2))
KV = ("bfloat16", "int8")


def _prompts():
    """``tests/test_engine.py``'s ``_prompts(6, seed=3)``."""

    rng = np.random.default_rng(3)
    return [rng.integers(1, 64, size=(int(rng.integers(2, 9)),), dtype=np.int32)
            for _ in range(len(ENGINE_BUDGETS))]


JAX_SIDE = textwrap.dedent("""
    import sys
    import numpy as np
    from repro.configs.base import ModelConfig, ParallelConfig
    from repro.core.errors import Error
    from repro.launch.mesh import make_host_communicator
    from repro.runtime.engine import EngineConfig, make_engine
    from repro.runtime.server import Server, ServerConfig

    work = sys.argv[1]
    inp = dict(np.load(work + "/inputs.npz"))
    prompts = [inp[f"prompt{i}"] for i in range(len(BUDGETS))]
    out = {}
    for dims in GRIDS:
        tag = "x".join(map(str, dims))
        for kv in KV:
            server = Server(ModelConfig(**CFG), ParallelConfig(kv_cache_dtype=kv),
                            ServerConfig(max_batch=4, max_new_tokens=6),
                            make_host_communicator(*dims))
            eng = make_engine(server, EngineConfig(prompt_bucket=8, block_tokens=4))
            handles = [eng.submit(p, max_new=b) for p, b in zip(prompts, BUDGETS)]
            try:
                eng.run()
            except Error as e:   # the slot table's rows split over data (C19)
                out[f"{tag}/{kv}/error"] = np.array(e.klass.name)
                continue
            for i, h in enumerate(handles):
                out[f"{tag}/{kv}/tokens{i}"] = np.array(h.generated)
    np.savez(work + "/jax.npz", **out)
    print("JAX_ENGINE_PLACED_OK")
""").replace("BUDGETS", repr(ENGINE_BUDGETS)).replace("GRIDS", repr(GRIDS)).replace(
    "KV", repr(KV)).replace("CFG", repr(ENGINE_CFG))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine_placed")
    prompts = {f"prompt{i}": p for i, p in enumerate(_prompts())}
    np.savez(root / "inputs.npz", **prompts)
    jax_proc = start_jax(JAX_SIDE, root)
    params = japi.build(jbase.ModelConfig(**ENGINE_CFG)).init(jax.random.PRNGKey(0))
    entries = {"param/" + "/".join(str(k.key) for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    started = {}
    for dims in GRIDS:
        work = root / ("x".join(map(str, dims)))
        work.mkdir()
        np.savez(work / "inputs.npz", dims=np.array(dims), **prompts, **entries)
        started[dims] = start_ranks("engine_placed", int(np.prod(dims)), work)
    ranks = {dims: finish_ranks(s) for dims, s in started.items()}
    finish_jax(jax_proc, "JAX_ENGINE_PLACED_OK")
    return dict(np.load(root / "jax.npz")), ranks


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dims", GRIDS, ids=["1x2", "2x2"])
def test_engine_over_a_placed_server_gives_the_references_tokens(engines, dims, kv):
    """On 2 x 2 the reference's engine raises at its second decode start
    (ROADMAP C19: its slot table's position vector comes back split over
    data, and its persistent decode request refuses the new sharding); the
    port's gives the 1 x 2 reference's tokens there too (fp32: the grid
    changes no value)."""

    ref, ranks = engines
    if dims == (2, 2):
        assert str(ref[f"2x2/{kv}/error"]) == "ERR_REQUEST"
    tag = "1x2"
    for r in ranks[dims]:
        assert bool(r[f"{kv}/placed"])
        assert "plain" not in list(r[f"{kv}/cache_specs"])
        assert int(r[f"{kv}/decode_requests"]) == 1
        assert int(r[f"{kv}/steps"]) < sum(ENGINE_BUDGETS)   # admitted mid-flight
        for i, budget in enumerate(ENGINE_BUDGETS):
            got = r[f"{kv}/tokens{i}"]
            assert len(got) == budget
            np.testing.assert_array_equal(got, ref[f"{tag}/{kv}/tokens{i}"],
                                          err_msg=f"request {i}")
    if dims[0] > 1:
        # the 2 x 2 slot table splits its rows over data
        assert all("('data',)" in s for s in ranks[dims][0][f"{kv}/cache_specs"])


def test_serve_cli_continuous_batching_on_a_placed_mesh(tmp_path):
    np.savez(tmp_path / "inputs.npz", mesh="1x2")
    ranks = run_ranks("serve_cb_mesh", 2, tmp_path)
    for r in ranks:
        assert bool(r["placed"])
        np.testing.assert_array_equal(r["lengths"], [4] * 6)
        np.testing.assert_array_equal(r["tokens"], ranks[0]["tokens"])
