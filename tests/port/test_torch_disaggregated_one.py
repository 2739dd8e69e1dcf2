"""The port's ``DisaggregatedServer`` on the world of one of this process
(the degenerate set: one rank is prefill and decode, and the handoff still
crosses a one-rank bridge) against the reference's on its world of one:
the reference test's tiny fp32 model, its int8 cache and the gemma2 smoke
model (ring-buffer caches) with the int8 cache, on the reference's
weights.  Tokens, ``kv_bytes``, ``kv_pages``, the stats keys and the pvars
equal the reference's, and the tokens the single-group ``Server``'s (the
4-rank cases and the CLI are in ``test_torch_disaggregated.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import tool as jtool
from repro.runtime import server as jserver
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core import tool
from repro_torch.runtime import server as tserver
from test_torch_disaggregated import NEW, _pcfg, _prompts, _pvars, _ref_params
from torch_ranks import disagg_config

torch.set_num_threads(1)


_ONE = [("tiny", "bfloat16"), ("tiny", "int8"), ("gemma2_9b", "int8")]


@pytest.mark.parametrize("arch,kv", _ONE)
def test_world_of_one_equals_the_reference(arch, kv):
    """Tokens of two generates, kv_bytes, kv_pages, the stats keys and the
    pvars equal the reference's DisaggregatedServer on its world of one,
    and the tokens the port's single-group Server's on the same weights
    (held against the reference's Server in test_torch_server.py)."""

    scfg = dict(max_batch=2, max_new_tokens=NEW)
    jcfg, tcfg = disagg_config(arch, jbase), disagg_config(arch, tbase)
    prompts = _prompts(jcfg)
    params = params_from_jax(_ref_params(arch), "cpu")

    jtool.pvar_reset()
    jdis = jserver.DisaggregatedServer(jcfg, _pcfg(jbase, arch, kv),
                                       jserver.ServerConfig(**scfg), kv_pages=3)
    jout = [jdis.generate([jserver.Request(tokens=p) for p in prompts]) for _ in range(2)]
    jpvars = _pvars(jtool)

    base = tserver.Server(tcfg, _pcfg(tbase, arch, kv), tserver.ServerConfig(**scfg),
                          device="cpu")
    base.params = params
    tbase_tok, _ = base.generate([tserver.Request(tokens=p) for p in prompts])
    tool.pvar_reset()
    tdis = tserver.DisaggregatedServer(tcfg, _pcfg(tbase, arch, kv),
                                       tserver.ServerConfig(**scfg), kv_pages=3, device="cpu")
    assert tdis.prefill is not None and tdis.decode is not None
    tdis.prefill.params = tdis.decode.params = params
    tout = [tdis.generate([tserver.Request(tokens=p) for p in prompts]) for _ in range(2)]
    tpvars = _pvars(tool)

    for (ttok, tstats), (jtok, jstats) in zip(tout, jout):
        np.testing.assert_array_equal(ttok, jtok)
        np.testing.assert_array_equal(ttok, tbase_tok)
        assert set(tstats) == set(jstats)
        for k in ("kv_bytes", "kv_pages", "prefill_devices", "decode_devices", "gen_lens",
                  "generated_tokens", "batch"):
            assert tstats[k] == jstats[k], k
    assert tpvars == jpvars
    assert tpvars["trace:kv_transfer"] == 1 and tpvars["rma_rput"] == 3


