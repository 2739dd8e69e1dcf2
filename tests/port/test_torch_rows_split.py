"""Placed state and the rows of its batch, on gloo ranks.

DTensor's strategy search treats a move on a mesh axis where every operand
is replicated as free, and breaks ties between equal-cost strategies in the
iteration order of a set whose hash differs from process to process, so
ranks could issue different collectives.  A replicated batch leaves the
data axes free that way: placed state serves and trains a batch its data
axes do not split off those axes, replicated over them, as the reference
replicates it (``sharding.local.replicating``); a server whose model axis
is one rank keeps whole weights, so ``serve --mesh 3x1`` at a batch of 2
takes no placed path.  The three-rank programs run three times over, each
time in fresh processes, each rank under a hash seed of its own.

The int8 moments of a leaf whose last axis is split are quantized over
whole rows a piece at a time: bit for bit the update of the whole leaf.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.base import ParallelConfig
from repro_torch.launch import serve
from repro_torch.sharding import rules
from repro_torch.sharding.local import rows_split

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import finish_ranks, run_ranks, start_ranks  # noqa: E402

#: each run's ``PYTHONHASHSEED`` per rank; (11, 12, 13) made the ranks
#: issue different collectives before the data axes were taken out of the
#: placed call's mesh
HASH_SEEDS = ((0, 1, 2), (11, 12, 13), (5, 3, 7))


@dataclasses.dataclass
class _Mesh:
    """What ``check_rows_split`` reads of a ``DeviceMesh``."""

    mesh_dim_names: tuple
    shape: tuple

    @property
    def mesh(self):
        return np.empty(self.shape)


@pytest.mark.parametrize("names, shape, rows, ok", [
    (("data", "model"), (3, 1), 2, False),
    (("data", "model"), (3, 1), 3, True),
    (("data", "model"), (2, 2), 2, True),
    (("data", "model"), (2, 2), 1, False),
    (("data", "model"), (1, 4), 1, True),
    (("pod", "data", "model"), (2, 2, 2), 2, False),
    (("pod", "data", "model"), (2, 2, 2), 4, True),
])
def test_rows_must_split_over_the_data_axes(names, shape, rows, ok):
    """A batch the data axes do not split is replicated, as the reference's
    ``batch_spec`` drops the mapping, not refused."""

    pcfg = dataclasses.replace(ParallelConfig(), data_axes=tuple(n for n in names
                                                                 if n != "model"))
    assert rows_split(rows, _Mesh(names, shape), pcfg) is ok
    spec = rules.batch_spec({"tokens": np.zeros((rows, 8), np.int32)},
                            dict(zip(names, shape)), pcfg)["tokens"]
    assert (spec[0] is not None) is ok


def test_three_ranks_serve_two_rows_whole_and_refuse_them_placed(tmp_path):
    """Placed on 3 x 1, the 2 rows the data axis does not split give the
    whole weights' tokens and train as one rank trains the same batch, for
    every assignment of hash seeds (the name is the refusal's, which this
    result replaced)."""

    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_communicator
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(11)
    prompts = {f"prompt{j}": rng.integers(1, 128, size=(8,), dtype=np.int32) for j in range(3)}
    runs = []
    for i, seeds in enumerate(HASH_SEEDS):
        work = tmp_path / f"run{i}"
        work.mkdir()
        np.savez(work / "inputs.npz", **prompts)
        runs.append(start_ranks("rows_split", 3, work,
                                envs=[{"PYTHONHASHSEED": str(x)} for x in seeds]))
    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32")
    one = Trainer(cfg, ParallelConfig(), TrainerConfig(steps=2, lr=1e-3, log_every=1),
                  make_host_communicator(device="cpu"), seq_len=16, global_batch=2,
                  clock=lambda: 0.0).run()["metrics"]
    for started in runs:
        ranks = finish_ranks(started)
        first = ranks[0]
        np.testing.assert_array_equal(first["whole3"][:2], first["whole2"])
        for r in ranks:
            assert not bool(r["placed_by_mesh"]) and bool(r["placed"])
            np.testing.assert_array_equal(r["whole2"], first["whole2"])
            np.testing.assert_array_equal(r["placed2"], first["whole2"])
            np.testing.assert_array_equal(r["placed3"], first["whole3"])
            assert bool(r["trainer_placed"])
            np.testing.assert_allclose(r["trainer_losses"], [m["loss"] for m in one],
                                       rtol=1e-5)
            np.testing.assert_allclose(r["trainer_grad_norms"],
                                       [m["grad_norm"] for m in one], rtol=1e-5)


def test_serve_cli_on_a_3x1_mesh_keeps_whole_weights(tmp_path):
    np.savez(tmp_path / "inputs.npz", mesh=np.array("3x1"))
    ranks = run_ranks("serve_mesh", 3, tmp_path)
    _, plain, _ = serve.run(["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu",
                             "--requests", "2", "--prompt-len", "8", "--new-tokens", "4"])
    for r in ranks:
        assert not bool(r["placed"])
        np.testing.assert_array_equal(r["tokens"], plain)


def test_split_row_int8_update_in_pieces_is_the_whole_update(tmp_path):
    rng = np.random.default_rng(3)
    steps = 3
    inputs = {"w": rng.standard_normal((8, 16)).astype(np.float32), "steps": steps}
    inputs.update({f"g{i}": rng.standard_normal((8, 16)).astype(np.float32)
                   for i in range(steps)})
    np.savez(tmp_path / "inputs.npz", **inputs)
    for r in run_ranks("split_rows_update", 2, tmp_path):
        n = sum(k.startswith("want") for k in r)
        assert n == 6  # w, step, mu (q, scale), nu (q, scale)
        for i in range(n):
            np.testing.assert_array_equal(r[f"got{i}"], r[f"want{i}"])
