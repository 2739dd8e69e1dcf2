"""The session and communicator calls the elastic epochs build on —
``Session.refresh``, ``register_mesh_psets``, ``Communicator.create``,
``dup``, ``local_ranks`` and ``split`` over subsets of a grid's axes — on 4
gloo ranks against the reference's same calls on 4 virtual JAX devices
(``tests/test_session.py``'s refresh, create, dup and split cases): the
same members, in the same order, for every color of every split; the same
mesh process sets; the same refresh arithmetic.  The port's split and dup
communicators also carry an allreduce over their own process groups."""

from __future__ import annotations

import json
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ranks import SPLIT_AXES, finish_jax, run_ranks, start_jax  # noqa: E402

JAX_SIDE = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from repro.core.communicator import Communicator, local_ranks
    from repro.core.session import Group, GroupComparison, Session, default_session

    SPLIT_AXES = %r
    work = sys.argv[1]
    ids = {d: i for i, d in enumerate(jax.devices())}
    out = {}
    sess = default_session()
    wg = sess.group("repro://world")
    comm = Communicator.from_group(wg, tag="repro://grid", shape=(2, 2),
                                   axis_names=("data", "model"))
    sub = comm.split("model")
    out["split_model"] = [[ids[d] for d in sub.group(data=i).devices] for i in range(2)]
    names = sess.register_mesh_psets(comm.mesh)
    out["mesh_psets"] = names
    out["psets"] = {n: [ids[d] for d in sess.pset(n)] for n in names}
    grid3 = Communicator.from_group(wg, tag="repro://grid3", shape=(2, 2, 1),
                                    axis_names=("pod", "data", "model"))
    for axes in SPLIT_AXES:
        s = grid3.split(*axes)
        dropped = [a for a in grid3.axis_names if a not in axes]
        colors = [[ids[d] for d in s.group(**dict(zip(dropped, idx))).devices]
                  for idx in np.ndindex(*(grid3.mesh.shape[a] for a in dropped))]
        out["/".join(axes)] = {"colors": colors,
                               "shape": [grid3.mesh.shape[a] for a in axes],
                               "axes": list(s.axis_names)}
    c = Communicator.create((1,), ("w",), devices=jax.devices())
    out["create"] = [c.managed, c.group().size(), ids[c.group().devices[0]]]
    d = comm.dup()
    out["dup"] = [d.group().compare(comm.group()) is GroupComparison.IDENT, d.managed]
    out["local_ranks"] = local_ranks(comm).tolist()

    class FakeDev:
        def __init__(self, i):
            self.id, self.process_index, self.platform = 1000 + i, 0, "elastic"

    other = Session.init()
    real = other.pset("repro://world")
    fakes = (FakeDev(0), FakeDev(1))
    other.refresh(devices=tuple(real) + fakes)
    grown = [other.group().size(), other.group("repro://platform/elastic").size()]
    other.register_pset("repro://doomed", Group(fakes))
    other.register_pset("repro://mixed", Group([real[0], fakes[0]]))
    other.register_pset("repro://stable", Group([real[0]]))
    other.refresh(devices=tuple(real))
    out["refresh"] = grown + [
        other.group().size(), "repro://platform/elastic" in other.psets(),
        "repro://doomed" in other.psets(), len(other.pset("repro://mixed")),
        len(other.pset("repro://stable")), other.pset("repro://mixed") == (real[0],)]
    sess.register_pset("repro://user", wg.incl([0, 1]))
    again = default_session(refresh=True)
    out["in_place"] = [again is sess, "repro://user" in again.psets()]
    with open(work + "/jax.json", "w") as f:
        json.dump(out, f)
    print("JAX_SESSION_CALLS_OK")
""" % (SPLIT_AXES,))


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    work = tmp_path_factory.mktemp("session_calls")
    np.savez(work / "inputs.npz", unused=np.zeros(1))
    proc = start_jax(JAX_SIDE, work)
    ranks = run_ranks("session_calls", 4, work)
    finish_jax(proc, "JAX_SESSION_CALLS_OK")
    with open(work / "jax.json") as f:
        return ranks, json.load(f)


def _color_of(colors: list, rank: int) -> list:
    (color,) = [c for c in colors if rank in c]
    return color


def test_split_over_one_axis_and_mesh_psets_equal_the_references(calls):
    ranks, ref = calls
    for r, out in enumerate(ranks):
        assert list(out["split_model"]) == _color_of(ref["split_model"], r)
        assert list(out["mesh_psets"]) == ref["mesh_psets"]
        for name, members in ref["psets"].items():
            assert list(out[f"pset/{name}"]) == members, name


@pytest.mark.parametrize("axes", SPLIT_AXES, ids=["/".join(a) for a in SPLIT_AXES])
def test_split_over_axis_subsets_equals_the_references(calls, axes):
    """Every rank's color of the split holds the reference's members of
    that color, in its order, on the grid of the axes given; the color's
    process group sums their ranks."""

    ranks, ref = calls
    key = "/".join(axes)
    for r, out in enumerate(ranks):
        color = _color_of(ref[key]["colors"], r)
        assert list(out[f"split3/{key}/ranks"]) == color
        assert list(out[f"split3/{key}/shape"]) == ref[key]["shape"]
        assert list(out[f"split3/{key}/axes"]) == ref[key]["axes"] == list(axes)
        assert float(out[f"split3/{key}/sum"][0]) == sum(color)


def test_create_dup_and_local_ranks_equal_the_references(calls):
    ranks, ref = calls
    for out in ranks:
        assert [bool(out["create"][0]), int(out["create"][1]), int(out["create"][2])] \
            == ref["create"] == [True, 1, 0]
        ident, managed, own_group, same_shape = (bool(x) for x in out["dup"])
        assert [ident, managed] == ref["dup"] == [True, False]
        assert own_group and same_shape
        assert float(out["dup_sum"][0]) == 1 + 2 + 3 + 4
        assert out["local_ranks"].tolist() == ref["local_ranks"]


def test_refresh_rederives_and_prunes_as_the_reference(calls):
    ranks, ref = calls
    for out in ranks:
        assert [int(x) for x in out["refresh"]] == [int(x) for x in ref["refresh"]]
        assert [int(x) for x in out["refresh"]] == [6, 2, 4, 0, 0, 1, 1, 1]
        assert [bool(x) for x in out["in_place"]] == ref["in_place"] == [True, True]
