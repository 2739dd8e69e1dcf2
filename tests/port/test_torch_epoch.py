"""The port's communicator epochs (``repro_torch.core.epoch``) against the
reference's (``repro.core.epoch``): ``tests/test_epoch.py``'s cases, each
run through both packages on the same member lists — the TopologySpec
resolution and its errors, the epoch algebra (dims, generations, pools,
process-set names), revocation (``ERR_REVOKED``), no survivors
(``ERR_PROC_FAILED``), the per-epoch cache (one build per epoch), the
``epoch:*`` pvars, the fabric on the world of one (adopted, built,
Cartesian), ``cart_refold`` and ``PartitionedGradSync.for_epoch``.

Groups are device-agnostic, so the algebra runs on letters in both
packages; the fabric runs on the port's gloo world of one and the
reference's one CPU device."""

from __future__ import annotations

import pytest

from repro.core import errors as jerrors
from repro.core import tool as jtool
from repro.core import topology as jtopology
from repro.core.communicator import world as jworld
from repro.core.epoch import ELASTIC as JELASTIC
from repro.core.epoch import CommEpoch as JCommEpoch
from repro.core.epoch import TopologySpec as JTopologySpec
from repro.core.session import Group as JGroup
from repro.core.session import default_session as jdefault_session
from repro_torch.core import errors, tool, topology
from repro_torch.core.communicator import world
from repro_torch.core.epoch import ELASTIC, CommEpoch, TopologySpec
from repro_torch.core.session import Group, default_session

# the two packages side by side: (spec, epoch, group, errors) of each
SIDES = {
    "reference": (JTopologySpec, JCommEpoch, JGroup, jerrors),
    "port": (TopologySpec, CommEpoch, Group, errors),
}
PVARS = ("epoch:create", "epoch:advance", "epoch:revoke", "epoch:rebuild",
         "epoch:request_rebuild")


def _both(fn):
    """``fn(spec, epoch, group, errors)`` through each package; the two
    results, which must be equal."""

    ref, port = (fn(*SIDES[side]) for side in ("reference", "port"))
    assert ref == port, (ref, port)
    return port


def _error_name(fn) -> str:
    try:
        fn()
    except (errors.Error, jerrors.Error) as e:
        return e.klass.name
    return "none"


# ---------------------------------------------------------------------------
# TopologySpec
# ---------------------------------------------------------------------------


def test_spec_resolves_elastic_dim():
    def case(Spec, _e, _g, _err):
        assert JELASTIC == ELASTIC == -1
        spec = Spec((-1, 2), ("data", "stage"), (False, False))
        return (spec.fixed_size, spec.resolve(8), spec.resolve(7), spec.resolve(2),
                _error_name(lambda: spec.resolve(1)))

    assert _both(case) == (2, (4, 2), (3, 2), (1, 2), "ERR_DIMS")


def test_spec_fixed_shape_passthrough():
    def case(Spec, _e, _g, _err):
        spec = Spec((4, 2), ("data", "model"))
        return (spec.resolve(8), spec.resolve(100), spec.is_cart,
                Spec((-1,), ("data",), (True,)).is_cart)

    assert _both(case) == ((4, 2), (4, 2), False, True)


def test_spec_validation():
    def case(Spec, _e, _g, _err):
        return [_error_name(lambda a=a: Spec(*a)) for a in (
            ((-1, -1), ("a", "b")), ((2, 2), ("only_one",)), ((2,), ("a",), (False, False)),
            ((0,), ("a",)))]

    assert _both(case) == ["ERR_DIMS"] * 4


def test_spec_from_communicator_marks_data_elastic():
    jspec = JTopologySpec.from_communicator(jworld(refresh=True))
    spec = TopologySpec.from_communicator(world(refresh=True, device_type="cpu"))
    assert (spec.shape, spec.periods) == (jspec.shape, jspec.periods) == ((ELASTIC,), None)
    assert spec.axis_names == jspec.axis_names == ("world",)


# ---------------------------------------------------------------------------
# epoch generation algebra (device-agnostic)
# ---------------------------------------------------------------------------


def _toy(Spec, Epoch, G, n=8, shape=(-1, 2), periods=(False, False)):
    return Epoch(G("abcdefgh"[:n]), Spec(shape, ("data", "stage"), periods), name="toy")


def _state(ep) -> tuple:
    return (ep.generation, ep.dims, ep.pool.devices, ep.active.devices, ep.revoked,
            ep.pset_name)


def test_epoch_folds_leading_members():
    def case(Spec, Epoch, G, _err):
        ep = _toy(Spec, Epoch, G)
        return _state(ep) + (ep.axis_size("stage"),)

    got = _both(case)
    assert got[:4] == (0, (4, 2), tuple("abcdefgh"), tuple("abcdefgh"))
    assert got[5:] == ("repro://epoch/toy/0", 2)


def test_shrink_advances_generation_and_refolds():
    def case(Spec, Epoch, G, _err):
        ep = _toy(Spec, Epoch, G)
        ep1 = ep.shrink([3])   # rank 3 of the active group == member 'd'
        states = [_state(ep), _state(ep1)]
        ep2 = ep1.shrink(G("a"))
        return states + [_state(ep2)]

    ep, ep1, ep2 = _both(case)
    assert ep[4] and not ep1[4]
    assert ep1[:4] == (1, (3, 2), tuple("abcefgh"), tuple("abcefg"))
    assert ep2[1] == (3, 2) and len(ep2[2]) == 6 and ep2[5] == "repro://epoch/toy/2"


def test_grow_rejoins_and_expands():
    def case(Spec, Epoch, G, _err):
        ep = _toy(Spec, Epoch, G).shrink(["d"])
        ep2 = ep.grow(["d"])
        ep3 = ep2.grow(G([]))   # no new members: the generation advances
        return [_state(e) for e in (ep2, ep3)]

    ep2, ep3 = _both(case)
    assert ep2[:3] == (2, (4, 2), tuple("abcefgh") + ("d",))
    assert ep3[:3] == (3, (4, 2), ep2[2])


def test_revoked_epoch_rejects_fabric_access():
    def case(Spec, Epoch, G, _err):
        ep = _toy(Spec, Epoch, G)
        ep.revoke()
        ep.revoke()   # idempotent
        return [_error_name(f) for f in (lambda: ep.comm, lambda: ep.cached("x", lambda e: 1),
                                         ep._live)]

    assert _both(case) == ["ERR_REVOKED"] * 3


def test_no_survivors_is_proc_failed():
    def case(Spec, Epoch, G, _err):
        ep = Epoch(G("ab"), Spec((-1,), ("data",)), name="toy")
        return _error_name(lambda: ep.shrink(["a", "b"])), ep.revoked

    assert _both(case) == ("ERR_PROC_FAILED", True)


def test_cached_builds_lazily_once_per_epoch():
    def case(Spec, Epoch, G, _err):
        ep = _toy(Spec, Epoch, G)
        builds = []

        def build(e):
            builds.append(e.generation)
            return len(builds)

        out = [ep.peek("step"), ep.cached("step", build), ep.cached("step", build)]
        ep1 = ep.shrink([0])
        out += [ep1.peek("step"), ep1.cached("step", build)]
        ep1.invalidate("step")
        out += [ep1.cached("step", build), builds]
        return out

    assert _both(case) == [None, 1, 1, None, 2, 3, [0, 1, 1]]


def test_epoch_pvars_count_as_the_references():
    """The same transitions move the same ``epoch:*`` counters in both
    packages (registered with the same descriptions)."""

    for name in PVARS:
        assert tool.PVARS[name] == jtool.PVARS[name]

    def case(Spec, Epoch, G, _err):
        read = (jtool if Epoch is JCommEpoch else tool).pvar_read
        before = read()
        ep = _toy(Spec, Epoch, G)
        ep.cached("step", lambda e: 0)
        ep = ep.shrink([1]).grow(["b"])
        ep.cached("step", lambda e: 0)
        after = read()
        return {n: after.get(n, 0) - before.get(n, 0) for n in PVARS}

    assert _both(case) == {"epoch:create": 1, "epoch:advance": 2, "epoch:revoke": 2,
                           "epoch:rebuild": 0, "epoch:request_rebuild": 2}


# ---------------------------------------------------------------------------
# the fabric (the world of one: world-sized epochs)
# ---------------------------------------------------------------------------


def test_epoch_adopts_matching_communicator():
    jcomm, comm = jworld(refresh=True), world(refresh=True, device_type="cpu")
    jep, ep = JCommEpoch.create(jcomm, name="adopt"), CommEpoch.create(comm, name="adopt")
    assert ep.comm is comm and jep.comm is jcomm
    assert ep.dims == (comm.size(),) == jep.dims
    # the adopted communicator is the caller's: revoking the epoch leaves it
    ep.revoke()
    assert ep.destroyed == [] and comm.process_group() is not None


def test_epoch_builds_fabric_and_registers_pset():
    sides = []
    for Epoch, Spec, sess, read in (
            (JCommEpoch, JTopologySpec, jdefault_session(), jtool.pvar_read),
            (CommEpoch, TopologySpec, default_session(device_type="cpu"), tool.pvar_read)):
        g = sess.group("repro://world")
        before = read().get("epoch:rebuild", 0)
        ep = Epoch.create(g, Spec((-1,), ("data",)), name="fabric")
        comm = ep.comm
        assert ep.comm is comm   # built once
        assert sess.group(ep.pset_name).compare(ep.active).name != "UNEQUAL"
        sides.append((comm.size() == g.size(), ep.pset_name, comm.axis_names,
                      read()["epoch:rebuild"] - before))
    assert sides[0] == sides[1] == (True, "repro://epoch/fabric/0", ("data",), 1)


def test_epoch_cart_fabric():
    sides = []
    for Epoch, Spec, sess, CartComm in (
            (JCommEpoch, JTopologySpec, jdefault_session(), jtopology.CartComm),
            (CommEpoch, TopologySpec, default_session(device_type="cpu"), topology.CartComm)):
        ep = Epoch.create(sess.group("repro://world"), Spec((-1,), ("ring",), (True,)),
                          name="ring")
        cart = ep.comm
        assert isinstance(cart, CartComm)
        sides.append((cart.periods, cart.dims, ep.dims, cart.axis_names))
    assert sides[0] == sides[1] == ((True,), (1,), (1,), ("ring",))


def test_create_from_group_requires_spec():
    for Epoch, sess in ((JCommEpoch, jdefault_session()),
                        (CommEpoch, default_session(device_type="cpu"))):
        assert _error_name(lambda: Epoch.create(sess.group("repro://world"))) == "ERR_ARG"


def test_cart_refold_keeps_fixed_dims():
    sides = []
    for topo, sess, G in ((jtopology, jdefault_session(), JGroup),
                          (topology, default_session(device_type="cpu"), Group)):
        g = sess.group("repro://world")
        cart = topo.cart_create(g, (g.size(),), (True,), tag="repro://cart/refold0")
        ref = topo.cart_refold(cart, g, tag="repro://cart/refold1")
        sides.append((ref.dims == cart.dims, ref.periods == cart.periods, ref.axis_names,
                      _error_name(lambda: topo.cart_refold(cart, G()))))
    assert sides[0] == sides[1] == (True, True, ("cart0",), "ERR_DIMS")


def test_grad_sync_reinits_per_epoch():
    from repro.optim.grad_sync import PartitionedGradSync as JSync
    from repro_torch.optim.grad_sync import PartitionedGradSync

    for Epoch, Spec, Sync, sess in (
            (JCommEpoch, JTopologySpec, JSync, jdefault_session()),
            (CommEpoch, TopologySpec, PartitionedGradSync, default_session(device_type="cpu"))):
        ep = Epoch.create(sess.group("repro://world"), Spec((-1,), ("data",)), name="gs")
        sync = Sync.for_epoch(ep)
        assert sync.inner is ep.comm
        assert Sync.for_epoch(ep) is sync   # one per epoch
        ep1 = ep.grow([])
        assert _error_name(lambda: Sync.for_epoch(ep)) == "ERR_REVOKED"
        assert Sync.for_epoch(ep1) is not sync and Sync.for_epoch(ep1).inner is ep1.comm


@pytest.mark.parametrize("n", [1, 3])
def test_revoke_releases_cached_requests(n):
    """The port's revoke calls ``release()`` on each cached value (the
    trainer's step request drops its CUDA graph there) and empties the
    cache; values without one are dropped as they are."""

    class Held:
        released = 0

        def release(self):
            Held.released += 1

    ep = CommEpoch(Group("abc"), TopologySpec((-1,), ("data",)), name="rel")
    for i in range(n):
        ep.cached(f"req{i}", lambda e: Held())
    ep.cached("plain", lambda e: 0)
    ep.grow([])
    assert Held.released == n and ep.peek("req0") is None and ep.peek("plain") is None
