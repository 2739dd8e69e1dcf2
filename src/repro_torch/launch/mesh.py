"""Production and host communicators, session-derived.

Construction is session-first, as in :mod:`repro.launch.mesh`: open (or take)
a :class:`~repro_torch.core.session.Session`, pick a named process set, fold
its leading ``data × model`` ranks of the process world onto a ("data",
"model") grid through ``Communicator.from_group`` — the reference folds
``jax.devices()`` the same way.  ``device`` picks the session's device
type; it defaults to ``cuda`` and a machine without one raises
``ERR_SESSION``.  Every rank calls it alike (it creates process groups).

The production grids are the reference's, so that a dry-run artifact's
name (``pod_16x16``, ``multipod_2x16x16``) is the one
:func:`repro_torch.tune.load_calibration` reads:

* single-pod:  (16, 16)        axes ("data", "model") — 256 ranks
* multi-pod:   (2, 16, 16)     axes ("pod", "data", "model") — 512 ranks

They are folded over the session's world, which in the dry run is a fake
process group of 256 or 512 ranks in one process
(:mod:`repro_torch.launch.dryrun`; the session reads it as it reads any
default group).  **What the grid means on H100s** (port-only): a node holds
eight cards joined by NVLink, so a model axis of 16 spans two nodes and
half of each tensor-parallel exchange crosses the NIC (``DCN_BANDWIDTH``,
50 GB/s a card) rather than NVLink (``ICI_BANDWIDTH``, 450 GB/s).  The dry
run charges every collective at ``ICI_BANDWIDTH``, as the reference charges
its TPU torus: on this grid its collective term flatters the H100 cluster.
"""

from __future__ import annotations


def make_host_communicator(
    data: int | None = None,
    model: int = 1,
    *,
    pset: str = "repro://world",
    session=None,
    device: str | None = None,
):
    """A small communicator over a process set of ``device`` (``"cuda"``
    unless ``"cpu"`` is asked for)."""

    from repro_torch.core import errors
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.session import default_session

    if session is None:
        session = default_session(device_type=device or "cuda")
    g = session.group(pset)
    if data is None:
        data = g.size() // model
    errors.check(
        data >= 1 and data * model <= g.size(),
        errors.ErrorClass.ERR_DIMS,
        f"grid {data}x{model} needs {max(data, 1) * model} devices but pset "
        f"{pset!r} holds {g.size()}",
    )
    return Communicator.from_group(
        g.incl(range(data * model)),
        tag=pset,
        shape=(data, model),
        axis_names=("data", "model"),
    )


#: the reference's production grids: (shape, axis names, artifact mesh name)
PRODUCTION_GRIDS = {
    False: ((16, 16), ("data", "model"), "pod_16x16"),
    True: ((2, 16, 16), ("pod", "data", "model"), "multipod_2x16x16"),
}


def make_host_mesh(data: int | None = None, model: int = 1, *, device: str | None = None):
    """A small mesh over whatever devices exist (tests / examples / benches):
    the ``DeviceMesh`` of :func:`make_host_communicator`'s communicator (the
    reference returns its ``jax.sharding.Mesh``) on ``device``'s ranks."""

    return make_host_communicator(data, model, device=device).device_mesh


def make_production_communicator(*, multi_pod: bool = False, session=None,
                                  device: str | None = None):
    """The production communicator: the session's world folded onto the pod
    grid (``ERR_DIMS`` if the world is smaller)."""

    import math

    from repro_torch.core import errors
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.session import default_session

    if session is None:
        session = default_session(device_type=device or "cuda")
    shape, axes, _ = PRODUCTION_GRIDS[bool(multi_pod)]
    world = session.group("repro://world")
    n = math.prod(shape)
    errors.check(
        n <= world.size(),
        errors.ErrorClass.ERR_DIMS,
        f"production topology {shape} needs {n} devices but the platform "
        f"holds {world.size()}",
    )
    return Communicator.from_group(
        world.incl(range(n)), tag="repro://production", shape=shape, axis_names=axes
    )


def make_production_mesh(*, multi_pod: bool = False, session=None, device: str | None = None):
    """The production communicator's ``DeviceMesh``."""

    return make_production_communicator(multi_pod=multi_pod, session=session,
                                        device=device).device_mesh
