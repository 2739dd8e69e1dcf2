"""``repro_torch.tune`` — the roofline-driven parallelism autotuner of
:mod:`repro.tune`, over the port's hardware model (an NVIDIA H100).

The system, not the user, chooses the cart fold: enumerate the legal 4-axis
layout space (data × stage × expert/ring × tensor, plus microbatches,
grad-sync buckets and remat) for an (architecture × input shape × device
count) cell, score every candidate with the deterministic roofline model
(:mod:`repro_torch.tune.score`, over the constants of
:mod:`repro_torch.core.tool`), and emit the winner as a frozen
:class:`~repro_torch.configs.base.ParallelPlan`:

>>> from repro_torch import tune
>>> result = tune.tune("gemma2_9b", "train_4k", device_type="cpu")
>>> result.plan                      # doctest: +SKIP
ParallelPlan(data=1, ...)

The winning plan is what the rest of the stack consumes — the trainer folds
it (``TrainerConfig(plan=...)``), the launch CLIs resolve ``--plan auto``
through this module, and the session records it: :func:`tune` registers
the winner's topology as a ``repro://cart/<dims>`` process set, interleaved
across ``repro://slice/<k>`` boundaries when the plan names a ``dcn_axis``
(on the port a slice is a host of a multi-host world, see
:mod:`repro_torch.core.session`).

Offline and hardware-free: scoring is closed-form, and the CLI
(``python -m repro_torch.tune --arch gemma2_9b --shape train_4k``) runs in
a second.  The session it registers the winner in is the default session
of ``device_type`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401  (public API re-exports)
    SHAPES,
    ParallelPlan,
    PlanSpace,
    ShapeConfig,
    legal_plans,
    parse_plan,
    plan_space,
)
from repro_torch.core import errors, tool
from repro_torch.core.session import Group, Session, default_session
from repro_torch.tune.score import (  # noqa: F401
    Score,
    load_calibration,
    predicted_vs_measured,
    score_plan,
)
from repro_torch.tune.search import TuneResult, search  # noqa: F401

_SLICE_PREFIX = "repro://slice/"


def fold_group(session: Session, plan: ParallelPlan) -> Group:
    """The device group for ``plan``'s fold, in fold (row-major) order.

    Single-slice sessions — or plans without a ``dcn_axis`` — take the
    leading ``plan.total_devices`` world devices.  When the plan names a
    ``dcn_axis`` and the session reports multiple ``repro://slice/<k>``
    sets, the devices are interleaved so that axis is split into one
    contiguous block per slice: neighbours along every *other* axis stay
    inside a slice (ICI), and only the chosen axis crosses DCN.
    """

    n = plan.total_devices
    world = session.group()
    errors.check(
        world.size() >= n,
        errors.ErrorClass.ERR_GROUP,
        f"plan {plan.slug()!r} needs {n} devices; session has {world.size()}",
    )
    slice_names = sorted(
        p for p in session.psets() if p.startswith(_SLICE_PREFIX)
    )
    if plan.dcn_axis is None or len(slice_names) < 2:
        return world.incl(range(n))
    k = len(slice_names)
    dims, axes = plan.fold_dims(), plan.fold_axes()
    a = axes.index(plan.dcn_axis)
    errors.check(
        dims[a] % k == 0,
        errors.ErrorClass.ERR_TOPOLOGY,
        f"dcn axis {plan.dcn_axis!r} of extent {dims[a]} does not split "
        f"over {k} slices",
    )
    per_slice = n // k
    pools = [list(session.pset(nm)) for nm in slice_names]
    for nm, pool in zip(slice_names, pools):
        errors.check(
            len(pool) >= per_slice,
            errors.ErrorClass.ERR_GROUP,
            f"slice pset {nm!r} has {len(pool)} devices; the fold needs "
            f"{per_slice} per slice",
        )
    devices = []
    for flat in range(n):
        # the row-major coordinate along the dcn axis decides the owning slice
        coord = _unravel(flat, dims)
        devices.append(pools[coord[a] * k // dims[a]].pop(0))
    return Group(devices)


def _trailing(dims, i):
    out = 1
    for d in dims[i + 1:]:
        out *= d
    return out


def _unravel(flat: int, dims) -> tuple[int, ...]:
    coord = []
    for i in range(len(dims)):
        t = _trailing(dims, i)
        coord.append((flat // t) % dims[i])
    return tuple(coord)


def tune(
    arch: str,
    shape: str | ShapeConfig = "train_4k",
    devices: int | None = None,
    *,
    slices: int | None = None,
    mode: str = "exhaustive",
    space: PlanSpace | None = None,
    calibrate: bool = True,
    register: bool = True,
    session: Session | None = None,
    top: int = 5,
    config=None,
    device_type: str = "cuda",
) -> TuneResult:
    """Tune one (arch × shape × device count) cell and return the
    :class:`~repro.tune.search.TuneResult`.

    ``devices`` defaults to the session world size (the count the winner's
    pset can actually be registered over); ``slices`` defaults to the
    session's ``repro://slice/<k>`` count.  ``register=False`` skips the
    pset side effect (pure scoring, e.g. for the regret bench).  ``config``
    overrides the arch's :class:`ModelConfig` (the smoke-config launchers
    tune the model they actually run).  Without ``session``, the default
    session of ``device_type``.
    """

    from repro_torch.configs import base

    cfg = config if config is not None else base.get_config(arch)
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    sess = session if session is not None else default_session(device_type=device_type)
    if devices is None:
        devices = sess.group().size()
    if slices is None:
        slices = max(
            1, sum(1 for p in sess.psets() if p.startswith(_SLICE_PREFIX))
        )
    result = search(
        cfg,
        shp,
        devices,
        space=space if space is not None else plan_space(arch),
        slices=slices,
        mode=mode,
        default_remat=base.get_parallel(arch).remat,
        calibration=load_calibration(arch, shp.name) if calibrate else None,
        top=top,
    )
    if register and result.plan.total_devices <= sess.group().size():
        sess.register_pset(result.plan.cart_pset, fold_group(sess, result.plan))
        tool.pvar_count("tune:winner_registered")
    return result
