"""Host communicators, session-derived.

Construction is session-first, as in :mod:`repro.launch.mesh`: open (or take)
a :class:`~repro_torch.core.session.Session`, pick a named process set, fold
its leading ``data × model`` ranks of the process world onto a ("data",
"model") grid through ``Communicator.from_group`` — the reference folds
``jax.devices()`` the same way.  ``device`` picks the session's device
type; it defaults to ``cuda`` and a machine without one raises
``ERR_SESSION``.  Every rank calls it alike (it creates process groups).
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
