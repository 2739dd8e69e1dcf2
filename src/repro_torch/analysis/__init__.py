"""Communication-correctness analysis for the port's interface (the MUST /
MPI-Checker role), :mod:`repro.analysis` for the port: an event-graph lint
over per-rank ledgers, surfaced through ``python -m
repro_torch.analysis.lint``.

* :mod:`repro_torch.analysis.events` — the recording ledger (guarded by the
  ``analysis_recording`` cvar, off by default), one a rank, with
  :func:`~repro_torch.analysis.events.merge` for a run's ledger files.
* :mod:`repro_torch.analysis.checkers` — event-graph checkers: collective
  order/signature matching, deadlock detection on the point-to-point
  matching graph, future/request lifecycle, RMA epoch discipline, I/O
  joins.  Findings carry typed :class:`~repro_torch.core.errors.ErrorClass`.
* :mod:`repro_torch.analysis.hlo` — predicate passes over a step's
  recorded program (no-collective, permute counts, wire fractions, ring
  schedules, identical lowerings), in place of the reference's compiled
  modules.
* :mod:`repro_torch.analysis.static` — source meta-checks (swallowed
  failures, unregistered pvars).

Only the ledger is imported eagerly (it is import-light by design); the
checker and pass layers import on demand so the core interface does not
pay for them.
"""

from repro_torch.analysis import events

__all__ = ["events"]
