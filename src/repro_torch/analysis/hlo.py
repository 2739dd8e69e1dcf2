"""Reusable predicate passes over a step's program — layer 2 of the
analyzer, :mod:`repro.analysis.hlo` for the port.

Each pass takes a program and returns a :class:`PassResult` with the
evidence, so scripts and tests assert the *same* predicate: no all-gathers,
``N − 1`` permutes, ``1/N`` wire fractions, identical lowerings.

**Port-only choice: recorded programs in place of compiled modules.**  The
reference's passes read the HLO text of an XLA executable.  The port's read
a **recorded program**: the ops one run of a step dispatched on one rank
(:mod:`repro_torch.core.hloanalysis`, whose text keeps the reference's
collective kinds).  Every pass accepts a program's text, a
:class:`~repro_torch.core.hloanalysis.Program`, or anything with
``as_text()`` (a :class:`~repro_torch.core.futures.PersistentRequest`, a
``PersistentCollective``, a ``Trainer``'s step request).
:func:`record_program` stands in for ``jax.jit(fn).lower(x).compile()``: it
runs ``fn`` once and returns its program.  A program is one rank's: a pass
holds that rank's schedule (an open end of a line of ranks sends less
than its neighbours).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import errors
from repro_torch.core.hloanalysis import Program, analyze_hlo, record
from repro_torch.core.tool import CollectiveStats


@dataclasses.dataclass(frozen=True)
class PassResult:
    """One predicate verdict: the claim, whether it holds, and the measured
    evidence backing it."""

    name: str
    ok: bool
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __bool__(self) -> bool:
        return self.ok

    def __str__(self) -> str:
        state = "ok" if self.ok else "FAIL"
        return f"{self.name}: {state} {self.detail}"


def _text(module: Any) -> str:
    if isinstance(module, str):
        return module
    as_text = getattr(module, "as_text", None)
    errors.check(callable(as_text), errors.ErrorClass.ERR_ARG,
                 f"a pass reads a recorded program, its text or an object with as_text(); "
                 f"got {type(module).__name__}")
    return as_text()


def record_program(fn, *args: Any, **kwargs: Any) -> Program:
    """The program of one run of ``fn(*args, **kwargs)`` on this rank (its
    outputs are dropped).  Collective when ``fn`` communicates: every rank
    calls it, as every rank runs a step."""

    return record(fn, *args, **kwargs)[1]


def collective_stats(module: Any) -> CollectiveStats:
    """The collective stats of one program (flat: no trip counts to
    correct)."""

    return analyze_hlo(_text(module)).collectives


def stats_dict(module: Any) -> dict[str, Any]:
    """The (counts, operand bytes, wire bytes) summary row — two programs
    lower identically iff these compare equal."""

    s = collective_stats(module)
    return {
        "counts": dict(s.count),
        "operand_bytes": s.total_operand_bytes,
        "wire_bytes": s.total_wire_bytes,
    }


def no_collective(module: Any, *kinds: str) -> PassResult:
    """No collective of any of ``kinds`` appears (e.g. prove a sharded
    schedule never materialises via ``all-gather``)."""

    s = collective_stats(module)
    present = {k: s.count[k] for k in kinds if s.count.get(k, 0)}
    return PassResult(
        "no-collective", not present,
        {"forbidden": kinds, "present": present},
    )


def collective_count(module: Any, kind: str, expected: int) -> PassResult:
    """Exactly ``expected`` collectives of ``kind``."""

    s = collective_stats(module)
    got = int(s.count.get(kind, 0))
    return PassResult(
        "collective-count", got == expected,
        {"kind": kind, "expected": expected, "got": got},
    )


def permute_count(module: Any, expected: int) -> PassResult:
    """Exactly ``expected`` ``collective-permute`` ops (each a send of this
    rank) — the round count of a ring/halo schedule."""

    res = collective_count(module, "collective-permute", expected)
    return PassResult("permute-count", res.ok, res.detail)


def wire_fraction_below(
    module: Any, dense: Any, bound: float, *, name: str = "wire-fraction"
) -> PassResult:
    """Wire bytes of ``module`` are at most ``bound`` × those of the dense
    reference — the sparsity proof for neighborhood collectives."""

    mw = collective_stats(module).total_wire_bytes
    dw = collective_stats(dense).total_wire_bytes
    frac = (mw / dw) if dw else None
    return PassResult(
        name, frac is not None and frac <= bound,
        {"wire_bytes": mw, "dense_wire_bytes": dw,
         "fraction": frac, "bound": bound},
    )


def neighbor_sparsity(module: Any, dense: Any, *, max_fraction: float = 1.0) -> PassResult:
    """A neighborhood collective lowered *sparse*: point-to-point permutes
    only — zero dense ``all-to-all``/``all-reduce`` — with wire bytes
    scaling with the topology degree, not world size."""

    s = collective_stats(module)
    sparse = (
        s.count.get("all-to-all", 0) == 0
        and s.count.get("all-reduce", 0) == 0
        and s.count.get("collective-permute", 0) > 0
    )
    wf = wire_fraction_below(module, dense, max_fraction)
    return PassResult(
        "neighbor-sparsity", sparse and wf.ok,
        {"counts": dict(s.count), "sparse": sparse, **wf.detail},
    )


def ring_schedule(
    module: Any, n: int, *, shard_bytes: float | None = None, tol: float = 1e-9
) -> PassResult:
    """The ring-attention schedule proof: exactly ``n − 1`` permutes, zero
    KV all-gathers, and (when ``shard_bytes`` — the *global* rotated
    aggregate, e.g. K+V — is given) a per-step wire fraction of ``1/n``:
    each step moves one shard of the aggregate."""

    s = collective_stats(module)
    permutes = int(s.count.get("collective-permute", 0))
    allgathers = int(s.count.get("all-gather", 0))
    per_step_fraction = None
    fraction_ok = True
    if shard_bytes:
        per_step_fraction = s.total_wire_bytes / max(permutes, 1) / shard_bytes
        fraction_ok = abs(per_step_fraction - 1.0 / n) < tol
    return PassResult(
        "ring-schedule",
        permutes == n - 1 and allgathers == 0 and fraction_ok,
        {"permutes": permutes, "expected_permutes": n - 1,
         "kv_allgathers": allgathers,
         "per_step_wire_fraction": per_step_fraction},
    )


def identical_lowering(a: Any, b: Any) -> PassResult:
    """Two programs make the same collectives — the zero-overhead parity
    claim (kinds, counts, payload and wire bytes all equal)."""

    sa, sb = stats_dict(a), stats_dict(b)
    return PassResult("identical-lowering", sa == sb, {"a": sa, "b": sb})


def pvar_invariant(
    counters: dict[str, Any], name: str, expected: int
) -> PassResult:
    """A ``trace:*`` pvar invariant: the counter must read exactly
    ``expected`` (e.g. ``trace:train_step == 1`` — one step built, ever)."""

    got = int(counters.get(name, 0))
    return PassResult(
        "pvar-invariant", got == expected,
        {"pvar": name, "expected": expected, "got": got},
    )
