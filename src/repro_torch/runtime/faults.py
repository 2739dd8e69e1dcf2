"""Fault tolerance policies: failure injection, straggler mitigation, and
the restart protocol — testable on one host, designed for 1000+ nodes.

At production scale the runtime wraps every step in :class:`StepGuard`:

* **failure detection** — on a real cluster a device failure surfaces as an
  XLA error or a missed heartbeat; here :class:`FaultInjector` raises the
  same exception types on schedule so the recovery path is exercised in CI;
* **recovery** — the ``Trainer`` catches :class:`WorkerFailure`, re-forms the
  mesh over the survivors (elastic) or the replacement set, restores the
  newest complete checkpoint, and replays the data stream (stateless loader:
  nothing to replay but the step counter);
* **straggler mitigation** — each step is timed; steps slower than
  ``deadline_factor ×`` a robust running estimate (median of recent steps)
  mark the step "straggled".  On TPU pods the standard mitigation is
  re-dispatch of the same program (the input is deterministic), which is
  what :meth:`StragglerPolicy.should_retry` gates.  A persistent straggler
  triggers the failure path (treat-as-failed), matching production practice.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

from repro_torch.core import tool

tool.pvar_register("elastic:evictions", "ranks evicted by the fault injector")
tool.pvar_register("elastic:joins", "ranks hot-joined into a grown epoch")


class WorkerFailure(RuntimeError):
    """A (possibly injected) unrecoverable worker/device failure."""


class RankEvicted(WorkerFailure):
    """A *specific* rank died (ULFM ``MPI_ERR_PROC_FAILED`` analogue): the
    elastic recovery path shrinks the epoch to the survivors instead of
    restarting the whole job."""

    def __init__(self, step: int, rank: int):
        super().__init__(f"injected eviction of rank {rank} at step {step}")
        self.step = step
        self.rank = rank


@dataclasses.dataclass
class FaultInjector:
    """Deterministic failure schedule.

    * ``fail_at_steps`` — raise ``kind`` at those step numbers (device /
      worker failures; each fires once).
    * ``fail_fragments`` — raise ``OSError`` when a checkpoint fragment
      whose name contains one of these substrings is about to be written
      (each pattern fires once).  This is the torn-save injection: the
      background save must surface the error as ``ERR_IO`` from
      ``CheckpointManager.wait()`` and ``latest`` must not advance — a
      silently "successful" failed save is the defect this exists to catch.
    * ``evict_rank(step, rank)`` — raise :class:`RankEvicted` for that rank
      at that step (fires once): the ULFM shrink path.  Deterministic by
      construction — schedules key on the step counter, and the trainer's
      ``StepGuard.clock`` is frozen in elastic tests, so the same schedule
      replays bit-identically.
    * ``admit_rank(step, count)`` — offer ``count`` new ranks at that step
      (consumed once via :meth:`take_admissions`): the grow path.  Not an
      exception — joining is voluntary, the trainer polls.
    """

    fail_at_steps: tuple[int, ...] = ()
    kind: type[Exception] = WorkerFailure
    fail_fragments: tuple[str, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)
    _evictions: dict = dataclasses.field(default_factory=dict)
    _admissions: dict = dataclasses.field(default_factory=dict)

    def evict_rank(self, step: int, rank: int) -> "FaultInjector":
        """Schedule rank ``rank`` to die at step ``step``."""

        self._evictions[int(step)] = int(rank)
        return self

    def admit_rank(self, step: int, count: int = 1) -> "FaultInjector":
        """Schedule ``count`` new ranks to offer themselves at ``step``."""

        self._admissions[int(step)] = self._admissions.get(int(step), 0) + int(count)
        return self

    def take_admissions(self, step: int) -> int:
        """Consume (once) the number of ranks joining at this step."""

        key = ("admit", step)
        if step in self._admissions and key not in self._fired:
            self._fired.add(key)
            return self._admissions[step]
        return 0

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise self.kind(f"injected worker failure at step {step}")
        key = ("evict", step)
        if step in self._evictions and key not in self._fired:
            self._fired.add(key)
            tool.pvar_count("elastic:evictions")
            raise RankEvicted(step, self._evictions[step])

    def check_io(self, fragment: str) -> None:
        """Fragment-write hook (wired as ``File.write_hook``)."""

        for pattern in self.fail_fragments:
            key = ("io", pattern)
            if pattern in fragment and key not in self._fired:
                self._fired.add(key)
                raise OSError(
                    f"injected fragment-write fault on {fragment!r} "
                    f"(pattern {pattern!r})"
                )


@dataclasses.dataclass
class StragglerPolicy:
    """Step-deadline straggler detection + bounded re-dispatch."""

    deadline_factor: float = 3.0
    window: int = 32
    max_retries: int = 1
    min_samples: int = 5
    _history: deque = dataclasses.field(default_factory=deque)

    def __post_init__(self):
        # the history bound IS the configured window (it was silently
        # hardcoded to 32 before, making the field dead config)
        self._history = deque(self._history, maxlen=self.window)

    def observe(self, duration_s: float) -> None:
        self._history.append(duration_s)

    def median(self) -> float | None:
        if len(self._history) < self.min_samples:
            return None
        s = sorted(self._history)
        return s[len(s) // 2]

    def is_straggler(self, duration_s: float) -> bool:
        med = self.median()
        return med is not None and duration_s > self.deadline_factor * med

    def should_retry(self, attempts: int) -> bool:
        return attempts <= self.max_retries


@dataclasses.dataclass
class StepGuard:
    """Times one step, applies straggler policy, surfaces failures.

    ``clock`` is the injectable time source (``time.perf_counter`` in
    production).  Tests inject a fake clock advanced by the step function
    itself, so straggler behaviour is asserted deterministically — no
    wall-clock sleeps, no timing margins for a loaded CI machine to blow
    through.  :class:`StragglerPolicy` itself is already clock-free (it
    only ever sees durations).
    """

    straggler: StragglerPolicy
    injector: FaultInjector | None = None
    clock: Callable[[], float] = time.perf_counter

    def run(
        self,
        step: int,
        fn: Callable[[], object],
        *,
        retry_safe: bool = True,
        exempt: bool = False,
    ) -> tuple[object, dict]:
        """Run one step under the policy.

        ``retry_safe=False`` declares that ``fn`` cannot be re-dispatched
        with the same inputs — the persistent-step path donates its
        params/opt-state buffers, which a second dispatch would read after
        free.  A straggler then goes straight to the failure path
        (treat-as-failed → restore from checkpoint), the production practice
        for donated step buffers.

        ``exempt=True`` declares known interference — a background
        checkpoint save is stealing cycles from this step — so a slow step
        is *not* marked a straggler (it is not evidence of a sick worker)
        and its polluted duration is kept out of the running median.
        """

        attempts = 0
        while True:
            attempts += 1
            t0 = self.clock()
            if self.injector is not None:
                self.injector.check(step)
            out = fn()
            dt = self.clock() - t0
            if exempt:
                return out, {"duration_s": dt, "attempts": attempts, "straggled": False}
            straggled = self.straggler.is_straggler(dt)
            if straggled and retry_safe and self.straggler.should_retry(attempts):
                continue  # re-dispatch the same deterministic step
            if straggled:
                raise WorkerFailure(
                    f"step {step} straggled {attempts}x (last {dt:.3f}s, "
                    f"median {self.straggler.median():.3f}s)"
                )
            self.straggler.observe(dt)
            return out, {"duration_s": dt, "attempts": attempts, "straggled": straggled}
