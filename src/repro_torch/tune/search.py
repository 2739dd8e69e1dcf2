"""Search strategies over the legal plan space — :mod:`repro.tune.search`.

Two modes, both deterministic:

* ``exhaustive`` — score every legal plan, return the minimum.  The space
  is small (hundreds of candidates at single-host device counts), scoring
  is closed-form arithmetic, and the minimum is the *definition* of the
  right answer — so brute force is the default, not the fallback.
* ``coordinate`` — greedy coordinate descent: start from the pure data
  plan and sweep one axis at a time (stage, ring, tensor/expert,
  microbatches, buckets, remat, dcn), taking the best candidate that
  differs from the incumbent only on that axis, until a full sweep changes
  nothing.  O(axes · values · sweeps) scores instead of the full product —
  the mode a much larger space would need.  The tests hold its score to
  the exhaustive minimum or above.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    ModelConfig,
    ParallelPlan,
    PlanSpace,
    ShapeConfig,
    legal_plans,
)
from repro_torch.core import errors, tool
from repro_torch.tune.score import Score, score_plan

tool.pvar_register("tune:candidates", "legal plans enumerated per tuner run")
tool.pvar_register("tune:scored", "plans scored by the roofline model")
tool.pvar_register(
    "tune:winner_registered",
    "winning plans whose repro://cart/<dims> pset was registered",
)

#: the axes coordinate descent sweeps, in sweep order.  ``data`` is never a
#: coordinate — it is derived (the elastic fill of the device count).  The
#: whole fabric is ONE coordinate: stage/ring/tensor are mutually exclusive
#: folds, so moving between them is a multi-field step a per-field sweep
#: could never take (stage=4 → tensor=4 changes two fields at once).  The
#: remat mode rides along too — which fabric wins depends on whether its
#: memory pressure can be paid in recompute (ring + rm-none vs tp + rm-full
#: are genuinely coupled choices).
_COORDS = (
    ("stage", "ring", "tensor", "expert", "microbatches", "remat"),
    ("microbatches",),
    ("grad_buckets",),
    ("remat",),
    ("dcn_axis",),
)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """The tuner's verdict for one (arch × shape × devices) cell."""

    plan: ParallelPlan
    score: Score
    mode: str
    n_candidates: int
    n_scored: int
    table: tuple[tuple[str, float], ...]   # top candidates, (slug, step_s)

    def as_dict(self) -> dict:
        return {
            "plan": dataclasses.asdict(self.plan),
            "slug": self.plan.slug(),
            "cart_pset": self.plan.cart_pset,
            "score": self.score.as_dict(),
            "mode": self.mode,
            "n_candidates": self.n_candidates,
            "n_scored": self.n_scored,
            "table": [list(row) for row in self.table],
        }


def _rank_key(scored: tuple[ParallelPlan, Score]) -> tuple[float, str]:
    plan, sc = scored
    return (sc.step_s, plan.slug())


def search(
    cfg: ModelConfig,
    shape: ShapeConfig,
    devices: int,
    *,
    space: PlanSpace | None = None,
    slices: int = 1,
    mode: str = "exhaustive",
    default_remat: str = "full",
    calibration: dict | None = None,
    top: int = 5,
) -> TuneResult:
    """Pick the best legal plan for the cell.  Deterministic: a fixed
    (config, shape, devices, space, calibration) tuple always returns the
    same plan — ties break on the plan slug, never enumeration order."""

    errors.check(
        mode in ("exhaustive", "coordinate"),
        errors.ErrorClass.ERR_ARG,
        f"unknown search mode {mode!r} (exhaustive | coordinate)",
    )
    candidates = legal_plans(cfg, shape, devices, space, slices=slices)
    errors.check(
        len(candidates) > 0,
        errors.ErrorClass.ERR_TOPOLOGY,
        f"no legal plan for {cfg.name} x {shape.name} on {devices} devices",
    )
    tool.pvar_add("tune:candidates", len(candidates))

    def sc(plan: ParallelPlan) -> Score:
        tool.pvar_count("tune:scored")
        return score_plan(
            cfg, shape, plan,
            default_remat=default_remat, calibration=calibration,
        )

    if mode == "exhaustive":
        scored = sorted(((p, sc(p)) for p in candidates), key=_rank_key)
        n_scored = len(scored)
    else:
        scored, n_scored = _coordinate(candidates, sc)
    best_plan, best_score = scored[0]
    table = tuple((p.slug(), s.step_s) for p, s in scored[:top])
    return TuneResult(
        plan=best_plan,
        score=best_score,
        mode=mode,
        n_candidates=len(candidates),
        n_scored=n_scored,
        table=table,
    )


def _coordinate(candidates, sc):
    """Greedy coordinate descent over the candidate list; returns the
    visited plans ranked, plus how many scores it actually paid for."""

    def value(plan, fields):
        return tuple(getattr(plan, f) for f in fields)

    all_fields = [f.name for f in dataclasses.fields(ParallelPlan)]
    cache: dict[ParallelPlan, Score] = {}

    def cached(plan):
        if plan not in cache:
            cache[plan] = sc(plan)
        return cache[plan]

    # the starting incumbent: the most "plain" candidate (pure data fill if
    # it is legal, else the lexically first slug)
    current = min(candidates, key=lambda p: (p.fixed_size, p.slug()))
    cached(current)
    for _sweep in range(8):
        changed = False
        for coord in _COORDS:
            frozen = [
                f for f in all_fields if f not in coord and f != "data"
            ]
            peers = [
                p for p in candidates
                if value(p, frozen) == value(current, frozen)
            ]
            best = min(peers, key=lambda p: (cached(p).step_s, p.slug()))
            if best != current and cached(best).step_s < cached(current).step_s:
                current = best
                changed = True
        if not changed:
            break
    ranked = sorted(cache.items(), key=_rank_key)
    return ranked, len(cache)
