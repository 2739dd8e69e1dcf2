"""Unified model API: ``build(cfg)`` returns a :class:`ModelBundle` with
init / loss / prefill / decode entry points.  Only the dense family is
ported; the other families raise ``ERR_UNSUPPORTED_OPERATION``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core import errors
from repro_torch.models import transformer


@dataclasses.dataclass
class ModelBundle:
    cfg: Any
    init: Callable                  # (generator) -> params on generator.device
    loss: Callable                  # (params, batch, pcfg, mesh) -> (loss, metrics)
    prefill: Callable               # (params, batch, pcfg, mesh) -> (logits, cache)
    decode: Callable                # (params, cache, token, pcfg, mesh) -> (logits, cache)
    init_cache: Callable | None     # (pcfg, batch, length, device) -> cache


def build(cfg) -> ModelBundle:
    errors.check(
        cfg.family == "dense",
        errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
        f"model family {cfg.family!r} ({cfg.name}) is not ported yet; the port "
        f"serves the dense family",
    )
    return ModelBundle(
        cfg=cfg,
        init=lambda gen: transformer.init_lm(gen, cfg),
        loss=lambda p, b, pc, mesh=None: transformer.lm_loss(p, b, cfg, pc, mesh),
        prefill=lambda p, b, pc, mesh=None, extra_capacity=0: transformer.lm_prefill(
            p, b, cfg, pc, mesh, extra_capacity=extra_capacity
        ),
        decode=lambda p, c, t, pc, mesh=None: transformer.lm_decode(p, c, t, cfg, pc, mesh),
        init_cache=lambda pc, batch, length, device=None: transformer.init_cache(
            cfg, pc, batch, length, device
        ),
    )
