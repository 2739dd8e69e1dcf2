"""Unified model API: ``build(cfg)`` returns a :class:`ModelBundle` with
init / loss / prefill / decode entry points, for every family of the
reference: ``dense``, ``moe`` and ``vlm`` (the transformer trunk), ``ssm``,
``hybrid`` and ``encdec``; another family raises ``ERR_UNSUPPORTED_OPERATION``.
The loss, prefill and decode entry points run under DTensor's implicit
replication (:func:`repro_torch.sharding.local.implicit_replication`), so
that on placed parameters the plain tensors they make (positions, masks,
indices) count as replicated."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core import errors
from repro_torch.models import encdec, ssm_lm, transformer
from repro_torch.sharding.local import replicating


@dataclasses.dataclass
class ModelBundle:
    cfg: Any
    init: Callable                  # (generator) -> params on generator.device
    loss: Callable                  # (params, batch, pcfg, mesh) -> (loss, metrics)
    prefill: Callable               # (params, batch, pcfg, mesh) -> (logits, cache)
    decode: Callable                # (params, cache, token, pcfg, mesh) -> (logits, cache)
    init_cache: Callable | None     # (pcfg, batch, length, device) -> cache


def build(cfg) -> ModelBundle:
    bundle = _build(cfg)
    # (params, batch, pcfg, ...) and (params, cache, token, pcfg, ...)
    return dataclasses.replace(bundle, loss=replicating(bundle.loss, 1),
                               prefill=replicating(bundle.prefill, 1),
                               decode=replicating(bundle.decode, 2))


def _build(cfg) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
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
    if fam == "ssm":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen: ssm_lm.init_ssm_lm(gen, cfg),
            loss=lambda p, b, pc, mesh=None: ssm_lm.ssm_lm_loss(p, b, cfg, pc, mesh),
            prefill=lambda p, b, pc, mesh=None, extra_capacity=0: ssm_lm.ssm_lm_prefill(
                p, b, cfg, pc, mesh, extra_capacity=extra_capacity
            ),
            decode=lambda p, c, t, pc, mesh=None: ssm_lm.ssm_lm_decode(p, c, t, cfg, pc, mesh),
            init_cache=lambda pc, batch, length, device=None: ssm_lm.SSMCache.init(
                cfg.num_layers, batch, cfg, device=device
            ),
        )
    if fam == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen: ssm_lm.init_hybrid_lm(gen, cfg),
            loss=lambda p, b, pc, mesh=None: ssm_lm.hybrid_lm_loss(p, b, cfg, pc, mesh),
            prefill=lambda p, b, pc, mesh=None, extra_capacity=0: ssm_lm.hybrid_lm_prefill(
                p, b, cfg, pc, mesh, extra_capacity=extra_capacity
            ),
            decode=lambda p, c, t, pc, mesh=None: ssm_lm.hybrid_lm_decode(
                p, c, t, cfg, pc, mesh
            ),
            init_cache=lambda pc, batch, length, device=None: ssm_lm.init_hybrid_cache(
                cfg, pc, batch, length, device
            ),
        )
    if fam == "encdec":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen: encdec.init_encdec(gen, cfg),
            loss=lambda p, b, pc, mesh=None: encdec.encdec_loss(p, b, cfg, pc, mesh),
            prefill=lambda p, b, pc, mesh=None, extra_capacity=0: encdec.encdec_prefill(
                p, b, cfg, pc, mesh, extra_capacity=extra_capacity
            ),
            decode=lambda p, c, t, pc, mesh=None: encdec.encdec_decode(p, c, t, cfg, pc, mesh),
            init_cache=None,  # built by prefill (cross-attention needs the encoder length)
        )
    errors.fail(
        errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
        f"model family {fam!r} ({cfg.name}) is not a family of the reference; "
        f"the port serves the dense, moe, vlm, ssm, hybrid and encdec families",
    )
