"""Unified model API: ``build(cfg)`` returns a :class:`ModelBundle` with
init / loss / prefill / decode entry points, for every family of the
reference: ``dense``, ``moe`` and ``vlm`` (the transformer trunk), ``ssm``,
``hybrid`` and ``encdec``; another family raises ``ERR_UNSUPPORTED_OPERATION``.
The loss, prefill and decode entry points run under DTensor's implicit
replication (:func:`repro_torch.sharding.local.implicit_replication`), so
that on placed parameters the plain tensors they make (positions, masks,
indices) count as replicated.

:func:`param_structs` and :func:`cache_structs` are the reference's
``eval_shape`` stand-ins: the bundle's ``init`` and ``init_cache`` run under
``FakeTensorMode``, so the stand-ins are fake tensors (shape, dtype and
device, no storage) and nothing is allocated — the dry run's substrate."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

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


# ---------------------------------------------------------------------------
# shape-only helpers (dry-run substrate: no allocation, fake tensors)
# ---------------------------------------------------------------------------


def fake_mode() -> FakeTensorMode:
    """The fake-tensor mode for stand-ins: the active one, else a new one
    whose tensors may be mixed with plain ones (a position table, a mask)
    in a traced step."""

    from torch._guards import detect_fake_mode

    return detect_fake_mode() or FakeTensorMode(allow_non_fake_inputs=True)


def _on(tree: Any, device) -> Any:
    """Stand-ins of ``tree``'s tensors on ``device`` (a stand-in has no
    values to move: each is made anew there)."""

    if isinstance(tree, torch.Tensor):
        if tree.device == device:
            return tree
        return torch.empty_strided(tuple(tree.shape), tree.stride(), dtype=tree.dtype,
                                   device=device)
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _on(getattr(tree, f.name), device) for f in dataclasses.fields(tree)})
    return tree


def param_structs(bundle: ModelBundle, device="cpu", mode: FakeTensorMode | None = None) -> Any:
    """Parameter stand-ins on ``device`` (``"cuda"`` needs no card): the
    bundle's ``init`` under ``FakeTensorMode``, never materialised.  The
    draw runs on the CPU generator and the stand-ins move to ``device``."""

    with mode or fake_mode():
        with torch.no_grad():
            params = bundle.init(torch.Generator().manual_seed(0))
        return _on(params, torch.device(device))


def cache_structs(bundle: ModelBundle, pcfg, batch: int, length: int,
                  enc_len: int | None = None, device="cpu",
                  mode: FakeTensorMode | None = None) -> Any:
    """Cache stand-ins for decode dry runs (an encoder-decoder's from a
    prefill of stand-in parameters over ``enc_len`` frames)."""

    with mode or fake_mode(), torch.no_grad():
        if bundle.cfg.family == "encdec":
            params = param_structs(bundle, device)
            b = {
                "frames": torch.zeros((batch, enc_len or length, bundle.cfg.d_model),
                                      dtype=torch.bfloat16, device=device),
                "tokens": torch.zeros((batch, length), dtype=torch.int32, device=device),
            }
            _, cache = bundle.prefill(params, b, pcfg)
            return cache
        return bundle.init_cache(pcfg, batch, length, torch.device(device))
