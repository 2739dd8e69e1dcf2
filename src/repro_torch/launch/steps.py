"""The production step functions the dry run traces, :mod:`repro.launch.steps`
for the port: functions of explicit trees (params / opt_state / batch /
cache / token), placed or plain, over the port's models.

* the train step is the trainer's eager step (``TrainerConfig(
  persistent=False)``: no CUDA graph), placed state and all: gradients of a
  placed loss reduce over data to their parameters' placements
  (:func:`repro_torch.runtime.trainer.make_train_step`).  Microbatching is
  kept: with ``pcfg.microbatches`` > 1 the batch comes as that many
  microbatches (:func:`repro_torch.launch.specs.input_specs`), whose
  gradients accumulate in fp32 before one clip and one update, as the
  reference's scan accumulates them;
* the prefill and decode steps are the bundle's, as the server runs them.

:func:`make_persistent_step` is the persistent-mode entry, as in the
reference: the step bound to an example argument list as a
:class:`~repro_torch.core.futures.PersistentRequest` with the production
donation pattern (params and opt-state for train, the cache for decode).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import base
from repro_torch.core.futures import PersistentRequest, flatten, unflatten
from repro_torch.models import api as model_api
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.sharding.local import implicit_replication, is_dtensor

#: the production buffer-donation pattern per step kind
DONATION = {"train": (0, 1), "prefill": (), "decode": (1,)}


def make_train_step(cfg: base.ModelConfig, pcfg: base.ParallelConfig, opt: AdamW):
    """(params, opt_state, batch) -> (params, opt_state, metrics), updating
    in place; ``batch`` is one batch, or a list of microbatches."""

    tcfg = trainer_mod.TrainerConfig(persistent=False)
    single = trainer_mod.make_train_step(cfg, pcfg, tcfg, opt)
    bundle = model_api.build(cfg)

    def train_step(params, opt_state, batch):
        if not isinstance(batch, list):
            return single(params, opt_state, batch)
        # gradient accumulation: peak activation memory divides by k, the
        # fp32 accumulator carries each parameter's placement
        k = len(batch)
        leaves, treedef = flatten(params)
        acc, losses = None, []
        for mbatch in batch:
            with implicit_replication():
                loss, metrics = bundle.loss(params, mbatch, pcfg, None)
                grads = torch.autograd.grad(loss, leaves)
                grads = [g.redistribute(p.device_mesh, p.placements) if is_dtensor(p) else g
                         for g, p in zip(grads, leaves)]
            grads = [g.float() for g in grads]
            acc = grads if acc is None else [a.add_(g) for a, g in zip(acc, grads)]
            losses.append(metrics["loss"].detach())
            del grads, loss
        with implicit_replication():
            grads = unflatten(treedef, [(a / k) for a in acc])
            loss = sum(losses) / k
        metrics = {"loss": loss.full_tensor() if is_dtensor(loss) else loss}
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: base.ModelConfig, pcfg: base.ParallelConfig):
    bundle = model_api.build(cfg)

    def prefill_step(params, batch):
        with torch.no_grad():
            return bundle.prefill(params, batch, pcfg, None)

    return prefill_step


def make_decode_step(cfg: base.ModelConfig, pcfg: base.ParallelConfig):
    bundle = model_api.build(cfg)

    def decode_step(params, cache, token):
        with torch.no_grad():
            return bundle.decode(params, cache, token, pcfg, None)

    return decode_step


def make_step(kind: str, cfg, pcfg, opt: AdamW | None = None):
    if kind == "train":
        return make_train_step(cfg, pcfg, opt or AdamW(lr=1e-4, moment_dtype=pcfg.moment_dtype))
    if kind == "prefill":
        return make_prefill_step(cfg, pcfg)
    if kind == "decode":
        return make_decode_step(cfg, pcfg)
    raise ValueError(kind)


def make_persistent_step(
    kind: str,
    cfg,
    pcfg,
    example_args: tuple,
    opt: AdamW | None = None,
    *,
    donate: bool = True,
    warm_start: bool = False,
) -> PersistentRequest:
    """Persistent mode: bind one production step to ``example_args`` with
    the production donation pattern (on the card a donating request replays
    one CUDA graph from its second start)."""

    fn = make_step(kind, cfg, pcfg, opt)
    donate_argnums = DONATION[kind] if donate else ()
    return PersistentRequest(fn, example_args, donate_argnums=donate_argnums,
                             warm_start=warm_start)


def example_args(kind: str, kwargs: dict[str, Any]) -> tuple:
    """The step's positional arguments from ``input_specs``'s kwargs."""

    from repro_torch.launch.specs import ORDER

    return tuple(kwargs[k] for k in ORDER[kind])
