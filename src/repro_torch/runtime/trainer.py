"""The Trainer — :class:`repro.runtime.trainer.Trainer` in eager PyTorch:
the data plan, the placed (FSDP, tensor and expert) plans, the ring plan
and the pipeline plan, checkpoint/restart, failure recovery and straggler
handling.

The train step is assembled from the port's layers, as the reference's is:

* model loss from ``repro_torch.models.api`` (dense, ssm and hybrid);
* AdamW from ``repro_torch.optim``;
* data from ``repro_torch.data`` (deterministic, stateless resume);
* checkpoints from ``repro_torch.checkpoint`` (async, atomic, the
  reference's on-disk format).

**Placed state** (:mod:`repro_torch.sharding.rules`): on a communicator of
more than one rank the parameters are DTensors on its ``device_mesh`` under
``param_specs`` (``fsdp`` is on in every arch's config: the largest weight
dim over the data axes; heads, ``d_ff`` and the vocabulary over ``model``),
the moments inherit their parameter's placement by shape
(:func:`state_specs`) and the global batch is split under
``batch_spec``.  DTensor's propagation computes the loss of the whole batch
and its gradients (the backward runs under implicit replication too); each
gradient is redistributed once to its parameter's placement — the one
reduction over ``data`` — and clipping, AdamW and checkpoints work on
local shards.  ``plan.tensor`` (and ``plan.expert``, which rides the same
axis) > 1 folds the communicator onto ``(data, model)``.  A global batch
whose rows the data axes do not split is replicated over them, as the
reference replicates it, and the step runs off the data axes
(:func:`~repro_torch.sharding.local.replicating`).  One rank keeps
plain tensors, where the layout is the identity; setting
:attr:`Trainer.placed` before the state is built overrides the choice (the
chip phase places the state on its mesh of one; a baseline keeps several
ranks' state whole).

**The data plan** (plain state).  Every rank holds the whole parameter and
optimizer state (made from the same seed), takes its block of the global
batch and averages its gradients over the communicator with one
``allreduce`` per dtype group of the gradient tree (the reflected datatype
of ``core/datatypes.py``: one message, not one per leaf).  On the card
this is a world of one over NCCL, which needs no exchange.

**Persistent execution engine** (the only one): the step is built *once* as a
:class:`~repro_torch.core.futures.PersistentRequest` bound to the
signature of its arguments (``ERR_REQUEST`` on drift); ``trace:train_step``
counts one build, and every step is a ``persistent_start``.  The step updates
the parameters and the optimizer state in place and donates them
(``donate_argnums=(0, 1)``, as in the reference), so on the card it is a
CUDA graph: step 1 runs eagerly, step 2 captures the step (forward,
backward and AdamW) and replays it, later steps replay it, each with its
batch copied into the graph's own batch buffer.  A step that captures is
exempt from the straggler deadline (known one-time work).  Since the state
is updated in place, a straggler cannot be re-dispatched
(``retry_safe=False``) and goes straight to the failure path, which drops
the failed state and the graph before the restore builds the next state
(so the state is never held twice) and captures again on the restored one.

**Async checkpointing** (default): ``ckpt.save`` copies the state to the
host synchronously and runs the file writes as I/O requests overlapping the
next steps; the single manifest commit is the durability point.  A failed
save surfaces as ``ERR_IO`` at the next join, is counted
(``ckpt_failures``, the ``ckpt_save_failed`` pvar) and logged, and training
goes on from device state.  One deviation: the run's final save is skipped
when the periodic save just covered the same step (the reference writes it
twice).

**The ring plan** (``plan.ring > 1``, or ``pcfg.ring_attention`` on a
communicator with a ``model`` axis): the communicator folds onto a
``(data, model)`` cart, periodic on ``model``, and the loss gets the
ring's line: each eligible layer shards its sequence over the ring kernel
(``models/attention.py``), whose gradient recomputes through the plain
ring.  Every ring rank holds the whole state and its data row's block of
the batch, ends the backward with the same gradients, and the gradients
average over ``data`` as the data plan's do.  On the card a ring of one
(a world of one) runs the kernel with no exchange.

**The pipeline plan** (``plan.stage > 1``): the communicator folds onto a
``(data, stage)`` cart, not periodic on ``stage``; ``params["layers"]`` is
placed ``Shard(0)`` on ``stage`` and the rest replicated
(:func:`_pipeline_param_specs`), and :func:`make_pipeline_train_step`
streams ``plan.microbatches`` microbatches of each rank's data block
through :func:`~repro_torch.core.overlap.pipeline_spmd` on local tensors.
The deprecated ``pipeline_stages``/``ring_attention`` knobs build the same
plans (:meth:`TrainerConfig.resolved_plan`).

On the card a plan whose ring or stages span more than one rank is
refused at the step's build (``ERR_UNSUPPORTED_OPERATION``): its NCCL
point-to-point exchanges hung inside the captured step on four H100s,
and the trainer does not switch to eager steps; the step functions run
eagerly (``tools/shard_ranks.py`` trains both plans so).

**Not ported, each raising ``ERR_UNSUPPORTED_OPERATION``:** the elastic
shrink and grow (``core/epoch.py``, ROADMAP A15: the trainer holds its
communicator where the reference holds a ``CommEpoch``).
``persistent=False`` and ``donate=False`` raise too: the step is always
the persistent, in-place one.  ``ParallelConfig(moment_dtype="int8")``
trains with the int8 moments of :mod:`repro_torch.optim.adamw`, inside the
same graph.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import warnings
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ParallelConfig, ParallelPlan
from repro_torch.core import datatypes, errors, overlap, tool, topology
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import PersistentRequest, flatten, unflatten
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.models import api as model_api
from repro_torch.models import transformer
from repro_torch.optim import AdamW, clip_by_global_norm, cosine_warmup
from repro_torch.optim.adamw import _Q8
from repro_torch.sharding import rules
from repro_torch.sharding.local import implicit_replication, is_dtensor
from repro_torch.runtime.faults import (
    FaultInjector,
    RankEvicted,
    StepGuard,
    StragglerPolicy,
    WorkerFailure,
)

log = logging.getLogger("repro_torch.trainer")

tool.pvar_register("trace:train_step", "train-step requests built (want exactly 1 per run)")
tool.pvar_register(
    "config:deprecated_knob",
    "TrainerConfig layouts built through the deprecated "
    "pipeline_stages/ring_attention int knobs instead of a ParallelPlan",
)

_deprecated_knob_warned = False


def _warn_deprecated_knobs() -> None:
    """One DeprecationWarning per process for the legacy int knobs; the pvar
    still counts every shimmed construction."""

    global _deprecated_knob_warned
    tool.pvar_count("config:deprecated_knob")
    if _deprecated_knob_warned:
        return
    _deprecated_knob_warned = True
    warnings.warn(
        "TrainerConfig.pipeline_stages/pipeline_microbatches/ring_attention "
        "are deprecated; pass plan=ParallelPlan(stage=..., ring=..., "
        "microbatches=...) instead",
        DeprecationWarning,
        stacklevel=3,
    )


def _not_ported(what: str, item: str) -> None:
    errors.fail(errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
                f"{what} is not ported yet: it waits for ROADMAP {item}")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10
    max_restarts: int = 3
    # persistent execution engine: bind the step once, MPI_Start it every
    # iteration; the step always updates its state in place (donate).  The
    # port runs only this engine: persistent=False raises
    persistent: bool = True
    donate: bool = True
    # checkpoint writes ride the I/O request engine and overlap the next
    # step; False joins each save before the next step starts
    async_checkpoint: bool = True
    # the unified layout; None = a pure data plan, unless the deprecated
    # knobs below ask for a fold
    plan: ParallelPlan | None = None
    # the reference's deprecated pipeline/ring int knobs, shimmed through
    # resolved_plan()
    pipeline_stages: int = 0
    pipeline_microbatches: int = 2
    ring_attention: int = 0

    def resolved_plan(self) -> ParallelPlan:
        """The one layout truth: ``plan`` when set, else the deprecated int
        knobs shimmed through :meth:`ParallelPlan.from_legacy` (warning
        once), else the pure data plan."""

        legacy = self.pipeline_stages > 1 or self.ring_attention > 1
        if self.plan is not None:
            errors.check(
                not legacy,
                errors.ErrorClass.ERR_ARG,
                "TrainerConfig.plan and the deprecated pipeline_stages/"
                "ring_attention knobs are both set; the plan is the only "
                "layout input — drop the legacy knobs",
            )
            return self.plan
        if legacy:
            _warn_deprecated_knobs()
            return ParallelPlan.from_legacy(
                pipeline_stages=self.pipeline_stages,
                pipeline_microbatches=self.pipeline_microbatches,
                ring_attention=self.ring_attention,
            )
        return ParallelPlan()


def _average(comm: Communicator | None, tree):
    """The data plan's gradient (or loss) average over ``comm``: one
    allreduce per dtype group of the tree; nothing to do on one rank."""

    if comm is None or comm.size() == 1:
        return tree
    n = comm.size()
    return datatypes.apply_packed(lambda buf: comm.allreduce(buf) / n, tree)


def make_train_step(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    tcfg: TrainerConfig,
    opt: AdamW,
    mesh=None,
    comm: Communicator | None = None,
):
    """Build the train-step function (params, opt_state, batch) ->
    (params, opt_state, metrics), which updates ``params`` and
    ``opt_state`` in place.  ``mesh`` is forwarded to the model loss, as in
    the reference; ``comm`` averages the gradients over the data plan's
    ranks."""

    bundle = model_api.build(cfg)

    def train_step(params, opt_state, batch):
        leaves, treedef = flatten(params)
        placed = is_dtensor(leaves[0])
        with implicit_replication():
            loss, metrics = bundle.loss(params, batch, pcfg, mesh)
            grads = torch.autograd.grad(loss, leaves)
            if placed:
                # the loss is the whole batch's: one reduction over data,
                # to each parameter's own placement, and no data-plan average
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for g, p in zip(grads, leaves)]
        grads = unflatten(treedef, grads)
        del leaves
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        if placed:
            metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        else:
            grads = _average(comm, grads)
            metrics["loss"] = _average(comm, metrics["loss"])
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def _pipeline_param_specs(params, stages: int):
    """Pipeline placement: the stacked ``layers`` leading (unit) dim is
    sharded over the cart ``stage`` axis — each stage holds its slice of
    the layer stack; embedding, head and norms replicate."""

    for leaf in flatten(params["layers"])[0]:
        errors.check(
            leaf.shape[0] % stages == 0,
            errors.ErrorClass.ERR_DIMS,
            f"{leaf.shape[0]} scanned units do not split over {stages} pipeline stages",
        )

    def specs(node, stacked: bool):
        if isinstance(node, dict):
            return {k: specs(v, stacked) for k, v in node.items()}
        if not stacked:
            return (None,) * node.ndim
        return ("stage",) + (None,) * (node.ndim - 1)

    return {k: specs(v, k == "layers") for k, v in params.items()}


def _stage_flags(params) -> list[bool]:
    """Per leaf of ``params`` (in :func:`flatten` order): whether it lies
    under ``layers``, the stack the stages split."""

    return [k == "layers" for k in sorted(params) for _ in flatten(params[k])[0]]


def _sum_over(comm: Communicator | None, tree):
    """The sum of ``tree`` over ``comm``: one allreduce per dtype group;
    nothing to do on one rank."""

    if comm is None or comm.size() == 1:
        return tree
    return datatypes.apply_packed(comm.allreduce, tree)


def make_pipeline_train_step(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    tcfg: TrainerConfig,
    opt: AdamW,
    cart,
    plan: ParallelPlan | None = None,
):
    """Pipeline-parallel train step over a ``(data, stage)`` Cartesian
    topology (MPI 4.0 ch. 8 as the pipeline fabric), updating ``params``
    and ``opt_state`` in place.

    Each rank takes its local tensors (the stage's slice of
    ``params['layers']`` and the replicated leaves, DTensors or not) and
    its data block of the batch, and
    :func:`repro_torch.core.overlap.pipeline_spmd` streams
    ``plan.microbatches`` microbatches through the stages — every stage
    boundary is one differentiable ``cart_shift(+1)`` exchange along
    ``stage``, never a world collective.  The backward walks the schedule
    in reverse, each shift sending its cotangent one stage back.  Then the
    reference's ``shard_map`` transpose by hand: the replicated leaves'
    gradients (the embedding's on stage 0, the head's on the last stage)
    sum over ``stage``, every gradient averages over ``data``, and the
    loss is the sum over (data, stage) divided by the data size."""

    embed_mb, apply_units, loss_mb = transformer.pipeline_stage_fns(cfg, pcfg)
    plan = plan if plan is not None else tcfg.resolved_plan()
    m = max(1, plan.microbatches)
    data_axis, stage_axis = cart.axis_names
    data_line, stage_line = cart.split(data_axis), cart.split(stage_axis)

    def train_step(params, opt_state, batch):
        leaves, treedef = flatten(params)
        stacked = _stage_flags(params)
        local = [(p.to_local() if is_dtensor(p) else p).detach().requires_grad_(True)
                 for p in leaves]
        lp = unflatten(treedef, local)
        tokens = batch["tokens"]
        errors.check(
            tokens.shape[0] % m == 0,
            errors.ErrorClass.ERR_COUNT,
            f"local batch {tokens.shape[0]} does not split into {m} microbatches",
        )
        toks = tokens.reshape(m, tokens.shape[0] // m, tokens.shape[1])
        losses = overlap.pipeline_spmd(
            cart,
            stage_dim=1,
            num_microbatches=m,
            inject=lambda i: embed_mb(lp, toks[i]),
            stage_fn=lambda state, t: apply_units(lp["layers"], state),
            extract=lambda i, state, is_last: (
                loss_mb(lp, state, toks[i]) if is_last
                else torch.zeros((), dtype=torch.float32, device=state.device)),
        )
        loss = sum(losses) / m
        grads = torch.autograd.grad(loss, local, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, local)]
        del lp, local, losses
        # only the last stage's loss is nonzero: the stage sum replicates it
        # and the data average averages the blocks' token means
        loss = _average(data_line, _sum_over(stage_line, loss.detach()))
        replicated = _sum_over(stage_line, [g for g, st in zip(grads, stacked) if not st])
        it = iter(replicated)
        grads = _average(data_line, [g if st else next(it) for g, st in zip(grads, stacked)])
        grads = unflatten(treedef, [
            _placed_as(g, p) for g, p in zip(grads, leaves)])
        del leaves
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The local gradient ``g`` as a DTensor placed as ``p`` (``g`` holds
    the placement's value: summed where ``p`` is replicated)."""

    if not is_dtensor(p):
        return g
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(g, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


def state_specs(params, opt_state, mesh_shape: dict, pcfg, pspecs=None):
    """The optimizer state's specs: a moment inherits the spec of the first
    parameter of its shape, as the reference's ``_state_shardings`` does;
    an int8 moment's scales are split as its payload's rows (the reference
    replicates them); the rest is replicated.  ``pspecs`` are the
    parameters' specs (by default ``rules.param_specs``)."""

    if pspecs is None:
        pspecs = rules.param_specs(params, mesh_shape, pcfg)
    by_shape: dict = {}
    for leaf, spec in zip(flatten(params)[0], rules.spec_leaves(pspecs)):
        by_shape.setdefault(tuple(leaf.shape), spec)

    def spec(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: spec(v) for k, v in node.items()}
        if isinstance(node, _Q8):
            q = by_shape.get(tuple(node.q.shape), (None,) * node.q.ndim)
            return _Q8(q=q, scale=q[:-1] + (None,) if q else ())
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: spec(getattr(node, f.name)) for f in dataclasses.fields(node)})
        return by_shape.get(tuple(node.shape), (None,) * node.ndim)

    return spec(opt_state)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """``comm`` picks the device (this rank's) and the data plan's ranks;
    without one, a host communicator over ``device`` (``"cuda"`` unless
    ``"cpu"`` is asked).  After :meth:`run`, ``params`` and ``opt_state``
    hold the final state."""

    def __init__(
        self,
        cfg: ModelConfig,
        pcfg: ParallelConfig,
        tcfg: TrainerConfig,
        comm: Communicator | None = None,
        *,
        seq_len: int = 512,
        global_batch: int = 8,
        injector: FaultInjector | None = None,
        straggler: StragglerPolicy | None = None,
        clock: Callable[[], float] | None = None,
        device: str | None = None,
    ):
        self.cfg, self.pcfg, self.tcfg = cfg, pcfg, tcfg
        self.injector = injector
        # the reference holds a CommEpoch (the elastic fabric); the port holds
        # its communicator directly until core/epoch.py lands (ROADMAP A15)
        self._comm = comm if comm is not None else make_host_communicator(device=device)
        self._reform_topology()
        self.device = self._comm.device
        #: the state is placed (DTensors on the communicator's device mesh);
        #: under the ring every rank holds the whole state
        self.placed = self._comm.size() > 1 and not self.pcfg.ring_attention
        errors.check(
            tcfg.donate,
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            "the port's step always updates params and optimizer state in place "
            "(TrainerConfig.donate=True)",
        )
        errors.check(
            tcfg.persistent,
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            "the port's step is always a persistent request (TrainerConfig.persistent=True)",
        )
        self.seq_len, self.global_batch = seq_len, global_batch
        self.bundle = model_api.build(cfg)
        self.opt = AdamW(
            lr=cosine_warmup(tcfg.lr, tcfg.warmup_steps, tcfg.steps),
            weight_decay=tcfg.weight_decay,
            moment_dtype=self.pcfg.moment_dtype,
        )
        self.guard = StepGuard(
            straggler or StragglerPolicy(), injector,
            clock if clock is not None else time.perf_counter,
        )
        self.ckpt = (
            CheckpointManager(
                tcfg.checkpoint_dir,
                keep=tcfg.keep_checkpoints,
                async_save=tcfg.async_checkpoint,
                injector=injector,
                comm=self._comm,
            )
            if tcfg.checkpoint_dir
            else None
        )
        self.ckpt_failures = 0
        self._saved_step: int | None = None
        self.pipeline = TokenPipeline(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            global_batch=global_batch,
            seed=tcfg.seed,
            modality={"encdec": "audio", "vlm": "vlm"}.get(cfg.family, "lm"),
            frame_dim=cfg.d_model,
            frame_len=max(8, seq_len // 8),
            image_tokens=cfg.num_image_tokens,
            image_dim=1152,
        )
        self._compiled = None
        self._request: PersistentRequest | None = None
        self.metrics_history: list[dict] = []
        self.restarts = 0
        self.evictions = 0
        self.joins = 0

    # -- the fabric ------------------------------------------------------------

    @property
    def comm(self) -> Communicator:
        return self._comm

    def _reform_topology(self) -> None:
        """The one place the trainer shapes its fabric: resolve the plan and
        fold the communicator onto it — a ``(data, model)`` cart, periodic
        on ``model``, for the ring (which sets ``pcfg.ring_attention``); a
        ``(data, stage)`` cart, not periodic, for the pipeline; a ``(data,
        model)`` grid for the tensor and expert plans; the communicator's
        own shape for the data plan."""

        self.plan = plan = self.tcfg.resolved_plan()
        if plan.remat is not None:
            self.pcfg = dataclasses.replace(self.pcfg, remat=plan.remat)
        if plan.reforms_fabric:
            size = self._comm.size()
            errors.check(
                size % plan.fixed_size == 0,
                errors.ErrorClass.ERR_DIMS,
                f"{size} ranks do not fold onto plan {plan.slug()!r} "
                f"(fixed axes need a multiple of {plan.fixed_size})",
            )
            dims = (size // plan.fixed_size,) + plan.fold_dims()[1:]
            if plan.ring > 1:
                # the periodic ring dim rides the model axis: attention
                # shards the sequence over the ring and rotates KV by
                # cart_shift(+1) exchanges
                self.pcfg = dataclasses.replace(self.pcfg, ring_attention=True)
            if plan.fold_periods() is not None:
                self._comm = topology.cart_create(
                    self._comm, dims, plan.fold_periods(), axis_names=plan.fold_axes(),
                    tag=f"{self._comm.tag or 'train'}/cart/{'x'.join(map(str, dims))}")
            else:
                self._comm = Communicator.from_group(
                    self._comm.group(), tag=self._comm.tag or "train", shape=dims,
                    axis_names=plan.fold_axes())
        # the ring's line, and the data line its ranks average over
        self._ring_line = self._data_line = None
        if self.pcfg.ring_attention or plan.stage > 1:
            names = self._comm.axis_names
            errors.check(
                "data" in names and (plan.stage > 1 or self.pcfg.model_axis in names),
                errors.ErrorClass.ERR_TOPOLOGY,
                f"the ring and pipeline plans need a data axis and a "
                f"{'stage' if plan.stage > 1 else self.pcfg.model_axis!r} axis, "
                f"got {names}",
            )
            self._data_line = self._comm.split("data")
            if self.pcfg.ring_attention:
                self._ring_line = self._comm.split(self.pcfg.model_axis)

    @property
    def _average_over(self) -> Communicator:
        """The ranks the data plan's gradients average over: the data line
        under the ring, else the whole communicator."""

        return self._data_line if self._ring_line is not None else self._comm

    def _batch(self, step: int) -> dict:
        """This rank's block of the global batch for ``step``; placed, the
        global batch split under ``batch_spec``; under the ring and the
        pipeline, its data row's block."""

        if self._data_line is not None:
            return self.pipeline.device_batch(step, self.device, self._data_line.rank(),
                                              self._data_line.size())
        if self.placed:
            mesh = self._comm.device_mesh
            batch = self.pipeline.device_batch(step, self.device)
            return rules.distribute(batch, rules.batch_spec(batch, rules.mesh_shape(mesh),
                                                            self.pcfg), mesh)
        return self.pipeline.device_batch(step, self.device, self._comm.rank(),
                                          self._comm.size())

    # -- assembly -------------------------------------------------------------

    def init_state(self):
        """Parameters from the seed (the same on every rank) and a fresh
        optimizer state, on this rank's device."""

        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        with torch.no_grad():
            params = self.bundle.init(gen)
        return self.place_state(params)

    def place_state(self, params):
        """(parameters, a fresh optimizer state) from whole ``params`` (the
        same on every rank): placed under the plan's specs when the state
        is placed, as they are otherwise."""

        with torch.no_grad():
            if not self.placed:
                return self._trainable(params), self.opt.init(params)
            mesh = self._comm.device_mesh
            shape = rules.mesh_shape(mesh)
            pspecs = (_pipeline_param_specs(params, self.plan.stage) if self.plan.stage > 1
                      else rules.param_specs(params, shape, self.pcfg))
            params = rules.distribute(params, pspecs, mesh)
            opt_state = self.opt.init(params)
            opt_state = rules.distribute(
                opt_state, state_specs(params, opt_state, shape, self.pcfg, pspecs), mesh)
        return self._trainable(params), opt_state

    @staticmethod
    def _trainable(params):
        for leaf in flatten(params)[0]:
            leaf.requires_grad_(True)
        return params

    def compile(self, params, opt_state):
        """The persistent step request, built lazily exactly once:
        ``trace:train_step`` is 1 per run."""

        if self._compiled is None:
            self._compiled = self._build_step(params, opt_state)
        return self._compiled

    def _build_step(self, params, opt_state):
        tool.pvar_count("trace:train_step")
        # on the card the step is a CUDA graph from start 2; a step of four
        # H100s whose ring exchanged point to point over NCCL hung once
        # captured (all-reduces, as the data plan's, capture), so such a
        # step is refused, never run otherwise
        exchanges = self.plan.stage > 1 or (self._ring_line is not None
                                            and self._ring_line.size() > 1)
        errors.check(
            not (exchanges and self.device.type == "cuda"),
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            f"plan {self.plan.slug()!r} exchanges point to point over NCCL inside its step, "
            f"which the trainer captures as a CUDA graph, and such a capture hangs: it is "
            f"refused on the card (the step functions, make_train_step and "
            f"make_pipeline_train_step, run eagerly)",
        )
        if self.plan.stage > 1:
            base_step = make_pipeline_train_step(self.cfg, self.pcfg, self.tcfg, self.opt,
                                                 self._comm, plan=self.plan)
        else:
            # under the ring the loss gets the ring's line, whose ranks end
            # with the same gradients: they average over the data line
            base_step = make_train_step(self.cfg, self.pcfg, self.tcfg, self.opt,
                                        mesh=self._ring_line, comm=self._average_over)
        self._request = PersistentRequest(base_step, (params, opt_state, self._batch(0)),
                                          donate_argnums=(0, 1))
        return self._request

    # -- the loop --------------------------------------------------------------

    def run(self, steps: int | None = None) -> dict:
        steps = steps if steps is not None else self.tcfg.steps
        params, opt_state = self.init_state()
        start = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            params, opt_state, start = self._restore(params, opt_state)
        self.compile(params, opt_state)

        step = start
        while step < steps:
            try:
                params, opt_state, step = self._run_span(params, opt_state, step, steps)
                continue
            except RankEvicted as e:
                self.evictions += 1
                if self.evictions + self.restarts > self.tcfg.max_restarts:
                    raise
                log.warning("rank %d evicted at step %d; shrinking", e.rank, e.step)
                params, opt_state, step = self._shrink(e)
                continue
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise
                log.warning("worker failure at step %d (%s); restarting", step, e)
            # outside the handler, whose traceback holds the failed span's
            # frames: the failed state is dropped before the restore builds
            # the next one
            params = opt_state = None
            params, opt_state, step = self._recover()
        if self.ckpt is not None:
            self._checkpoint(step, params, opt_state, join=True)
        self.params, self.opt_state = params, opt_state
        return {
            "final_step": step,
            "restarts": self.restarts,
            "evictions": self.evictions,
            "joins": self.joins,
            "epoch": 0,
            "world_size": self._comm.size(),
            "ckpt_failures": self.ckpt_failures,
            "metrics": self.metrics_history,
        }

    def _checkpoint(self, step, params, opt_state, *, join: bool = False) -> None:
        """Issue the (async) checkpoint save; ``join=True`` additionally
        waits for durability.  A failed save — surfaced as ``ERR_IO`` from
        the request join — is counted and logged, never silently dropped."""

        try:
            # collect the previous save's outcome first, so its failure is
            # reported without skipping this step's save
            self.ckpt.wait()
        except errors.IoError as e:
            self._note_ckpt_failure(step, e)
            self._saved_step = None
        if join and self._saved_step == step:
            return  # this step's periodic save is durable: joined just above
        try:
            self.ckpt.save(
                step,
                {"params": params, "opt": opt_state},
                extra={"step": step},
                meta={"epoch": 0, "world_size": self._comm.size()},
            )
            self._saved_step = step
            if join:
                self.ckpt.wait()
        except errors.IoError as e:
            self._note_ckpt_failure(step, e)
            self._saved_step = None

    def _note_ckpt_failure(self, step: int, e: Exception) -> None:
        self.ckpt_failures += 1
        tool.pvar_count("ckpt_save_failed")
        log.warning("checkpoint save failed at step %d: %s", step, e)

    def _run_span(self, params, opt_state, step, steps):
        # the step updates its state in place (donated buffers): a straggler
        # cannot be re-dispatched and takes the failure path
        retry_safe = False
        while step < steps:
            if self.injector is not None:
                joiners = self.injector.take_admissions(step)
                if joiners:
                    params, opt_state = self._grow(joiners, params, opt_state)
            step_fn = self._compiled
            batch = self._batch(step)

            def do_step():
                new_p, new_o, metrics = step_fn(params, opt_state, batch)
                _synchronize(self.device)
                return new_p, new_o, metrics

            (params, opt_state, metrics), info = self.guard.run(
                step,
                do_step,
                retry_safe=retry_safe,
                # a step sharing the host with an in-flight checkpoint save,
                # or capturing the CUDA graph, is slow from known work, not
                # from worker sickness
                exempt=(self.ckpt is not None and self.ckpt.pending())
                or not self._request.settled,
            )
            step += 1
            if step % self.tcfg.log_every == 0 or step == steps:
                pvars = tool.pvar_read()
                rec = {
                    "step": step,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    **{k: float(v) for k, v in info.items() if k != "straggled"},
                    "persistent_start": pvars.get("persistent_start", 0),
                    "partition_ready": pvars.get("partition_ready", 0),
                }
                self.metrics_history.append(rec)
                log.info(
                    "step %(step)d loss %(loss).4f "
                    "persistent_start %(persistent_start)d "
                    "partition_ready %(partition_ready)d", rec,
                )
            if (
                self.ckpt is not None
                and self.tcfg.checkpoint_every
                and step % self.tcfg.checkpoint_every == 0
            ):
                # the save's file I/O overlaps the following steps; the next
                # save (or run-end/exit) joins it and surfaces any failure
                self._checkpoint(step, params, opt_state)
        return params, opt_state, step

    # -- recovery ---------------------------------------------------------------

    def _shrink(self, evt: RankEvicted):
        """The ULFM shrink of the reference (revoke → shrink the group →
        rebuild → restore) needs ``core/epoch.py``."""

        _not_ported(f"the elastic shrink (rank {evt.rank} evicted at step {evt.step})", "A15")

    def _grow(self, count: int, params, opt_state):
        """The reference's hot-join of spare ranks needs ``core/epoch.py``."""

        _not_ported(f"the elastic grow ({count} rank(s) offered)", "A15")

    def _recover(self):
        """Restart protocol: restore the newest complete checkpoint and
        resume from its step (data is stateless).  The step's graph, which
        holds the failed state, is dropped first; the next step captures
        again on the restored state."""

        self._request.release()
        if self.ckpt is not None:
            # join the in-flight save first (tolerantly), so that a save
            # mid-commit is seen by latest_step()
            try:
                self.ckpt.wait()
            except errors.IoError as e:
                self._note_ckpt_failure(-1, e)
        params, opt_state = self.init_state()
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return params, opt_state, 0
        return self._restore(params, opt_state)

    def _restore(self, params, opt_state):
        try:
            self.ckpt.wait()
        except errors.IoError as e:
            self._note_ckpt_failure(-1, e)
        tree, step = self.ckpt.restore({"params": params, "opt": opt_state})
        extra_step = self.ckpt.extra(step).get("step", step)
        return self._trainable(tree["params"]), tree["opt"], int(extra_step)
