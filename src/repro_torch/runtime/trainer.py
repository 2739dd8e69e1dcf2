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
``batch_spec`` (the ring plan's state too, below).  DTensor's propagation
computes the loss of the whole batch and its gradients (the backward runs under implicit replication too); each
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

**Persistent execution engine** (default): the step is built *once* per
epoch as a :class:`~repro_torch.core.futures.PersistentRequest` bound to
the signature of its arguments (``ERR_REQUEST`` on drift);
``trace:train_step`` counts one build, and every step is a
``persistent_start``.  The step updates the parameters and the optimizer
state in place and donates them (``donate_argnums=(0, 1)``, as in the
reference), so on the card it is a CUDA graph: step 1 runs eagerly, step 2
captures the step (forward, backward and AdamW) and replays it, later steps
replay it, each with its batch copied into the graph's own batch buffer.  A
step that captures is exempt from the straggler deadline (known one-time
work).  Since the state is updated in place, a straggler cannot be
re-dispatched (``retry_safe=False``) and goes straight to the failure path,
which drops the failed state and the graph before the restore builds the
next state (so the state is never held twice) and captures again on the
restored one.  ``TrainerConfig(persistent=False)`` runs the step eagerly at
every iteration, with no graph; ``trace:train_step`` still counts one build
per epoch.  It keeps the donation (the in-place update), where the
reference's eager path drops it: a card holds the state once (the ring
plan's whole phi4-mini state at b 1 x 8192 peaks at 73 GB of the H100's 80
with one copy; placed, each card holds its shard of it), so a straggler
still takes the failure path.
``donate=False`` is the reference's step without donation: it runs on
copies of the state, the caller's stays valid, and a straggler is
re-dispatched (``retry_safe=True``).

**Elastic epochs** (:mod:`repro_torch.core.epoch`): the trainer holds a
:class:`~repro_torch.core.epoch.CommEpoch`, and everything comm-shaped
reads through it.  An eviction (``FaultInjector.evict_rank``, ``train
--evict-at``) revokes the epoch — releasing the step's CUDA graph and the
epoch's process groups — shrinks the pool to the survivors, re-folds the
data axis, restores the last committed manifest and goes on; an admission
(``admit_rank``, ``--admit-at``) grows the pool by the spare ranks and
carries the live state over, restoring nothing.  Ranks are processes, and
every process runs the same schedule: an evicted rank leaves the epoch but
not the world, and it, like a survivor the fold leaves over, idles — it
walks the schedule without computing and takes part in every transition
(each builds its generation's groups on every rank of the world) — until
the run ends or a grow folds it in; the joiners then receive the live
parameters and moments, broadcast from the first member of the grown pool
(a survivor), placed on the new mesh.

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
``(data, model)`` cart, periodic on ``model``, and each eligible layer
shards its sequence over the ring kernel (``models/attention.py``), whose
gradient recomputes through the plain ring.  On more than one rank the
state is placed as the reference places it (``rules.param_specs`` on the
cart, the moments by shape): the loss gets the whole communicator and the
placed global batch, as the tensor plan's does; each eligible layer takes
its projections, split by heads over ``model``, to this rank's sequence
block of every head for the kernel and back; the head's logits stay split
over the vocabulary (``common.cross_entropy`` reduces over it); the
gradients reduce over ``data`` to their parameters' placements; setting
``placed`` false there is refused (``ERR_UNSUPPORTED_OPERATION``).  On a
world of one the state is whole unless ``placed`` is set, and on the card
that ring of one runs the kernel with no exchange.  The elastic shrink and grow carry the placed ring state as they carry the
tensor plan's: the data axis re-folds (ranks the fixed ring dim leaves
over idle), the shrink restores the manifest onto the new cart, the grow
gathers the live state whole and places it again.

**The pipeline plan** (``plan.stage > 1``): the communicator folds onto a
``(data, stage)`` cart, not periodic on ``stage``; ``params["layers"]`` is
placed ``Shard(0)`` on ``stage`` and the rest replicated
(:func:`_pipeline_param_specs`), and :func:`make_pipeline_train_step`
streams ``plan.microbatches`` microbatches of each rank's data block
through :func:`~repro_torch.core.overlap.pipeline_spmd` on local tensors.
The deprecated ``pipeline_stages``/``ring_attention`` knobs build the same
plans (:meth:`TrainerConfig.resolved_plan`).

On the card a captured step of a plan whose ring or stages span more than
one rank is refused at the step's build (``ERR_UNSUPPORTED_OPERATION``):
its NCCL point-to-point exchanges hung inside the captured step on four
H100s.  The trainer does not switch to eager steps on its own: the caller
asks for them with ``TrainerConfig(persistent=False)``.
``ParallelConfig(moment_dtype="int8")`` trains with the int8 moments of
:mod:`repro_torch.optim.adamw`, inside the same graph.
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
from repro_torch.core import datatypes, errors, overlap, tool
from repro_torch.core.communicator import Communicator
from repro_torch.core.epoch import CommEpoch, TopologySpec
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

tool.pvar_register("trace:train_step", "train-step requests built (want exactly 1 per epoch)")
tool.pvar_register(
    "elastic:recovery_steps",
    "steps replayed per eviction (restore point back to eviction point)",
)
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
    # iteration (a CUDA graph on the card); persistent=False runs it eagerly.
    # donate lets the step update params/opt-state in place; donate=False
    # runs it on copies, which a straggler may re-dispatch
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


def _copied(tree):
    """``tree`` with every tensor leaf copied (detached)."""

    leaves, treedef = flatten(tree)
    return unflatten(treedef, [x.detach().clone() if isinstance(x, torch.Tensor) else x
                               for x in leaves])


def _out_of_place(step: Callable) -> Callable:
    """``step`` run on copies of the parameters and the optimizer state:
    the caller's stay as they were, so the step may be dispatched again on
    them (the reference's step without donation returns new buffers)."""

    def fresh(params, opt_state, batch):
        with torch.no_grad():
            params, opt_state = Trainer._trainable(_copied(params)), _copied(opt_state)
        return step(params, opt_state, batch)

    return fresh


def _whole(tree):
    """``tree`` with every DTensor leaf gathered whole (collective over its
    mesh); plain leaves as they are."""

    leaves, treedef = flatten(tree)
    with torch.no_grad():
        return unflatten(treedef, [x.full_tensor().detach() if is_dtensor(x) else x
                                   for x in leaves])


class Trainer:
    """``comm`` picks the device (this rank's) and the data plan's ranks;
    without one, a host communicator over ``device`` (``"cuda"`` unless
    ``"cpu"`` is asked).  The trainer folds it into generation 0 of its
    :class:`~repro_torch.core.epoch.CommEpoch`.  After :meth:`run`,
    ``params`` and ``opt_state`` hold the final state (``None`` on a rank
    the last epoch left idle)."""

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
        comm = comm if comm is not None else make_host_communicator(device=device)
        #: this rank's device, kept through the epochs in which it idles
        self.device = comm.device
        self._placed: bool | None = None
        self.ckpt = None
        self._adopt(self._reform_topology(comm))
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
                comm=self.comm,
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
        #: the revoked epochs (their graphs and process groups released)
        self.retired: list[CommEpoch] = []
        self.metrics_history: list[dict] = []
        self.restarts = 0
        self.evictions = 0
        self.joins = 0

    # -- the fabric: everything comm-shaped reads through the current epoch ---

    @property
    def epoch(self) -> CommEpoch:
        return self._epoch

    @property
    def comm(self) -> Communicator:
        return self._epoch.comm

    @property
    def placed(self) -> bool:
        """The state is placed (DTensors on the communicator's device
        mesh): on more than one rank, under the ring too.  Setting it
        before the state is built overrides the choice for every epoch,
        except that the ring on more than one rank refuses ``False``."""

        if self._placed is None:
            return self.comm.size() > 1
        self._check_placed(self._placed)
        return self._placed

    @placed.setter
    def placed(self, value: bool) -> None:
        self._check_placed(bool(value))
        self._placed = bool(value)

    def _check_placed(self, placed: bool) -> None:
        errors.check(
            placed or not self.pcfg.ring_attention or self.comm.size() == 1,
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            f"the ring plan places its state on {self.comm.size()} ranks, as the "
            f"reference does: placed=False is refused",
        )

    def _reform_topology(self, comm: Communicator) -> CommEpoch:
        """The one place the trainer shapes its fabric: resolve the plan,
        derive the epoch's :class:`TopologySpec` from it and bundle it with
        the communicator's group into generation 0 — a ``(data, model)``
        cart, periodic on ``model``, for the ring (which sets
        ``pcfg.ring_attention``); a ``(data, stage)`` cart, not periodic,
        for the pipeline; a ``(data, model)`` grid for the tensor and
        expert plans; the communicator itself, adopted, for the data plan.
        The data axis is the elastic dim — a shrink or grow re-folds it;
        the plan's stage, ring and tensor dims are fixed."""

        self.plan = plan = self.tcfg.resolved_plan()
        if plan.remat is not None:
            self.pcfg = dataclasses.replace(self.pcfg, remat=plan.remat)
        spec = None   # adopt the communicator's own shape
        if plan.reforms_fabric:
            size = comm.size()
            errors.check(
                size % plan.fixed_size == 0,
                errors.ErrorClass.ERR_DIMS,
                f"{size} ranks do not fold onto plan {plan.slug()!r} "
                f"(fixed axes need a multiple of {plan.fixed_size})",
            )
            spec = TopologySpec.from_plan(plan)
            if plan.ring > 1:
                # the periodic ring dim rides the model axis: attention
                # shards the sequence over the ring and rotates KV by
                # cart_shift(+1) exchanges
                self.pcfg = dataclasses.replace(self.pcfg, ring_attention=True)
        return CommEpoch.create(comm, spec, name="train")

    def _adopt(self, epoch: CommEpoch) -> None:
        """Make ``epoch`` the trainer's fabric: its communicator (built
        here, collectively over the process world), the lines derived from
        it and the ranks the checkpoints are saved with.  A rank the epoch
        leaves idle derives no line."""

        self._epoch = epoch
        comm = self.comm
        if self.ckpt is not None:
            self.ckpt.comm = comm if comm.size() > 1 and epoch.member else None
        # the ring's line, and the data line the pipeline's ranks read
        # their batch blocks by
        self._ring_line = self._data_line = None
        if epoch.member and (self.pcfg.ring_attention or self.plan.stage > 1):
            names = comm.axis_names
            errors.check(
                "data" in names and (self.plan.stage > 1 or self.pcfg.model_axis in names),
                errors.ErrorClass.ERR_TOPOLOGY,
                f"the ring and pipeline plans need a data axis and a "
                f"{'stage' if self.plan.stage > 1 else self.pcfg.model_axis!r} axis, "
                f"got {names}",
            )
            if self.pcfg.ring_attention:
                self._ring_line = comm.split(self.pcfg.model_axis)
            else:
                self._data_line = comm.split("data")

    def _batch(self, step: int) -> dict:
        """This rank's block of the global batch for ``step``; placed (the
        ring's too), the global batch split under ``batch_spec``; under the
        pipeline, its data row's block."""

        if self._data_line is not None:
            return self.pipeline.device_batch(step, self.device, self._data_line.rank(),
                                              self._data_line.size())
        if self.placed:
            mesh = self.comm.device_mesh
            batch = self.pipeline.device_batch(step, self.device)
            return rules.distribute(batch, rules.batch_spec(batch, rules.mesh_shape(mesh),
                                                            self.pcfg), mesh)
        return self.pipeline.device_batch(step, self.device, self.comm.rank(),
                                          self.comm.size())

    # -- assembly -------------------------------------------------------------

    def init_state(self):
        """Parameters from the seed (the same on every rank) and a fresh
        optimizer state, on this rank's device."""

        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        with torch.no_grad():
            params = self.bundle.init(gen)
        return self.place_state(params)

    def place_state(self, params, opt_state=None):
        """(parameters, optimizer state) from whole ``params`` and
        ``opt_state`` (by default a fresh one; the same on every rank):
        placed under the plan's specs when the state is placed, as they are
        otherwise."""

        with torch.no_grad():
            if not self.placed:
                return self._trainable(params), (
                    self.opt.init(params) if opt_state is None else opt_state)
            mesh = self.comm.device_mesh
            shape = rules.mesh_shape(mesh)
            pspecs = (_pipeline_param_specs(params, self.plan.stage) if self.plan.stage > 1
                      else rules.param_specs(params, shape, self.pcfg))
            params = rules.distribute(params, pspecs, mesh)
            if opt_state is None:
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
        """The epoch's step, built lazily exactly once per epoch
        (``epoch.cached``): a shrink or grow revokes the old epoch — and
        with it the step request, whose CUDA graph it releases — so the
        successor builds its own here on first use: ``trace:train_step`` is
        1 per epoch."""

        self._compiled = self._epoch.cached(
            "train_step", lambda _ep: self._build_step(params, opt_state))
        return self._compiled

    def _build_step(self, params, opt_state):
        tool.pvar_count("trace:train_step")
        # on the card a persistent, donating step is a CUDA graph from start
        # 2; a step of four H100s whose ring exchanged point to point over
        # NCCL hung once captured (all-reduces, as the data plan's,
        # capture), so such a step is refused, never run otherwise
        captures = self.tcfg.persistent and self.tcfg.donate
        exchanges = self.plan.stage > 1 or (self._ring_line is not None
                                            and self._ring_line.size() > 1)
        errors.check(
            not (exchanges and captures and self.device.type == "cuda"),
            errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
            f"plan {self.plan.slug()!r} exchanges point to point over NCCL inside its step, "
            f"which the trainer captures as a CUDA graph, and such a capture hangs: it is "
            f"refused on the card; TrainerConfig(persistent=False) runs the step eagerly",
        )
        if self.plan.stage > 1:
            base_step = make_pipeline_train_step(self.cfg, self.pcfg, self.tcfg, self.opt,
                                                 self.comm, plan=self.plan)
        else:
            # the ring's loss gets the whole communicator; placed, its
            # gradients reduce over data to their parameters' placements
            base_step = make_train_step(
                self.cfg, self.pcfg, self.tcfg, self.opt,
                mesh=self.comm if self._ring_line is not None else None, comm=self.comm)
        if not self.tcfg.donate:
            base_step = _out_of_place(base_step)
        if not self.tcfg.persistent:
            self._request = None
            return base_step
        self._request = PersistentRequest(base_step, (params, opt_state, self._batch(0)),
                                          donate_argnums=(0, 1) if self.tcfg.donate else ())
        return self._request

    # -- the loop --------------------------------------------------------------

    def run(self, steps: int | None = None) -> dict:
        steps = steps if steps is not None else self.tcfg.steps
        params = opt_state = None
        start = 0
        if self._epoch.member:
            params, opt_state = self.init_state()
            if self.ckpt is not None and self.ckpt.latest_step() is not None:
                params, opt_state, start = self._restore(params, opt_state)
            self.compile(params, opt_state)

        step = start
        while step < steps:
            try:
                if self._epoch.member:
                    params, opt_state, step = self._run_span(params, opt_state, step, steps)
                else:
                    params, opt_state, step = self._idle_span(step, steps)
                continue
            except RankEvicted as e:
                self.evictions += 1
                if self.evictions + self.restarts > self.tcfg.max_restarts:
                    raise
                log.warning("rank %d evicted at step %d; shrinking", e.rank, e.step)
                # the traceback holds the failed span's frames (and state)
                evicted = e.with_traceback(None)
            except WorkerFailure as e:
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise
                log.warning("worker failure at step %d (%s); restarting", step, e)
                evicted = None
            # outside the handler: the failed state is dropped before the
            # restore builds the next one
            params = opt_state = None
            if evicted is not None:
                params, opt_state, step = self._shrink(evicted)
            else:
                params, opt_state, step = self._recover()
        if self.ckpt is not None and self._epoch.member:
            self._checkpoint(step, params, opt_state, join=True)
        if self._epoch.generation > 0:
            self._epoch.barrier()   # an idle rank's run ends with the others'
        self.params, self.opt_state = params, opt_state
        return {
            "final_step": step,
            "restarts": self.restarts,
            "evictions": self.evictions,
            "joins": self.joins,
            "epoch": self._epoch.generation,
            "world_size": self.comm.size(),
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
                # manifests carry the fabric they were written under, so an
                # elastic restore knows it is resharding across world sizes
                meta={"epoch": self._epoch.generation, "world_size": self.comm.size()},
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
        # a donated step updates its state in place: a straggler cannot be
        # re-dispatched and takes the failure path (the reference's eager
        # step gives up donation, the port's keeps it: one copy of the state)
        retry_safe = not self.tcfg.donate
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
                or (self._request is not None and not self._request.settled),
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

    def _idle_span(self, step, steps):
        """A rank outside the epoch's active group (evicted, or left over
        by the fold) computes nothing: it walks the schedule, step by step,
        and takes part in each transition as the members do — until a grow
        folds it in (then it returns the state it received) or the run
        ends.  Other failures are the members' to handle."""

        while step < steps:
            if self.injector is not None:
                joiners = self.injector.take_admissions(step)
                if joiners:
                    params, opt_state = self._grow(joiners, None, None)
                    if self._epoch.member:
                        return params, opt_state, step
                try:
                    self.injector.check(step)
                except RankEvicted:
                    raise
                except WorkerFailure:
                    pass
            step += 1
        return None, None, step

    # -- recovery ---------------------------------------------------------------

    def _retire(self) -> None:
        """Before a transition: no checkpoint save of this epoch's ranks is
        left in flight (a restore reads the newest complete manifest)."""

        if self.ckpt is not None:
            try:
                self.ckpt.wait()
            except errors.IoError as e:
                self._note_ckpt_failure(-1, e)
        self.retired.append(self._epoch)

    def _shrink(self, evt: RankEvicted):
        """The ULFM recovery loop, one method: revoke (the step's CUDA
        graph and the epoch's process groups released) → ``Group.difference``
        shrink → ``Communicator.from_group`` / cart re-fold rebuild →
        restore from the last committed manifest → continue on the
        survivors.  Every rank of the world runs it, the evicted one
        included; a rank the successor leaves idle returns no state and
        goes on walking the schedule from the eviction's step."""

        self._retire()
        self._adopt(self._epoch.shrink([evt.rank]))
        log.warning(
            "epoch %d: %s survivors fold onto %s",
            self._epoch.generation, self._epoch.pool.size(), self._epoch.dims,
        )
        if not self._epoch.member:
            return None, None, evt.step
        params, opt_state = self.init_state()
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            params, opt_state, step = self._restore(params, opt_state)
        else:
            step = 0
        tool.pvar_add("elastic:recovery_steps", max(0, evt.step - step))
        self.compile(params, opt_state)
        return params, opt_state, step

    def _grow(self, count: int, params, opt_state):
        """The reverse path: hot-join up to ``count`` spare ranks (the
        world minus the epoch's pool), re-fold the elastic data axis, and
        carry the *live* state onto the grown fabric — growing loses no
        steps, so nothing is restored."""

        spares = (
            self._epoch.session.group("repro://world")
            .difference(self._epoch.pool)
            .devices[:count]
        )
        if not spares:
            log.warning("admission requested but no spare ranks; continuing")
            return params, opt_state
        self.joins += len(spares)
        tool.pvar_count("elastic:joins")
        return self._admit(spares, params, opt_state)

    def _admit(self, members, params, opt_state):
        """Grow the epoch by ``members`` (none is legal: the generation
        advances over the same pool) and carry the live state over: the
        old members gather their state whole; if the successor folds in a
        rank that held none, the first member of its pool (a survivor)
        broadcasts the whole state over the new communicator; then the
        state is placed on
        the new fabric and the successor's step is built.  Returns (params,
        opt_state), ``None`` on a rank the successor leaves idle."""

        old = self._epoch
        live = set(old.active.devices)
        whole = None
        if old.member:
            whole = _whole({"params": params, "opt": opt_state})
        params = opt_state = None
        self._retire()
        self._adopt(old.grow(members))
        epoch = self._epoch
        log.warning("epoch %d: %d rank(s) joined, folding onto %s",
                    epoch.generation, len(members), epoch.dims)
        if not epoch.member:
            return None, None
        if any(m not in live for m in epoch.active.devices):
            if whole is None:
                gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
                with torch.no_grad():
                    template = self.bundle.init(gen)
                whole = {"params": template, "opt": self.opt.init(template)}
            source = epoch.pool.device(0).rank   # a survivor: its state is live
            with torch.no_grad():
                for leaf in flatten(whole)[0]:
                    if isinstance(leaf, torch.Tensor):
                        torch.distributed.broadcast(leaf, src=source,
                                                    group=self.comm.process_group())
        params, opt_state = self.place_state(whole["params"], whole["opt"])
        del whole
        self.compile(params, opt_state)
        return params, opt_state

    def _recover(self):
        """Restart protocol: restore the newest complete checkpoint and
        resume from its step (data is stateless).  The step's graph, which
        holds the failed state, is dropped first; the next step captures
        again on the restored state."""

        if self._request is not None:
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
