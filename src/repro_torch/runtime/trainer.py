"""The Trainer — :class:`repro.runtime.trainer.Trainer` in eager PyTorch:
the data plan and the placed (FSDP, tensor and expert) plans,
checkpoint/restart, failure recovery and straggler handling.

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
axis) > 1 folds the communicator onto ``(data, model)``.  The global
batch's rows must split over the data axes (``ERR_DIMS`` otherwise:
:func:`~repro_torch.sharding.local.check_rows_split`).  One rank keeps
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

**Not ported, each raising ``ERR_UNSUPPORTED_OPERATION``:** the elastic
shrink and grow (``core/epoch.py``, ROADMAP A15: the trainer holds its
communicator where the reference holds a ``CommEpoch``); the pipeline and
ring plans (ROADMAP A14 item 5: the ring's gradient) and the reference's
deprecated ``pipeline_stages``/``ring_attention`` knobs that build them.
``persistent=False`` and ``donate=False`` raise too: the step is always
the persistent, in-place one.  ``ParallelConfig(moment_dtype="int8")``
trains with the int8 moments of :mod:`repro_torch.optim.adamw`, inside the
same graph.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ParallelConfig, ParallelPlan
from repro_torch.core import datatypes, errors, tool
from repro_torch.core.communicator import Communicator
from repro_torch.core.futures import PersistentRequest, flatten, unflatten
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_host_communicator
from repro_torch.models import api as model_api
from repro_torch.optim import AdamW, clip_by_global_norm, cosine_warmup
from repro_torch.optim.adamw import _Q8
from repro_torch.sharding import rules
from repro_torch.sharding.local import check_rows_split, implicit_replication, is_dtensor
from repro_torch.runtime.faults import (
    FaultInjector,
    RankEvicted,
    StepGuard,
    StragglerPolicy,
    WorkerFailure,
)

log = logging.getLogger("repro_torch.trainer")

tool.pvar_register("trace:train_step", "train-step requests built (want exactly 1 per run)")
# registered as the reference registers it; the legacy knobs it counts raise
# here (see TrainerConfig), so nothing counts it
tool.pvar_register(
    "config:deprecated_knob",
    "TrainerConfig layouts built through the deprecated "
    "pipeline_stages/ring_attention int knobs instead of a ParallelPlan",
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
    # the unified layout; None = a pure data plan
    plan: ParallelPlan | None = None
    # the reference's deprecated pipeline/ring int knobs: the plans they
    # build are not ported, so values above 1 raise
    pipeline_stages: int = 0
    pipeline_microbatches: int = 2
    ring_attention: int = 0


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


def state_specs(params, opt_state, mesh_shape: dict, pcfg):
    """The optimizer state's specs: a moment inherits the spec of the first
    parameter of its shape, as the reference's ``_state_shardings`` does;
    an int8 moment's scales are split as its payload's rows (the reference
    replicates them); the rest is replicated."""

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
        #: the state is placed (DTensors on the communicator's device mesh)
        self.placed = self._comm.size() > 1
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
        """Resolve the plan: the port runs the pure data plan (the
        communicator's own shape); a plan that re-forms the fabric or
        shards the model raises."""

        if self.tcfg.pipeline_stages > 1:
            _not_ported("the pipeline plan (TrainerConfig.pipeline_stages > 1)", "A14 item 5")
        if self.tcfg.ring_attention > 1:
            _not_ported("training with ring attention (TrainerConfig.ring_attention > 1)",
                        "A14 item 5")
        self.plan = plan = self.tcfg.plan or ParallelPlan()
        if plan.remat is not None:
            self.pcfg = dataclasses.replace(self.pcfg, remat=plan.remat)
        if plan.stage > 1:
            _not_ported("the pipeline plan (stage > 1)", "A14 item 5")
        if plan.ring > 1 or self.pcfg.ring_attention:
            _not_ported("training with ring attention (the ring's gradient)", "A14 item 5")
        if plan.tensor > 1 or plan.expert > 1:
            # the model dim rides the model axis (expert is 1 or equals
            # tensor); the data axis takes the rest
            m = max(plan.tensor, plan.expert)
            size = self._comm.size()
            errors.check(
                size % m == 0,
                errors.ErrorClass.ERR_DIMS,
                f"{size} ranks do not fold onto plan {plan.slug()!r} "
                f"(fixed axes need a multiple of {m})",
            )
            self._comm = Communicator.from_group(
                self._comm.group(), tag=self._comm.tag or "train",
                shape=(size // m, m), axis_names=("data", "model"))

    def _batch(self, step: int) -> dict:
        """This rank's block of the global batch for ``step``; placed, the
        global batch split under ``batch_spec``."""

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
            check_rows_split(self.global_batch, mesh, self.pcfg)
            shape = rules.mesh_shape(mesh)
            params = rules.distribute(params, rules.param_specs(params, shape, self.pcfg), mesh)
            opt_state = self.opt.init(params)
            opt_state = rules.distribute(
                opt_state, state_specs(params, opt_state, shape, self.pcfg), mesh)
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
        # no mesh for the loss: the ring, its one user, is not ported for training
        base_step = make_train_step(self.cfg, self.pcfg, self.tcfg, self.opt, comm=self._comm)
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
