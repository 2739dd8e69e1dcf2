"""Configuration schema: model, parallelism and workload shapes.

Every assigned architecture is a :class:`ModelConfig` in its own module
(``repro/configs/<id>.py``); the four workload shapes are fixed
:class:`ShapeConfig` instances; :class:`ParallelConfig` carries the
distribution plan (which the dry-run and the perf hillclimb toggle).

:class:`ParallelPlan` is the **unified layout object** on top of both: one
frozen value naming every fold the runtime can make (data × stage ×
expert/ring × tensor, plus microbatches, grad-sync buckets and the remat
mode), replacing the scattered knob surface (``TrainerConfig.pipeline_stages``
vs ``ring_attention``, the ``ParallelConfig`` booleans, ``TopologySpec``
dims).  The autotuner (:mod:`repro.tune`) enumerates the per-arch legal
space (:func:`plan_space` / :func:`legal_plans`), scores each candidate with
the roofline model, and emits the winner as a plan every layer consumes —
``TopologySpec.from_plan`` folds it, the Trainer re-forms its fabric from
it, the launchers parse it from ``--plan``.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import math

from repro_torch.core import errors
from repro_torch.core.descriptors import Compression


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavour
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    sliding_window: int | None = None
    layer_pattern: str = "uniform"   # uniform | local_global (gemma-2 alternation)
    post_norms: bool = False         # gemma-2 pre+post sandwich norms
    query_scale: float | None = None  # override 1/sqrt(head_dim)

    # embedding / head
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d_model) input scaling

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # MLA (deepseek-v2)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba-2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    attn_every: int = 0              # hybrid: shared attention block period

    # enc-dec
    encoder_layers: int = 0

    # vlm
    num_image_tokens: int = 0
    prefix_lm: bool = False

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    act: str = "silu"

    # provenance
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so the logit dimension shards over any mesh
        axis; synthetic labels are drawn below ``vocab_size``."""

        return _round_up(self.vocab_size, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS and reporting)."""

        d, L = self.d_model, self.num_layers
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            if self.mla:
                attn = (
                    d * self.q_lora
                    + self.q_lora * self.num_heads * (self.nope_head_dim + self.rope_head_dim)
                    + d * (self.kv_lora + self.rope_head_dim)
                    + self.kv_lora * self.num_heads * (self.nope_head_dim + self.v_head_dim)
                    + self.num_heads * self.v_head_dim * d
                )
            else:
                attn = (
                    d * self.num_heads * self.head_dim
                    + 2 * d * self.num_kv_heads * self.head_dim
                    + self.num_heads * self.head_dim * d
                )
            if self.num_experts:
                moe_l = L - self.first_dense_layers
                shared = self.num_shared_experts * 3 * d * self.moe_d_ff
                routed = self.num_experts * 3 * d * self.moe_d_ff
                router = d * self.num_experts
                mlp_total = (
                    moe_l * (shared + routed + router)
                    + self.first_dense_layers * 3 * d * self.d_ff
                )
            else:
                mlp_total = L * 3 * d * self.d_ff
            per_layer_total = L * attn + mlp_total + L * 2 * d
            if self.family == "encdec":
                # encoder layers + decoder cross-attention
                enc = self.encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
                cross = L * attn
                per_layer_total += enc + cross
            if self.family == "vlm":
                per_layer_total += 1152 * d  # SigLIP-stub multimodal projector
            return emb + per_layer_total
        if self.family == "ssm":
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            blk = (
                d * (2 * di + 2 * self.ssm_groups * ns + nh)   # in_proj
                + self.ssm_conv * (di + 2 * self.ssm_groups * ns)
                + di * d                                        # out_proj
                + 2 * nh + di + d                               # A, D, dt_bias(+norm)
            )
            return emb + L * blk + L * d
        if self.family == "hybrid":
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            blk = (
                d * (2 * di + 2 * self.ssm_groups * ns + nh)
                + self.ssm_conv * (di + 2 * self.ssm_groups * ns)
                + di * d
                + 2 * nh + di + d
            )
            attn = (
                d * self.num_heads * self.head_dim * 2
                + 2 * d * self.num_kv_heads * self.head_dim
                + 3 * d * self.d_ff
                + 4 * d
            )
            return emb + L * (blk + d) + attn  # one shared attention block
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active (per-token) parameters for MoE (6·N_active·D FLOPs)."""

        if not self.num_experts:
            return self.param_count()
        total = self.param_count()
        d = self.d_model
        moe_l = self.num_layers - self.first_dense_layers
        routed_all = moe_l * self.num_experts * 3 * d * self.moe_d_ff
        routed_active = moe_l * self.moe_top_k * 3 * d * self.moe_d_ff
        return total - routed_all + routed_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass
class ParallelConfig:
    """Distribution plan; the hillclimb toggles live here."""

    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"

    fsdp: bool = True                    # params/opt-state sharded over data_axes
    attn_plan: str = "tp_heads"          # tp_heads | sp (sequence-parallel attention)
    attn_impl: str = "ref"               # ref | chunked (online-softmax) | pallas[_tpu]
    shard_experts: bool = False          # EP: expert dim over model_axis
    moe_dispatch: str = "global"         # global | per_row (data-local dispatch)
    seq_shard_cache: bool = False        # decode: KV cache sharded over sequence
    flash_decode_merge: bool = False     # + exact partial-softmax merge (optimized)
    ring_attention: bool = False         # training SP via ring schedule (optimized)
    overlap_fsdp: bool = False           # all_gather_matmul futures (optimized)
    compression: Compression = Compression.NONE  # cross-pod grad payloads
    remat: str = "full"                  # none | full | dots
    microbatches: int = 1                # gradient-accumulation splits of the global batch
    kv_cache_dtype: str = "bfloat16"     # bfloat16 | int8
    moment_dtype: str = "float32"        # float32 | int8 (8-bit Adam moments)
    scan_layers: bool = True

    @property
    def all_data_axes(self) -> tuple[str, ...]:
        return self.data_axes


# -- the unified parallelism plan --------------------------------------------

#: remat modes a plan may pin (``None`` inherits the ParallelConfig's mode).
REMAT_MODES = ("none", "dots", "full")


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """One frozen value for the whole 4-axis layout space.

    ``data × stage × ring/expert × tensor`` must multiply to the device
    count the plan targets; at most one of ``stage``/``ring`` may exceed 1
    (both re-form the trainer's communicator), ``ring`` and ``tensor`` are
    mutually exclusive (both fold onto the ``model`` mesh axis), and expert
    parallelism rides the model axis (``expert`` is 1 or equals
    ``tensor``).  The data axis is the *elastic* one: the derived
    :class:`~repro.core.epoch.TopologySpec` marks it ``ELASTIC`` so the same
    plan folds at every survivor count.

    Beyond the fold, a plan carries the execution knobs the tuner searches
    over — ``microbatches`` (pipeline streaming / gradient accumulation),
    ``grad_buckets`` (grad-sync partition count, an overlap-vs-latency
    trade), ``remat`` — plus two deliberate placement choices:
    ``dcn_axis`` names the fold axis that crosses ``repro://slice/<k>``
    boundaries on multi-pod layouts (DCN is ~an order of magnitude slower
    than ICI, so which axis pays it is a plan decision, not an accident) and
    ``fanout`` is the serving prefill:decode split.
    """

    data: int = 1
    stage: int = 1
    ring: int = 1
    expert: int = 1
    tensor: int = 1
    microbatches: int = 1
    grad_buckets: int = 1
    remat: str | None = None
    dcn_axis: str | None = None
    fanout: tuple[int, int] | None = None

    def __post_init__(self):
        for f in ("data", "stage", "ring", "expert", "tensor",
                  "microbatches", "grad_buckets"):
            v = getattr(self, f)
            errors.check(
                isinstance(v, int) and v >= 1,
                errors.ErrorClass.ERR_ARG,
                f"ParallelPlan.{f} must be a positive int, got {v!r}",
            )
        errors.check(
            not (self.stage > 1 and self.ring > 1),
            errors.ErrorClass.ERR_TOPOLOGY,
            "plan axes stage (pipeline_stages) and ring (ring_attention) both "
            "re-form the communicator; pick one per plan",
        )
        errors.check(
            not (self.ring > 1 and self.tensor > 1),
            errors.ErrorClass.ERR_TOPOLOGY,
            "plan axes ring and tensor both fold onto the model mesh axis; "
            "pick one per plan",
        )
        errors.check(
            not (self.stage > 1 and self.tensor > 1),
            errors.ErrorClass.ERR_TOPOLOGY,
            "the pipeline step shards over (data, stage) only; tensor "
            "parallelism does not compose with stage > 1 yet",
        )
        errors.check(
            self.expert in (1, self.tensor),
            errors.ErrorClass.ERR_TOPOLOGY,
            f"expert parallelism rides the model axis: expert ({self.expert}) "
            f"must be 1 or equal tensor ({self.tensor})",
        )
        errors.check(
            self.remat is None or self.remat in REMAT_MODES,
            errors.ErrorClass.ERR_ARG,
            f"remat must be one of {REMAT_MODES} (or None to inherit), "
            f"got {self.remat!r}",
        )
        if self.fanout is not None:
            ok = (
                isinstance(self.fanout, tuple)
                and len(self.fanout) == 2
                and all(isinstance(x, int) and x >= 1 for x in self.fanout)
            )
            errors.check(
                ok, errors.ErrorClass.ERR_ARG,
                f"fanout must be a (prefill, decode) pair of positive ints, "
                f"got {self.fanout!r}",
            )
        if self.dcn_axis is not None:
            errors.check(
                self.dcn_axis in self.fold_axes(),
                errors.ErrorClass.ERR_TOPOLOGY,
                f"dcn_axis {self.dcn_axis!r} is not a fold axis of this plan "
                f"(axes: {self.fold_axes()})",
            )

    # -- the fold (what TopologySpec.from_plan consumes) ----------------------

    def fold_dims(self) -> tuple[int, ...]:
        """Concrete fold dims, data axis first (ring/tensor share the
        ``model`` axis, so exactly one of them contributes)."""

        if self.stage > 1:
            return (self.data, self.stage)
        if self.ring > 1:
            return (self.data, self.ring)
        if self.tensor > 1:
            return (self.data, self.tensor)
        return (self.data,)

    def fold_axes(self) -> tuple[str, ...]:
        if self.stage > 1:
            return ("data", "stage")
        if self.ring > 1 or self.tensor > 1:
            return ("data", "model")
        return ("data",)

    def fold_periods(self) -> tuple[bool, ...] | None:
        """Cartesian periods, or ``None`` for a plain (non-cart) fold.  Only
        the ring is periodic — KV rotates all the way around it."""

        if self.stage > 1:
            return (False, False)
        if self.ring > 1:
            return (False, True)
        return None

    @property
    def reforms_fabric(self) -> bool:
        """Whether this plan asks for a fold beyond the communicator's own
        shape (a pure data plan adopts whatever mesh it is handed)."""

        return self.stage > 1 or self.ring > 1 or self.tensor > 1

    @property
    def total_devices(self) -> int:
        return math.prod(self.fold_dims())

    @property
    def fixed_size(self) -> int:
        """Product of the non-data (non-elastic) fold dims."""

        return math.prod(self.fold_dims()[1:])

    @property
    def cart_pset(self) -> str:
        """The ``repro://cart/<dims>`` process-set name this plan's topology
        registers (tuner winners land here)."""

        return "repro://cart/" + "x".join(str(d) for d in self.fold_dims())

    def slug(self) -> str:
        """Compact stable identifier (dry-run artifact tags, bench rows)."""

        parts = [f"d{self.data}"]
        for key, v in (("s", self.stage), ("r", self.ring),
                       ("e", self.expert), ("t", self.tensor)):
            if v > 1:
                parts.append(f"{key}{v}")
        if self.microbatches > 1:
            parts.append(f"mb{self.microbatches}")
        if self.grad_buckets > 1:
            parts.append(f"gb{self.grad_buckets}")
        if self.remat is not None:
            parts.append(f"rm-{self.remat}")
        if self.dcn_axis is not None:
            parts.append(f"dcn-{self.dcn_axis}")
        if self.fanout is not None:
            parts.append(f"f{self.fanout[0]}-{self.fanout[1]}")
        return "_".join(parts)

    @classmethod
    def from_legacy(
        cls,
        *,
        pipeline_stages: int = 0,
        pipeline_microbatches: int = 2,
        ring_attention: int = 0,
    ) -> "ParallelPlan":
        """The plan equivalent of the deprecated ``TrainerConfig`` int knobs
        (the deprecation shims construct through here)."""

        stage = pipeline_stages if pipeline_stages > 1 else 1
        ring = ring_attention if ring_attention > 1 else 1
        return cls(
            stage=stage,
            ring=ring,
            microbatches=max(1, pipeline_microbatches) if stage > 1 else 1,
        )

    def resolved(self, devices: int) -> "ParallelPlan":
        """The same plan with the data axis folded out to ``devices``
        (``ERR_DIMS`` when the fixed axes do not divide the count)."""

        fixed = self.fixed_size
        errors.check(
            devices >= fixed and devices % fixed == 0,
            errors.ErrorClass.ERR_DIMS,
            f"{devices} devices do not fold onto plan {self.slug()!r} "
            f"(fixed axes need a multiple of {fixed})",
        )
        return dataclasses.replace(self, data=devices // fixed)


_PLAN_KEYS = {
    "data": "data", "stage": "stage", "ring": "ring", "expert": "expert",
    "tensor": "tensor", "micro": "microbatches", "microbatches": "microbatches",
    "buckets": "grad_buckets", "grad_buckets": "grad_buckets",
    "remat": "remat", "dcn": "dcn_axis", "dcn_axis": "dcn_axis",
    "fanout": "fanout",
}


def parse_plan(spec: str, devices: int | None = None) -> ParallelPlan:
    """Parse a ``--plan`` argument into a :class:`ParallelPlan`.

    Two grammars (``auto`` is the caller's sentinel, not parsed here):

    * positional ``DxSxExT`` — up to four ``x``-separated ints: data,
      stage, expert, tensor (``2x4`` = 2-way data × 4 pipeline stages);
    * ``key=value`` pairs — ``data=2,ring=4,micro=2,buckets=4,remat=dots,
      dcn=stage,fanout=2:6`` (``micro``/``buckets`` are short for
      ``microbatches``/``grad_buckets``).

    When ``data`` is omitted in the key=value form and ``devices`` is
    given, the data axis fills the remaining devices.  A pipeline plan
    (``stage>1``) with no explicit microbatch count defaults to 2, matching
    the deprecated ``--pipeline-microbatches`` default.
    """

    spec = spec.strip()
    errors.check(
        bool(spec) and spec != "auto",
        errors.ErrorClass.ERR_ARG,
        f"empty or sentinel plan spec {spec!r} (resolve 'auto' via repro.tune)",
    )
    kw: dict = {}
    explicit_micro = False
    if "=" in spec:
        for part in spec.split(","):
            key, _, val = part.partition("=")
            key = key.strip().lower()
            errors.check(
                key in _PLAN_KEYS and val != "",
                errors.ErrorClass.ERR_ARG,
                f"unknown plan key {part!r} (known: {sorted(set(_PLAN_KEYS))})",
            )
            field = _PLAN_KEYS[key]
            if field == "remat":
                kw[field] = val.strip()
            elif field == "dcn_axis":
                kw[field] = val.strip()
            elif field == "fanout":
                p, _, d = val.partition(":")
                try:
                    kw[field] = (int(p), int(d))
                except ValueError:
                    errors.fail(
                        errors.ErrorClass.ERR_ARG,
                        f"fanout must be P:D (e.g. 2:6), got {val!r}",
                    )
            else:
                try:
                    kw[field] = int(val)
                except ValueError:
                    errors.fail(
                        errors.ErrorClass.ERR_ARG,
                        f"plan key {key!r} needs an int, got {val!r}",
                    )
                if field == "microbatches":
                    explicit_micro = True
    else:
        try:
            dims = [int(t) for t in spec.split("x")]
        except ValueError:
            errors.fail(
                errors.ErrorClass.ERR_ARG,
                f"plan spec {spec!r} is neither DxSxExT ints nor key=value "
                f"pairs",
            )
        errors.check(
            1 <= len(dims) <= 4,
            errors.ErrorClass.ERR_ARG,
            f"positional plan takes 1-4 dims (data[xstage[xexpert[xtensor]]]), "
            f"got {len(dims)}",
        )
        for field, v in zip(("data", "stage", "expert", "tensor"), dims):
            kw[field] = v
    # expert rides the model axis: an expert-only request implies tensor
    if kw.get("expert", 1) > 1 and "tensor" not in kw:
        kw["tensor"] = kw["expert"]
    if kw.get("stage", 1) > 1 and not explicit_micro:
        kw.setdefault("microbatches", 2)
    if "data" not in kw and devices is not None:
        fixed = (
            max(1, kw.get("stage", 1))
            * max(1, kw.get("ring", 1))
            * max(1, kw.get("tensor", 1))
        )
        errors.check(
            devices % fixed == 0,
            errors.ErrorClass.ERR_DIMS,
            f"{devices} devices do not fold onto plan {spec!r} "
            f"(fixed axes multiply to {fixed})",
        )
        kw["data"] = devices // fixed
    return ParallelPlan(**kw)


# -- per-arch legal plan space ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanSpace:
    """The axis values the tuner may enumerate for one architecture.  A
    declaration, not a guarantee: :func:`legal_plans` still filters every
    combination against the model/shape/device constraints."""

    stages: tuple[int, ...] = (1, 2, 4, 8)
    rings: tuple[int, ...] = (1, 2, 4, 8)
    experts: tuple[int, ...] = (1,)
    tensors: tuple[int, ...] = (1, 2, 4, 8)
    microbatches: tuple[int, ...] = (1, 2, 4, 8)
    grad_buckets: tuple[int, ...] = (1, 2, 4)
    remats: tuple[str, ...] = ("none", "full")


def plan_space(arch: str) -> PlanSpace:
    """The per-arch legal-space declaration: the arch module's own
    ``plan_space()`` when it declares one, else a family-derived default
    (SSM/hybrid models have no attention ring to shard; MoE models get the
    expert axis up to their expert count)."""

    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    declared = getattr(mod, "plan_space", None)
    if declared is not None:
        return declared()
    cfg = mod.config()
    space = PlanSpace()
    if cfg.family in ("ssm", "hybrid"):
        space = dataclasses.replace(space, rings=(1,))
    if cfg.num_experts:
        space = dataclasses.replace(
            space,
            experts=tuple(
                e for e in (1, 2, 4, 8) if cfg.num_experts % e == 0
            ),
        )
    return space


def legal_plans(
    cfg: ModelConfig,
    shape: ShapeConfig,
    devices: int,
    space: PlanSpace | None = None,
    *,
    slices: int = 1,
) -> list[ParallelPlan]:
    """Every plan in ``space`` that is legal for this (arch × shape ×
    device-count) cell, deterministic order.

    Filters: the cell must be applicable at all (:func:`shape_applicable`);
    the fixed axes must divide the device count (the data axis — the one
    elastic axis — fills the rest); pipeline stages must divide the layer
    stack; the ring must divide the sequence and only shard real attention;
    tensor must divide the head count; experts ride the model axis; the
    per-device batch must split over the microbatches.  On multi-slice
    (multi-pod) folds, each legal plan is emitted once per admissible
    ``dcn_axis`` — an axis whose size divides over the slice count — so
    which fold crosses DCN is scored deliberately, never defaulted.
    """

    ok, _ = shape_applicable(cfg, shape)
    if not ok or devices < 1:
        return []
    space = space or PlanSpace()
    is_train = shape.kind == "train"
    plans: list[ParallelPlan] = []
    micro_opts = space.microbatches if is_train else (1,)
    bucket_opts = space.grad_buckets if is_train else (1,)
    remat_opts = space.remats if is_train else (None,)
    stage_opts = space.stages if is_train else (1,)
    for s, r, e, t in itertools.product(
        stage_opts, space.rings, space.experts, space.tensors
    ):
        if sum(x > 1 for x in (s, r, t)) > 1:
            continue                      # one re-formed fabric per trainer
        if e > 1 and e != t:
            continue                      # expert rides the model axis
        if s > 1 and cfg.num_layers % s != 0:
            continue
        if r > 1 and (
            cfg.family in ("ssm", "hybrid") or shape.seq_len % r != 0
        ):
            continue
        if t > 1 and cfg.num_heads % t != 0:
            continue
        if e > 1 and (not cfg.num_experts or cfg.num_experts % e != 0):
            continue
        fixed = s * max(r, 1) * max(t, 1)
        if devices % fixed != 0:
            continue
        d = devices // fixed
        for m in micro_opts:
            if s > 1 and m < 2:
                continue                  # a 1-deep pipeline never overlaps
            local_batch = shape.global_batch // d
            if (
                is_train
                and (shape.global_batch % d != 0 or local_batch % m != 0)
            ):
                continue
            for b in bucket_opts:
                for remat in remat_opts:
                    base = ParallelPlan(
                        data=d, stage=s, ring=r, expert=e, tensor=t,
                        microbatches=m, grad_buckets=b, remat=remat,
                    )
                    if slices <= 1:
                        plans.append(base)
                        continue
                    axes = base.fold_axes()
                    dims = base.fold_dims()
                    dcn_opts = [
                        a for a, n in zip(axes, dims)
                        if n > 1 and n % slices == 0
                    ]
                    for dcn in dcn_opts or [None]:
                        plans.append(
                            dataclasses.replace(base, dcn_axis=dcn)
                        )
    return plans


# -- registry ----------------------------------------------------------------

ARCHITECTURES = (
    "qwen1_5_32b",
    "phi4_mini_3_8b",
    "gemma2_9b",
    "granite_3_8b",
    "seamless_m4t_large_v2",
    "paligemma_3b",
    "grok_1_314b",
    "deepseek_v2_236b",
    "zamba2_7b",
    "mamba2_2_7b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHITECTURES}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.config()


def get_parallel(arch: str, multi_pod: bool = False) -> ParallelConfig:
    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    p: ParallelConfig = mod.parallel()
    if multi_pod:
        p.data_axes = ("pod", "data")
    return p


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""

    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config()


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch × shape) cell runs; reason if skipped (DESIGN.md §5)."""

    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k requires sub-quadratic attention state (full-attention arch)"
    return True, ""
