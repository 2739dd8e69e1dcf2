"""Deterministic roofline scoring for
:class:`~repro_torch.configs.base.ParallelPlan` — :mod:`repro.tune.score`
with the port's hardware model.

The score of a plan is a *predicted step time in seconds* on the hardware
model in :mod:`repro_torch.core.tool` (an NVIDIA H100 SXM 80GB with NVLink 4
inside a node, its values and their sources recorded there:
``PEAK_FLOPS_BF16``, ``HBM_BANDWIDTH``, ``ICI_BANDWIDTH`` — NVLink —,
``DCN_BANDWIDTH`` — the NIC across nodes —, ``HBM_BYTES``,
``COLLECTIVE_LAUNCH_S``).  The model is a closed-form roofline — pure
arithmetic over the :class:`ModelConfig`, the :class:`ShapeConfig` and the
plan — so scoring is **deterministic**: no wall clock, no RNG, no torch.
When a dry-run artifact for the (arch, shape) cell exists, its measured
flops ratio *calibrates* the compute term (the only term analytic 6·N·D
undercounts), keeping the score a function of the artifact set alone.

The arithmetic is the reference's, term for term (with the reference's
constants in place of the H100's, the port's scores equal the reference's
exactly).  Port-only choice: :func:`load_calibration` reads the port's own
artifacts (:data:`CALIBRATION_DIR`, ``artifacts/dryrun_torch``), never the
reference's TPU ones; the port has no dry run yet, so that directory holds
none and every cell is scored uncalibrated.

Terms (train kind; serving shapes drop the backward/pipeline/grad terms):

* ``compute_s`` — remat-multiplied model FLOPs over all chips at peak.
* ``memory_s`` — per-device HBM traffic: sharded weights touched fwd/bwd/
  update plus activation stores at the remat mode's residency factor.
* ``bubble_s`` — the GPipe pipeline fill/drain bubble
  ``(s-1)/(m+s-1) · compute``; the term that makes microbatches *matter*.
* ``wire_s`` — exposed collective seconds after overlap credits: the
  data-axis grad all-reduce (hidden up to backward compute as
  ``grad_buckets`` grows, each bucket paying ``COLLECTIVE_LAUNCH_S``),
  pipeline-boundary permutes, ring KV rotation (~90 % hidden behind the
  blockwise kernel), per-layer tensor-parallel all-reduces and MoE
  all-to-alls.  The axis named ``plan.dcn_axis`` bills its wire bytes at
  DCN bandwidth instead of NVLink's.
* memory feasibility — predicted peak bytes vs ``HBM_BYTES``; an
  over-budget plan is *penalized* quadratically rather than discarded, so
  search stays total even at device counts where nothing fits.

Wire-byte factors reuse :func:`repro_torch.core.tool._wire_factor` — the
reference's ring-algorithm accounting.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

from repro_torch.configs.base import ModelConfig, ParallelPlan, ShapeConfig
from repro_torch.core import tool
from repro_torch.core.tool import _wire_factor

#: where :func:`load_calibration` looks by default: the port's own dry-run
#: artifacts (none until the port's dry run writes them).
CALIBRATION_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: extra forward FLOPs paid re-materialising activations in backward.
REMAT_FLOP_MULT = {"none": 1.0, "dots": 7.0 / 6.0, "full": 8.0 / 6.0}

#: resident activation bytes per token·layer, in units of d_model·2 bytes
#: (bf16): everything (~14 tensors) / attention probs + mlp in (~6) / layer
#: boundaries only (~2).
REMAT_RESIDENCY = {"none": 14.0, "dots": 6.0, "full": 2.0}

#: fraction of ring-rotation wire hidden behind blockwise compute (the
#: reference's figure, from its fused-ring bench on the TPU; the overlap
#: credits below are the reference's too, none measured on the H100).
RING_OVERLAP = 0.9

#: fraction of pipeline-boundary permute wire hidden behind stage compute.
PIPELINE_OVERLAP = 0.8

#: fraction of per-layer TP all-reduce wire hidden behind the matmuls.
TENSOR_OVERLAP = 0.3


@dataclasses.dataclass(frozen=True)
class Score:
    """One plan's predicted step decomposition (seconds, bytes)."""

    step_s: float                # the ranking key (includes penalty)
    compute_s: float
    memory_s: float
    bubble_s: float
    wire_s: float
    launch_s: float
    peak_bytes: float
    fits: bool

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _axis_bandwidth(axis: str, plan: ParallelPlan) -> float:
    """ICI, unless this fold axis is the one the plan routes across DCN."""

    if plan.dcn_axis is not None and axis == plan.dcn_axis:
        return tool.DCN_BANDWIDTH
    return tool.ICI_BANDWIDTH


def load_calibration(
    arch: str, shape: str, artifacts_dir: str | Path | None = None
) -> dict:
    """Measured terms from the (arch, shape) dry-run artifact, if one was
    recorded: ``{"flops_scale": hlo_flops_global / model_flops}``.  A pure
    function of the artifact files — nothing else — so a fixed artifact set
    gives a fixed calibration (and a fixed tuner output)."""

    if artifacts_dir is None:
        artifacts_dir = CALIBRATION_DIR
    out: dict = {}
    for mesh in ("pod_16x16", "multipod_2x16x16"):
        p = Path(artifacts_dir) / f"{arch}__{shape}__{mesh}.json"
        if not p.exists():
            continue
        try:
            rec = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        ratio = rec.get("useful_flop_ratio")
        if rec.get("status") == "ok" and ratio:
            out["flops_scale"] = 1.0 / float(ratio)
            out["source"] = p.name
            break
    return out


def score_plan(
    cfg: ModelConfig,
    shape: ShapeConfig,
    plan: ParallelPlan,
    *,
    default_remat: str = "full",
    calibration: dict | None = None,
) -> Score:
    """Predicted step seconds for ``plan`` (lower is better).

    Pure and deterministic: two calls with equal arguments return equal
    scores, and plan ordering never depends on dict iteration or time.
    """

    n = plan.total_devices
    d, s, r, e, t = plan.data, plan.stage, plan.ring, plan.expert, plan.tensor
    m = max(1, plan.microbatches)
    remat = plan.remat if plan.remat is not None else default_remat
    is_train = shape.kind == "train"
    bf16 = 2

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    tokens_local = tokens / d
    flop_mult = 6.0 if is_train else 2.0
    model_flops = flop_mult * cfg.active_param_count() * tokens
    if calibration and calibration.get("flops_scale"):
        model_flops *= float(calibration["flops_scale"])
    if is_train:
        model_flops *= REMAT_FLOP_MULT[remat]
    compute_s = model_flops / (n * tool.PEAK_FLOPS_BF16)

    # -- HBM traffic ---------------------------------------------------------
    # weights: sharded over every axis (fsdp over data, slices over
    # stage/tensor); touched fwd + bwd + optimizer update in train.
    param_bytes_local = bf16 * cfg.param_count() / n
    weight_touches = 3.0 if is_train else 1.0
    layers_local = cfg.num_layers / s
    act_residency = REMAT_RESIDENCY[remat] if is_train else 2.0
    act_traffic = (
        (tokens_local / max(r, 1)) * cfg.d_model * layers_local
        * act_residency * bf16 / max(t, 1)
    )
    memory_s = (
        weight_touches * param_bytes_local + act_traffic
    ) / tool.HBM_BANDWIDTH

    wire_s = 0.0
    launch_s = 0.0

    # -- data axis: gradient all-reduce, bucketed + overlapped ---------------
    if is_train and d > 1:
        grad_bytes = bf16 * cfg.param_count() / (s * max(t, 1))
        ar_s = grad_bytes * _wire_factor("all-reduce", d) / _axis_bandwidth(
            "data", plan
        )
        b = max(1, plan.grad_buckets)
        # all buckets but the last overlap backward, capped by what backward
        # can hide (~2/3 of compute is the backward pass)
        hidden = min(ar_s * (1 - 1 / b), (2.0 / 3.0) * compute_s)
        wire_s += ar_s - hidden
        launch_s += b * tool.COLLECTIVE_LAUNCH_S

    # -- stage axis: microbatch boundary permutes + the bubble ---------------
    bubble_s = 0.0
    if s > 1:
        bubble_s = compute_s * (s - 1) / (m + s - 1)
        mb_act_bytes = (tokens_local / m) * cfg.d_model * bf16
        crossings = (2 if is_train else 1) * (m + s - 2)
        perm_s = (
            crossings * mb_act_bytes * _wire_factor("collective-permute", s)
            / _axis_bandwidth("stage", plan)
        )
        wire_s += perm_s * (1 - PIPELINE_OVERLAP)
        launch_s += crossings * tool.COLLECTIVE_LAUNCH_S

    # -- ring axis: KV rotation, mostly hidden behind blockwise compute ------
    if r > 1:
        kv_heads = cfg.num_kv_heads or cfg.num_heads
        kv_shard = (
            2 * (tokens_local / r) * kv_heads * cfg.head_dim * bf16
        )
        rot_s = (
            cfg.num_layers * (r - 1) * kv_shard
            * (2 if is_train else 1)
            / _axis_bandwidth("model", plan)
        )
        wire_s += rot_s * (1 - RING_OVERLAP)
        launch_s += cfg.num_layers * (r - 1) * tool.COLLECTIVE_LAUNCH_S

    # -- tensor axis: per-layer activation all-reduces (Megatron pattern) ----
    if t > 1:
        act_bytes = (tokens_local / max(r, 1)) * cfg.d_model * bf16
        per_layer = 2 * (2 if is_train else 1)   # attn + mlp, fwd (+ bwd)
        ar_s = (
            layers_local * per_layer * act_bytes
            * _wire_factor("all-reduce", t) / _axis_bandwidth("model", plan)
        )
        wire_s += ar_s * (1 - TENSOR_OVERLAP)
        launch_s += layers_local * per_layer * tool.COLLECTIVE_LAUNCH_S

    # -- expert axis: token dispatch/combine all-to-alls ---------------------
    if e > 1 and cfg.num_experts:
        top_k = max(1, cfg.moe_top_k)
        a2a_bytes = (tokens_local / max(r, 1)) * cfg.d_model * bf16 * top_k
        per_layer = 2 * (2 if is_train else 1)   # dispatch + combine
        moe_layers = max(0, cfg.num_layers - cfg.first_dense_layers) / s
        a2a_s = (
            moe_layers * per_layer * a2a_bytes
            * _wire_factor("all-to-all", e) / _axis_bandwidth("model", plan)
        )
        wire_s += a2a_s
        launch_s += moe_layers * per_layer * tool.COLLECTIVE_LAUNCH_S

    # grad-accumulation microbatching without a pipeline: per-microbatch
    # dispatch overhead only (compute total unchanged)
    if s == 1 and m > 1:
        launch_s += m * tool.COLLECTIVE_LAUNCH_S

    # -- memory feasibility ---------------------------------------------------
    # resident: bf16 params + f32 Adam moments (train), sharded over every
    # axis, plus the activation working set of ONE microbatch slice.
    state_mult = (bf16 + 8) if is_train else bf16
    state_bytes = state_mult * cfg.param_count() / n
    act_store = (
        (tokens_local / (m * max(r, 1))) * cfg.d_model * layers_local
        * (REMAT_RESIDENCY[remat] if is_train else 2.0) * bf16 / max(t, 1)
    )
    peak_bytes = state_bytes + act_store
    fits = peak_bytes <= tool.HBM_BYTES

    step_s = max(compute_s, memory_s) + bubble_s + wire_s + launch_s
    if not fits:
        step_s *= (peak_bytes / tool.HBM_BYTES) ** 2
    return Score(
        step_s=step_s,
        compute_s=compute_s,
        memory_s=memory_s,
        bubble_s=bubble_s,
        wire_s=wire_s,
        launch_s=launch_s,
        peak_bytes=peak_bytes,
        fits=fits,
    )


def score_key(cfg, shape, plan, **kw) -> tuple:
    """Total deterministic ordering: step seconds, then the plan slug so
    exact ties break lexically instead of by enumeration accident."""

    return (score_plan(cfg, shape, plan, **kw).step_s, plan.slug())


def predicted_vs_measured(
    cfg: ModelConfig, shape: ShapeConfig, plan: ParallelPlan, record: dict
) -> dict | None:
    """Compare the analytic roofline against a dry-run artifact's measured
    terms (the bench-matrix validation hook).  Returns ratios or ``None``
    when the artifact carries no roofline block."""

    terms = record.get("roofline")
    if not terms or record.get("status") != "ok":
        return None
    sc = score_plan(cfg, shape, plan)
    chips = record.get("chips") or plan.total_devices
    measured_compute = terms["compute_s"]
    predicted_compute = sc.compute_s * plan.total_devices / chips
    return {
        "predicted_compute_s": predicted_compute,
        "measured_compute_s": measured_compute,
        "compute_ratio": (
            predicted_compute / measured_compute if measured_compute else math.inf
        ),
        "predicted_wire_s": sc.wire_s,
        "measured_wire_s": terms.get("collective_wire_s", 0.0),
    }
