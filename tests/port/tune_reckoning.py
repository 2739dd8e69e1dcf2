"""The reference's tuner under the port's serving reckoning (ROADMAP C22,
C28), shared by the port's tuner and dry-run tests.

:func:`c22_score` is the reference's ``score_plan`` with a serving plan
charged as the port's server holds it: on data alone (no stage, ring or
tensor fold) its weights whole on every rank (a config whose
``param_count`` is the model's times the plan's devices: the reference's
``bf16 · params / n`` then reads ``bf16 · params``), a peak working set
of the whole batch (C22), and the whole batch's compute and activation
traffic on every rank (C28); on any grid a prefill's working set twice.
The peak, and a data-only plan's compute and traffic, are written out
below in the port's order of operations.  Training plans are scored as
the reference scores them.
"""

from __future__ import annotations

import dataclasses

import pytest

#: the hardware model's constants, in both packages' ``core.tool``
CONSTANTS = ("PEAK_FLOPS_BF16", "HBM_BANDWIDTH", "ICI_BANDWIDTH", "DCN_BANDWIDTH", "HBM_BYTES",
             "COLLECTIVE_LAUNCH_S")


@pytest.fixture()
def tpu_constants(monkeypatch):
    """The port's hardware model set to the reference's (TPU) values."""

    from repro.core import tool as jtool
    from repro_torch.core import tool as ttool

    for name in CONSTANTS:
        monkeypatch.setattr(ttool, name, getattr(jtool, name))


class Held:
    """A config whose ``param_count`` is the model's times ``devices``."""

    def __init__(self, cfg, devices: int):
        self._cfg, self._devices = cfg, devices

    def __getattr__(self, name):
        return getattr(self._cfg, name)

    def param_count(self):
        return self._cfg.param_count() * self._devices


def c22_score(cfg, shape, plan, **kw):
    """The reference's score of ``plan`` with C22's serving weights and
    working set (module docstring); read at call time, so it follows the
    reference's constants as a test sets them."""

    from repro.core import tool
    from repro.tune import score

    if shape.kind == "train":
        return score.score_plan(cfg, shape, plan, **kw)
    # a serving plan on data alone: weights whole, the whole batch a rank
    n, whole = plan.total_devices, plan.stage == plan.ring == plan.tensor == 1
    s = score.score_plan(Held(cfg, n) if whole else cfg, shape, plan, **kw)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if whole:
        # C28: each rank computes the whole batch and moves its
        # activations: the reference's compute and traffic terms with one
        # rank's share of the batch made the whole batch
        flops = 2.0 * cfg.active_param_count() * tokens
        calibration = kw.get("calibration")
        if calibration and calibration.get("flops_scale"):
            flops *= float(calibration["flops_scale"])
        traffic = ((tokens / 1) * cfg.d_model * (cfg.num_layers / plan.stage) * 2.0 * 2
                   / max(plan.tensor, 1))
        s = dataclasses.replace(
            s, compute_s=flops / (1 * tool.PEAK_FLOPS_BF16),
            memory_s=(1.0 * (2 * cfg.param_count() / 1) + traffic) / tool.HBM_BANDWIDTH)
    rows = tokens if whole else tokens / plan.data
    act = ((rows / (max(1, plan.microbatches) * max(plan.ring, 1))) * cfg.d_model
           * (cfg.num_layers / plan.stage) * 2.0 * 2 / max(plan.tensor, 1))
    if shape.kind == "prefill":
        act *= 2.0
    peak = 2 * cfg.param_count() / (1 if whole else n) + act
    fits = peak <= tool.HBM_BYTES
    step = max(s.compute_s, s.memory_s) + s.bubble_s + s.wire_s + s.launch_s
    if not fits:
        step *= (peak / tool.HBM_BYTES) ** 2
    return dataclasses.replace(s, step_s=step, peak_bytes=peak, fits=fits)


@pytest.fixture()
def c22_reckoning(monkeypatch):
    """The reference's search scoring every plan by :func:`c22_score`."""

    import importlib

    # the module: the package's ``search`` name is its function
    jsearch = importlib.import_module("repro.tune.search")
    monkeypatch.setattr(jsearch, "score_plan", c22_score)
