"""The harness of the examples' tests: a reference script of ``examples/``
in a fresh JAX process with ``n`` virtual CPU devices, and its port in
``examples_torch/`` on ``n`` gloo ranks, side by side.

* The reference's side runs the script as ``python examples/<name>.py``
  does (``runpy`` under ``__main__``), with an observer that records what
  each ``Trainer.run`` and ``Server.generate`` returned (losses at full
  precision, tokens) into ``reference.json``; its printed lines are read
  from its standard output.
* The port's side runs ``main(argv, **hooks)`` of the port's script on
  every rank (``torch_ranks.py example``), under the analyzer's recording
  (the ``analysis_recording`` cvar, ``pvar_strict``) as ``python -m
  repro_torch.analysis.lint`` runs a target: each rank writes its ledger,
  and :func:`run` merges them and runs the checkers, so one run serves both
  the comparison and the lint's check.  ``hooks`` (the reference's weights,
  converted) reach the ranks through ``torch.save``.
* Both sides' trainers time their steps on a clock that stands still
  (``clock=lambda: 0.0``, as the port's trainer tests run them): on a
  loaded host a step of one side may pass the straggler deadline and
  restart that side's run alone.
* ``dtype`` (``"float32"``) makes both sides compute in fp32 where the
  script's model is bf16: the reference's ``Trainer`` and ``Server`` are
  built with it (``EXAMPLE_DTYPE``), the port's script takes it as
  ``main(dtype=...)``.  In bf16 the two frameworks round differently and
  near-tied argmaxes flip (8 of the 96 tokens of ``serve_batched`` at
  gemma2's smoke size), so tokens and losses are held in fp32, as every
  parity test of the port holds them.
* :func:`reference_params` draws a model's weights as the reference's
  ``Trainer`` and ``Server`` do (``jax.jit(bundle.init)(PRNGKey(seed))``),
  as numpy arrays for :func:`repro_torch.convert.params_from_jax`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_ranks import ROOT, finish_ranks, start_ranks

#: the reference's side: argv[1] the work directory, argv[2] the script,
#: the rest its arguments
REFERENCE_OBSERVER = r"""
import dataclasses, json, os, runpy, sys
from pathlib import Path

import numpy as np

workdir, script, argv = Path(sys.argv[1]), sys.argv[2], sys.argv[3:]
observed = {"train": [], "serve": []}

from repro.runtime import server as _server, trainer as _trainer

_run = _trainer.Trainer.run


def run(self, *a, **k):
    res = _run(self, *a, **k)
    observed["train"].append({
        "losses": [float(m["loss"]) for m in res["metrics"]],
        "steps": [int(m["step"]) for m in res["metrics"]],
        **{key: int(res[key]) for key in ("final_step", "restarts", "evictions", "joins",
                                          "epoch", "world_size") if key in res}})
    return res


_generate = _server.Server.generate


def generate(self, requests, *a, **k):
    tokens, stats = _generate(self, requests, *a, **k)
    observed["serve"].append(np.asarray(tokens).tolist())
    return tokens, stats


_trainer.Trainer.run, _server.Server.generate = run, generate
_trainer.Trainer.__init__ = (lambda init: lambda self, *a, **k: init(
    self, *a, **{"clock": lambda: 0.0, **k}))(_trainer.Trainer.__init__)

# EXAMPLE_DTYPE: every model the script builds computes in this dtype (the
# port's side gets the same through main(dtype=...))
DTYPE = os.environ.get("EXAMPLE_DTYPE")
if DTYPE:
    def with_dtype(init):
        def wrapped(self, cfg, *a, **k):
            init(self, dataclasses.replace(cfg, dtype=DTYPE), *a, **k)
        return wrapped

    _trainer.Trainer.__init__ = with_dtype(_trainer.Trainer.__init__)
    _server.Server.__init__ = with_dtype(_server.Server.__init__)
sys.argv = [script] + argv
try:
    runpy.run_path(script, run_name="__main__")
finally:
    (workdir / "reference.json").write_text(json.dumps(observed))
print("REFERENCE_DONE")
"""


@dataclasses.dataclass
class Runs:
    """What one comparison ran: the reference's printed lines and observed
    results, the port's per-rank ``main`` results and printed lines, and
    the analyzer's findings over the port's ranks."""

    ref_lines: list[str]
    ref: dict
    port: list[dict]
    port_lines: list[list[str]]
    findings: list


def reference_params(cfg_kwargs: dict, seed: int = 0):
    """The weights the reference's ``Trainer`` / ``Server`` draw for the
    model ``cfg_kwargs`` describes at ``seed``, converted to the port's
    tree on the CPU."""

    import jax

    from repro.configs.base import ModelConfig
    from repro.models import api
    from repro_torch.convert import params_from_jax

    params = jax.jit(api.build(ModelConfig(**cfg_kwargs)).init)(jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")


def run(name: str, n: int, tmp_path: Path, *, argv: tuple[str, ...] = (),
        ref_argv: tuple[str, ...] | None = None, hooks: dict | None = None,
        dtype: str | None = None, timeout: float = 240.0) -> Runs:
    """The reference's ``examples/<name>.py`` on ``n`` virtual devices and
    the port's ``examples_torch/<name>.py`` on ``n`` gloo ranks with
    ``--device cpu``, at once; ``argv`` goes to both (``ref_argv``, where
    given, to the reference instead)."""

    from repro_torch.analysis import checkers, events, lint

    ref_dir, port_dir = tmp_path / "reference", tmp_path / "port"
    ref_dir.mkdir(parents=True, exist_ok=True)
    port_dir.mkdir(parents=True, exist_ok=True)
    ref_args = list(argv if ref_argv is None else ref_argv)
    ref = _start_script(ref_dir, str(ROOT / "examples" / f"{name}.py"), ref_args, n, dtype)
    hooks = {**(hooks or {}), **({"dtype": dtype} if dtype else {})}
    np.savez(port_dir / "inputs.npz", name=np.array(name), workdir=np.array(str(port_dir)),
             argv=np.array([*argv, "--device", "cpu"]))
    if hooks:
        torch.save(hooks, port_dir / "hooks.pt")
    started = start_ranks("example", n, port_dir, timeout)
    try:
        results = finish_ranks(started)
    except BaseException:
        ref.kill()
        ref.wait()
        raise
    out = _finish_script(ref, ref_dir, timeout)
    port = [json.loads(str(r["json"])) for r in results]
    port_lines = [(port_dir / f"rank{r}.log").read_text().splitlines() for r in range(n)]
    files = sorted(port_dir.glob(lint.LEDGER_FILE.format(rank="*")))
    assert len(files) == n, f"{len(files)} of {n} ranks wrote a ledger"
    findings = checkers.run_all(events.merge(events.load(f) for f in files))
    return Runs(out.splitlines(), json.loads((ref_dir / "reference.json").read_text()),
                port, port_lines, findings)


def _start_script(workdir: Path, script: str, argv: list[str], n: int,
                  dtype: str | None) -> subprocess.Popen:
    env = {**os.environ, "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("EXAMPLE_DTYPE", None)
    if dtype:
        env["EXAMPLE_DTYPE"] = dtype
    # files, not pipes: the port's ranks are waited first
    with open(workdir / "stdout.txt", "w") as out, open(workdir / "stderr.txt", "w") as err:
        return subprocess.Popen([sys.executable, "-c", REFERENCE_OBSERVER, str(workdir),
                                 script, *argv], stdout=out, stderr=err, text=True, env=env,
                                cwd=str(ROOT))


def _finish_script(proc: subprocess.Popen, workdir: Path, timeout: float) -> str:
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out = (workdir / "stdout.txt").read_text()
    err = (workdir / "stderr.txt").read_text()
    assert proc.returncode == 0 and "REFERENCE_DONE" in out, (
        f"reference rc={proc.returncode}\n{out}\n{err[-4000:]}")
    return out


def line(lines: list[str], prefix: str) -> str:
    """The one line of ``lines`` that starts with ``prefix`` (stripped)."""

    found = [s.strip() for s in lines if s.strip().startswith(prefix)]
    assert len(found) == 1, (prefix, lines)
    return found[0]
