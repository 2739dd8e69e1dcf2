"""The analyzer CLI — the CI gate, :mod:`repro.analysis.lint` for the port.

    python -m repro_torch.analysis.lint --strict

Two passes:

1. **Static** — the source meta-checks (:mod:`repro_torch.analysis.static`)
   over ``src/repro_torch``, ``chip_smoke.py`` and ``tools``: swallowed
   ``except Exception`` handlers and unregistered pvar writes.
2. **Dynamic** — every target runs in fresh processes, one a rank, with
   the ``analysis_recording`` cvar on and ``pvar_strict(True)``.  Each rank
   writes its ledger to a file of a temporary directory
   (:func:`repro_torch.analysis.events.dump`); the parent merges the files
   (:func:`~repro_torch.analysis.events.merge`) and runs
   :func:`~repro_torch.analysis.checkers.run_all` over them.  Files, not a
   gather: a run with mismatched collectives or a wait-for cycle may hang,
   and that is what the checkers exist to report.  A target that does not
   finish in time is a ``script-timeout`` finding (the ranks' files are
   still checked), one that fails a ``script-failed`` finding, as in the
   reference.

**The default targets** (:data:`DEFAULT_TARGETS`) are, as the reference's,
the example scripts: every ``examples_torch/*.py``, the port's counterparts
of the reference's ``examples/``, then the port's CLIs at smoke size on the
CPU (:data:`CLI_TARGETS`: ``serve --smoke --device cpu`` on one rank, and
``train`` for 2 steps on one rank and on two gloo ranks).  A script takes
the arguments of its head's ``# lint-args: …`` line, as in the reference,
then ``--device cpu`` (the port's entry points run on the card unless
told otherwise).  **Port-only convention:** a rank is a
process, so a script's head may name the ranks it runs on with a ``#
lint-ranks: N`` line (``torch.distributed.run``, gloo); without one it
runs on ``--ranks`` ranks.  A target given on the command line is a script
or a directory of scripts, run the same way.  :func:`lint_script` is the
reference's one-script call: the script in one process, its findings on
the :data:`MARKER` line.

``--strict`` exits non-zero on any finding; without it the lint only
reports.  ``--no-run`` skips the dynamic pass (static checks only).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import shlex
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.analysis.checkers import Finding
from repro_torch.core.errors import ErrorClass

ROOT = Path(__file__).resolve().parents[3]

#: (ranks, arguments after ``python``) of the port's CLIs as lint targets,
#: at smoke size on the CPU
CLI_TARGETS: tuple[tuple[int, tuple[str, ...]], ...] = (
    (1, ("-m", "repro_torch.launch.serve", "--arch", "phi4_mini_3_8b", "--smoke",
         "--device", "cpu", "--requests", "2", "--prompt-len", "16", "--new-tokens", "4")),
    (1, ("-m", "repro_torch.launch.train", "--arch", "phi4_mini_3_8b", "--smoke",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32")),
    (2, ("-m", "repro_torch.launch.train", "--arch", "phi4_mini_3_8b", "--smoke",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32")),
)

#: the file a rank writes its ledger to, in the target's directory
LEDGER_FILE = "rank{rank}.jsonl"

#: the line on which :func:`lint_script`'s runner reports its findings
MARKER = "ANALYSIS_FINDINGS "

_RUNNER = r"""
import json, runpy, sys
from repro_torch.core import tool
from repro_torch.analysis import checkers

path = sys.argv[1]
sys.argv = [path] + sys.argv[2:]
tool.cvar_set("analysis_recording", True)
tool.pvar_strict(True)
rc = 0
try:
    runpy.run_path(path, run_name="__main__")
except SystemExit as exc:
    rc = int(exc.code or 0) if not isinstance(exc.code, str) else 1
findings = checkers.run_all()
print(MARKER + json.dumps([f.as_dict() for f in findings]))
sys.exit(rc)
""".replace("MARKER", repr(MARKER))


def _env() -> dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def record(out_dir: str, argv: list[str]) -> int:
    """Run one rank of a target under recording (``argv`` is ``-m module
    ...`` or ``script ...``) and write its ledger to ``out_dir``; the
    target's exit code."""

    from repro_torch.analysis import events
    from repro_torch.core import tool

    tool.cvar_set("analysis_recording", True)
    tool.pvar_strict(True)
    rank = int(os.environ.get("RANK", "0"))
    module = argv[0] == "-m"
    target = argv[1] if module else argv[0]
    sys.argv = [target] + argv[(2 if module else 1):]
    rc = 0
    try:
        if module:
            runpy.run_module(target, run_name="__main__", alter_sys=True)
        else:
            runpy.run_path(target, run_name="__main__")
    except SystemExit as exc:
        rc = int(exc.code or 0) if not isinstance(exc.code, str) else 1
    finally:
        events.dump(Path(out_dir) / LEDGER_FILE.format(rank=rank))
    return rc


def _command(ranks: int, argv: tuple[str, ...], out_dir: str) -> list[str]:
    runner = ["-m", "repro_torch.analysis.lint", "--record", out_dir, "--", *argv]
    if ranks == 1:
        return [sys.executable, *runner]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={ranks}", *runner]


def _head(path: Path, key: str) -> str | None:
    for line in Path(path).read_text().splitlines()[:30]:
        if line.strip().startswith(f"# {key}:"):
            return line.split(":", 1)[1]
    return None


def _lint_args(path: Path) -> list[str]:
    """Per-script lint arguments: a ``# lint-args: …`` line in the script's
    head scales a long-running script down to gate size."""

    head = _head(path, "lint-args")
    return shlex.split(head) if head is not None else []


def _lint_ranks(path: Path, default: int = 1) -> int:
    """The ranks a script runs on under the lint: its head's ``#
    lint-ranks: N`` line (port-only), else ``default``."""

    head = _head(path, "lint-ranks")
    return int(head) if head is not None else default


def _scripts(paths: list[str]) -> list[Path]:
    """The scripts of ``paths``: each ``.py`` file, and every ``*.py`` of a
    directory (sorted), as the reference's lint globs them."""

    out: list[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.glob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


def script_targets(paths: list[str], *, ranks: int = 1) -> list[tuple[int, tuple[str, ...]]]:
    """(ranks, arguments) of each script of ``paths`` as a lint target: its
    ``# lint-ranks`` (else ``ranks``), its ``# lint-args``, then ``--device
    cpu``."""

    return [(_lint_ranks(s, ranks), (str(s), *_lint_args(s), "--device", "cpu"))
            for s in _scripts(paths)]


def _relative(path: Path) -> str:
    try:
        return str(path.relative_to(ROOT))
    except ValueError:
        return str(path)


#: the default dynamic targets: the example scripts, then the CLIs
DEFAULT_TARGETS: tuple[tuple[int, tuple[str, ...]], ...] = (
    *((r, (_relative(Path(a[0])), *a[1:]))
      for r, a in script_targets([str(ROOT / "examples_torch")])),
    *CLI_TARGETS,
)


def lint_script(path: Path, *, timeout: int = 900) -> list[Finding]:
    """Run one script under recording, in one process (a rank of one), as
    the reference runs each of its examples: its event-graph findings,
    reported on the :data:`MARKER` line.  A script that does not finish in
    ``timeout`` seconds, exits non-zero or reports no findings line is a
    finding itself.  :func:`lint_target` runs a target on several ranks."""

    try:
        proc = subprocess.run(
            [sys.executable, "-c", _RUNNER, str(path), *_lint_args(path)],
            capture_output=True, text=True, env=_env(), timeout=timeout, cwd=str(ROOT),
        )
    except subprocess.TimeoutExpired:
        return [Finding(
            ErrorClass.ERR_OTHER, "script-timeout",
            f"did not finish within {timeout}s under recording", str(path),
        )]
    findings: list[Finding] = []
    payload = None
    for line in proc.stdout.splitlines():
        if line.startswith(MARKER):
            payload = json.loads(line[len(MARKER):])
    if proc.returncode != 0:
        tail = proc.stderr.strip().splitlines()
        findings.append(Finding(
            ErrorClass.ERR_OTHER, "script-failed",
            f"exited {proc.returncode}: {tail[-1] if tail else 'no stderr'}", str(path),
        ))
    if payload is None:
        if proc.returncode == 0:
            findings.append(Finding(
                ErrorClass.ERR_OTHER, "no-findings-channel",
                f"script produced no {MARKER.strip()} line", str(path),
            ))
    else:
        for f in payload:
            findings.append(Finding(
                ErrorClass[f["code"]], f["check"], f["message"],
                f.get("subject") or str(path),
            ))
    return findings


def lint_target(ranks: int, argv: tuple[str, ...], *, timeout: int = 900) -> list[Finding]:
    """Run one target on ``ranks`` ranks under recording; the event-graph
    findings over its ranks' merged ledgers."""

    from repro_torch.analysis import checkers, events

    subject = " ".join(argv) + (f" [{ranks} ranks]" if ranks > 1 else "")
    findings: list[Finding] = []
    with tempfile.TemporaryDirectory(prefix="repro_lint_") as out_dir:
        try:
            proc = subprocess.run(_command(ranks, argv, out_dir), capture_output=True,
                                  text=True, env=_env(), timeout=timeout, cwd=str(ROOT))
        except subprocess.TimeoutExpired:
            findings.append(Finding(
                ErrorClass.ERR_OTHER, "script-timeout",
                f"did not finish within {timeout}s under recording", subject,
            ))
            proc = None
        if proc is not None and proc.returncode != 0:
            tail = proc.stderr.strip().splitlines()
            findings.append(Finding(
                ErrorClass.ERR_OTHER, "script-failed",
                f"exited {proc.returncode}: {tail[-1] if tail else 'no stderr'}", subject,
            ))
        files = sorted(Path(out_dir).glob(LEDGER_FILE.format(rank="*")))
        if len(files) < ranks and proc is not None and proc.returncode == 0:
            findings.append(Finding(
                ErrorClass.ERR_OTHER, "no-findings-channel",
                f"{len(files)} of {ranks} ranks wrote a ledger", subject,
            ))
        merged = events.merge(events.load(f) for f in files)
        for f in checkers.run_all(merged):
            findings.append(Finding(f.code, f.check, f.message, f.subject or subject))
    return findings


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--record"]:
        # one rank of a target (started by lint_target)
        out_dir, rest = argv[1], argv[2:]
        return record(out_dir, rest[1:] if rest[:1] == ["--"] else rest)

    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="communication-correctness lint: static meta-checks + "
                    "event-graph analysis of recorded runs",
    )
    ap.add_argument("paths", nargs="*", default=[],
                    help="scripts or directories to run under recording (default: "
                         "examples_torch/, then the port's CLIs at smoke size on the CPU)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks a script runs on where its head names none "
                         "(# lint-ranks: N)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on any finding")
    ap.add_argument("--no-run", action="store_true",
                    help="static meta-checks only; skip running targets")
    ap.add_argument("--static-paths", nargs="*",
                    default=["src/repro_torch", "chip_smoke.py", "tools"],
                    help="trees for the static meta-checks")
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args(argv)

    from repro_torch.analysis.static import run_static

    findings = run_static([ROOT / p for p in args.static_paths])
    if args.no_run:
        targets: list = []
    elif args.paths:
        targets = script_targets(args.paths, ranks=args.ranks)
    else:
        targets = list(DEFAULT_TARGETS)
    for ranks, target in targets:
        print(f"[lint] {' '.join(target)} ({ranks} rank{'s' if ranks > 1 else ''})",
              flush=True)
        findings.extend(lint_target(ranks, target, timeout=args.timeout))

    for f in findings:
        print(f"  {f}")
    n = len(findings)
    print(f"[lint] {len(targets)} target(s) analyzed, {n} finding(s)")
    return 1 if (args.strict and n) else 0


if __name__ == "__main__":
    raise SystemExit(main())
