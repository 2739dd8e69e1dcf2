"""Source-level meta-checks: defects in *this repo's own code* rather than
in a recorded program — :mod:`repro.analysis.static` for the port, which
runs them over ``src/repro_torch``, ``chip_smoke.py`` and ``tools``
(:mod:`repro_torch.analysis.lint`).

* :func:`swallowed_failures` — ``except Exception:`` / bare ``except:``
  handlers that neither re-raise nor report: the handler converts a real
  failure into silence, the exact anti-pattern a typed error interface
  exists to kill.  A handler is fine if its body re-raises (``raise``),
  prints the traceback (top-level CLI guard), or the ``except`` line carries
  ``# lint: allow-broad-except`` with a justification.
* :func:`unregistered_pvars` — every *literal* pvar name passed to
  ``tool.pvar_count`` / ``tool.pvar_add`` in the tree must be registered in
  ``tool.PVARS`` (``pvar_register``): an undocumented counter is invisible
  to ``pvar_info`` and drifts silently.  Dynamically-formatted names
  (f-strings in the facade binder) are covered at runtime by
  ``tool.pvar_strict`` instead.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.analysis.checkers import Finding
from repro_torch.core.errors import ErrorClass

ALLOW_PRAGMA = "lint: allow-broad-except"


def _py_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True                       # bare except:
    if isinstance(t, ast.Name) and t.id in ("Exception", "BaseException"):
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in ("Exception", "BaseException")
                   for e in t.elts)
    return False


def _reports_or_reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in ("print_exc", "format_exc"):
                return True
    return False


def swallowed_failures(paths: Iterable[str | Path]) -> list[Finding]:
    findings: list[Finding] = []
    for path in _py_files(paths):
        src = path.read_text()
        lines = src.splitlines()
        try:
            tree = ast.parse(src, filename=str(path))
        except SyntaxError as exc:
            findings.append(Finding(
                ErrorClass.ERR_OTHER, "syntax",
                f"unparseable: {exc}", f"{path}",
            ))
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler) or not _is_broad(node):
                continue
            line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            if ALLOW_PRAGMA in line:
                continue
            if _reports_or_reraises(node):
                continue
            what = "bare except" if node.type is None else "except Exception"
            findings.append(Finding(
                ErrorClass.ERR_OTHER, "swallowed-failure",
                f"{what} swallows the error without re-raising or reporting "
                f"— catch the specific expected exception and let the rest "
                f"propagate", f"{path}:{node.lineno}",
            ))
    return findings


def _literal_pvar_writes(paths: Iterable[str | Path]) -> list[tuple[str, str]]:
    """(pvar name, file:line) for every literal pvar_count/pvar_add call."""

    writes: list[tuple[str, str]] = []
    for path in _py_files(paths):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            continue                      # reported by swallowed_failures
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if name not in ("pvar_count", "pvar_add"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                writes.append((arg.value, f"{path}:{node.lineno}"))
    return writes


def unregistered_pvars(paths: Iterable[str | Path]) -> list[Finding]:
    # importing the runtime/checkpoint layers runs their module-level
    # pvar_register calls, populating the registry the audit compares against
    import repro_torch.checkpoint.manager   # noqa: F401
    import repro_torch.core                 # noqa: F401
    import repro_torch.core.epoch           # noqa: F401
    import repro_torch.runtime.engine       # noqa: F401
    import repro_torch.runtime.kvpool       # noqa: F401
    import repro_torch.runtime.server       # noqa: F401
    import repro_torch.runtime.trainer      # noqa: F401
    import repro_torch.tune                 # noqa: F401
    from repro_torch.core import tool

    findings: list[Finding] = []
    for name, where in _literal_pvar_writes(paths):
        if name not in tool.PVARS:
            findings.append(Finding(
                ErrorClass.ERR_ARG, "unregistered-pvar",
                f"pvar {name!r} is written but never pvar_register()ed — "
                f"undocumented counters are invisible to pvar_info and "
                f"drift silently", where,
            ))
    return findings


def run_static(paths: Iterable[str | Path]) -> list[Finding]:
    paths = list(paths)
    return swallowed_failures(paths) + unregistered_pvars(paths)
