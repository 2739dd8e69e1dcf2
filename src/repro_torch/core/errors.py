"""Error handling (paper §II, C5).

The paper converts MPI return codes into exceptions carrying an *error code*
that derives from an *error class*, with default codes scoped in the
``mpi::error`` namespace, and the whole machinery opt-in at compile time via a
macro.  The JAX analogue: validation runs at *trace time* (the closest thing
to compile time Python has) and raises typed exceptions; it is toggled by
:func:`set_error_checking` / the ``error_checking`` control variable in
:mod:`repro.core.tool` (the macro analogue).  Checks are zero-cost when
disabled and zero-*runtime*-cost when enabled — they never emit ops.
"""

from __future__ import annotations

import enum
from typing import Any, NoReturn


class ErrorClass(enum.IntEnum):
    """MPI 4.0 §9.4 error classes (the subset meaningful under SPMD)."""

    SUCCESS = 0
    ERR_BUFFER = 1
    ERR_COUNT = 2
    ERR_TYPE = 3
    ERR_TAG = 4
    ERR_COMM = 5
    ERR_RANK = 6
    ERR_REQUEST = 7
    ERR_ROOT = 8
    ERR_OP = 9
    ERR_GROUP = 10
    ERR_TOPOLOGY = 11
    ERR_DIMS = 12
    ERR_ARG = 13
    ERR_PENDING = 14
    ERR_TRUNCATE = 15
    ERR_IN_STATUS = 18
    ERR_FILE = 30
    ERR_NO_MEM = 34
    ERR_NOT_SAME = 35
    ERR_IO = 39
    ERR_WIN = 45
    ERR_UNSUPPORTED_OPERATION = 52
    ERR_RMA_RANGE = 55
    ERR_RMA_ATTACH = 56
    ERR_SESSION = 78
    # ULFM fault-tolerance classes (MPI 4.x errhandler proposal): a peer
    # process failed, or the communicator was revoked by the recovery
    # protocol and must be rebuilt from a shrunken group
    ERR_PROC_FAILED = 75
    ERR_REVOKED = 76
    ERR_OTHER = 16


class Error(Exception):
    """Base exception; carries an :class:`ErrorClass` (``error.klass``) and a
    code (``error.code``) as the paper's exceptions do."""

    klass: ErrorClass = ErrorClass.ERR_OTHER

    def __init__(self, message: str, *, code: int | None = None):
        super().__init__(f"[{self.klass.name}] {message}")
        self.code = self.klass.value if code is None else code
        self.message = message


class BufferError_(Error):
    klass = ErrorClass.ERR_BUFFER


class CountError(Error):
    klass = ErrorClass.ERR_COUNT


class TypeError_(Error):
    klass = ErrorClass.ERR_TYPE


class CommError(Error):
    klass = ErrorClass.ERR_COMM


class RankError(Error):
    klass = ErrorClass.ERR_RANK


class RequestError(Error):
    klass = ErrorClass.ERR_REQUEST


class RootError(Error):
    klass = ErrorClass.ERR_ROOT


class OpError(Error):
    klass = ErrorClass.ERR_OP


class TopologyError(Error):
    klass = ErrorClass.ERR_TOPOLOGY


class DimsError(Error):
    klass = ErrorClass.ERR_DIMS


class ArgError(Error):
    klass = ErrorClass.ERR_ARG


class PendingError(Error):
    klass = ErrorClass.ERR_PENDING


class TruncateError(Error):
    klass = ErrorClass.ERR_TRUNCATE


class FileError(Error):
    klass = ErrorClass.ERR_FILE


class IoError(Error):
    klass = ErrorClass.ERR_IO


class NoMemError(Error):
    klass = ErrorClass.ERR_NO_MEM


class WinError(Error):
    klass = ErrorClass.ERR_WIN


class RmaRangeError(Error):
    klass = ErrorClass.ERR_RMA_RANGE


class RmaAttachError(Error):
    klass = ErrorClass.ERR_RMA_ATTACH


class UnsupportedError(Error):
    klass = ErrorClass.ERR_UNSUPPORTED_OPERATION


class GroupError(Error):
    klass = ErrorClass.ERR_GROUP


class SessionError(Error):
    klass = ErrorClass.ERR_SESSION


class ProcFailedError(Error):
    klass = ErrorClass.ERR_PROC_FAILED


class RevokedError(Error):
    klass = ErrorClass.ERR_REVOKED


#: ``mpi::error`` namespace analogue — default codes as scoped variables.
buffer = ErrorClass.ERR_BUFFER
count = ErrorClass.ERR_COUNT
type = ErrorClass.ERR_TYPE  # noqa: A001 — mirrors mpi::error::type
comm = ErrorClass.ERR_COMM
rank = ErrorClass.ERR_RANK
request = ErrorClass.ERR_REQUEST
root = ErrorClass.ERR_ROOT
op = ErrorClass.ERR_OP
topology = ErrorClass.ERR_TOPOLOGY
dims = ErrorClass.ERR_DIMS
arg = ErrorClass.ERR_ARG
pending = ErrorClass.ERR_PENDING
truncate = ErrorClass.ERR_TRUNCATE
file = ErrorClass.ERR_FILE
no_mem = ErrorClass.ERR_NO_MEM
io = ErrorClass.ERR_IO
win = ErrorClass.ERR_WIN
rma_range = ErrorClass.ERR_RMA_RANGE
rma_attach = ErrorClass.ERR_RMA_ATTACH
group = ErrorClass.ERR_GROUP
session = ErrorClass.ERR_SESSION
proc_failed = ErrorClass.ERR_PROC_FAILED
revoked = ErrorClass.ERR_REVOKED
other = ErrorClass.ERR_OTHER


_CLASS_TO_EXC: dict[ErrorClass, Any] = {
    ErrorClass.ERR_BUFFER: BufferError_,
    ErrorClass.ERR_COUNT: CountError,
    ErrorClass.ERR_TYPE: TypeError_,
    ErrorClass.ERR_COMM: CommError,
    ErrorClass.ERR_RANK: RankError,
    ErrorClass.ERR_REQUEST: RequestError,
    ErrorClass.ERR_ROOT: RootError,
    ErrorClass.ERR_OP: OpError,
    ErrorClass.ERR_TOPOLOGY: TopologyError,
    ErrorClass.ERR_DIMS: DimsError,
    ErrorClass.ERR_ARG: ArgError,
    ErrorClass.ERR_PENDING: PendingError,
    ErrorClass.ERR_TRUNCATE: TruncateError,
    ErrorClass.ERR_FILE: FileError,
    ErrorClass.ERR_IO: IoError,
    ErrorClass.ERR_NO_MEM: NoMemError,
    ErrorClass.ERR_WIN: WinError,
    ErrorClass.ERR_RMA_RANGE: RmaRangeError,
    ErrorClass.ERR_RMA_ATTACH: RmaAttachError,
    ErrorClass.ERR_UNSUPPORTED_OPERATION: UnsupportedError,
    ErrorClass.ERR_GROUP: GroupError,
    ErrorClass.ERR_SESSION: SessionError,
    ErrorClass.ERR_PROC_FAILED: ProcFailedError,
    ErrorClass.ERR_REVOKED: RevokedError,
}


def exception(klass: ErrorClass, message: str) -> Error:
    """Build the exception type matching an error class."""

    return _CLASS_TO_EXC.get(klass, Error)(message)


_ERROR_CHECKING = True


def set_error_checking(enabled: bool) -> bool:
    """Toggle trace-time validation (the paper's compile-time macro).

    Returns the previous value so callers can restore it.
    """

    global _ERROR_CHECKING
    prev = _ERROR_CHECKING
    _ERROR_CHECKING = bool(enabled)
    return prev


def error_checking_enabled() -> bool:
    return _ERROR_CHECKING


def check(condition: bool, klass: ErrorClass, message: str) -> None:
    """Raise ``exception(klass, message)`` if checking is on and the
    condition is false.  Conditions must be trace-time static."""

    if _ERROR_CHECKING and not condition:
        raise exception(klass, message)


def fail(klass: ErrorClass, message: str) -> NoReturn:
    raise exception(klass, message)
