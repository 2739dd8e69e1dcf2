"""Event-graph checkers — the MUST-style lint passes over a recorded
:class:`~repro_torch.analysis.events.Ledger`, :mod:`repro.analysis.checkers`
for the port: the same checks, event kinds, :class:`Finding` and
``ErrorClass`` values.  Port-only: a point-to-point round recorded per rank
(``rank=``, every hook of the port) adds that rank's operations only, and
the k-th such round of a communicator on one rank matches the k-th on the
others (:func:`_expand_ops`), so that the merged ledger of a run's ranks
(:func:`repro_torch.analysis.events.merge`) is checked as the reference's
single-controller ledger is.

Each checker consumes the ledger and returns typed :class:`Finding`\\ s
carrying an :class:`~repro_torch.core.errors.ErrorClass`:

* :func:`check_collective_order` — cross-rank collective ordering/signature
  mismatch per communicator (``ERR_NOT_SAME``): every member rank must issue
  the same (op kind, dtype bucket) sequence on a communicator, the classic
  MUST collective-matching check.
* :func:`check_deadlock` — wait-for cycles and unmatched operations on the
  point-to-point matching graph (``ERR_PENDING``): combined ``send_recv``
  rounds complete atomically, but rounds lowered as unbuffered blocking
  sends (``mode="sync"``) deadlock exactly when the round's permutation
  contains a cycle; raw per-rank ``send``/``recv`` streams are matched by
  the standard non-overtaking simulation.  Illegal matching rounds (two
  sends out of one rank, two writes into one rank) are ``ERR_RANK``.
* :func:`check_future_lifecycle` — requests leaked or raced
  (``ERR_REQUEST`` / ``ERR_BUFFER``): TraceFutures dangling un-consumed at
  trace exit, and ``MPI_Start`` re-fires of a *donated*
  :class:`~repro_torch.core.futures.PersistentRequest` while a previous start's
  future is still unconsumed (the ``then()`` chain would read
  donated-over buffers).
* :func:`check_rma_epochs` — one-sided synchronization defects beyond the
  runtime per-epoch ledger (``ERR_WIN`` / ``ERR_RMA_ATTACH``): a put issued
  in one fence epoch but applied in a later one (a ``then()`` continuation
  escaping its epoch), and dynamic-window attach/detach imbalance at trace
  exit (KV blocks never released).
* :func:`check_io_joins` — split collectives begun but never ended and
  checkpoint saves never joined (``ERR_IO``): a torn save that exits the
  trace un-waited is indistinguishable from data loss.

:func:`run_all` aggregates every checker, in this order.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Sequence

from repro_torch.analysis.events import Ledger, ledger as _default_ledger
from repro_torch.core.errors import ErrorClass


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding: a typed defect with its evidence."""

    code: ErrorClass
    check: str
    message: str
    subject: str = ""

    def as_dict(self) -> dict[str, Any]:
        return {
            "code": self.code.name,
            "check": self.check,
            "message": self.message,
            "subject": self.subject,
        }

    def __str__(self) -> str:
        sub = f" [{self.subject}]" if self.subject else ""
        return f"{self.code.name} {self.check}{sub}: {self.message}"


# ---------------------------------------------------------------------------
# (a) collective order / signature matching
# ---------------------------------------------------------------------------


def check_collective_order(ledger: Ledger | None = None) -> list[Finding]:
    ledger = ledger or _default_ledger()
    seqs: dict[str, dict[int, list[tuple[str, tuple]]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for ev in ledger.of_kind("collective"):
        for r in ev.ranks or ():
            seqs[ev.comm][int(r)].append((ev.op, tuple(ev.data.get("bucket", ()))))
    findings: list[Finding] = []
    for comm, by_rank in seqs.items():
        ranks = sorted(by_rank)
        ref_rank = ranks[0]
        ref = by_rank[ref_rank]
        for r in ranks[1:]:
            seq = by_rank[r]
            for i, (a, b) in enumerate(zip(ref, seq)):
                if a[0] != b[0]:
                    findings.append(Finding(
                        ErrorClass.ERR_NOT_SAME, "collective-order",
                        f"rank {ref_rank} issues {a[0]} as collective #{i} "
                        f"but rank {r} issues {b[0]} — mismatched collective "
                        f"order across ranks", comm,
                    ))
                    break
                if a[1] != b[1]:
                    findings.append(Finding(
                        ErrorClass.ERR_NOT_SAME, "collective-signature",
                        f"collective #{i} ({a[0]}) has dtype bucket {a[1]} on "
                        f"rank {ref_rank} but {b[1]} on rank {r} — mismatched "
                        f"datatype signature", comm,
                    ))
                    break
            else:
                if len(ref) != len(seq):
                    findings.append(Finding(
                        ErrorClass.ERR_NOT_SAME, "collective-order",
                        f"rank {ref_rank} issues {len(ref)} collectives but "
                        f"rank {r} issues {len(seq)} — some ranks hang in a "
                        f"collective the others never enter", comm,
                    ))
    return findings


# ---------------------------------------------------------------------------
# (b) deadlock detection on the point-to-point matching graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Op:
    kind: str            # "send" | "recv" | "xchg"
    rank: int
    peer: int = -1       # send → destination, recv → source
    round_id: int = -1   # xchg ops complete round-atomically


def _round_legal(perm: Sequence[tuple[int, int]]) -> str | None:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs):
        return "an origin sends twice in one matching round"
    if len(set(dsts)) != len(dsts):
        return "a target is written twice in one matching round"
    return None


def _expand_ops(ledger: Ledger) -> tuple[dict[tuple[str, int], list[_Op]], list[Finding],
                                         dict[int, list[int]]]:
    """Per-(comm, rank) ordered op queues from the recorded rounds/streams,
    and each sendrecv round's members (every rank of its permutation: a
    member that never recorded a per-rank round holds the others in it)."""

    queues: dict[tuple[str, int], list[_Op]] = defaultdict(list)
    members: dict[int, list[int]] = {}
    findings: list[Finding] = []
    round_ids = 0
    # per-rank rounds: (comm, rank) -> rounds seen; (comm, k) -> round id
    seen: dict[tuple[str, int], int] = defaultdict(int)
    shared: dict[tuple[str, int], int] = {}
    for ev in ledger.events:
        if ev.kind == "p2p_round":
            perm = [tuple(p) for p in ev.data["perm"]]
            own = ev.ranks[0] if ev.ranks and len(ev.ranks) == 1 else None
            if own is not None:
                key = (ev.comm, seen[(ev.comm, own)])
                seen[(ev.comm, own)] += 1
                first = key not in shared
                if first:
                    round_ids += 1
                    shared[key] = round_ids
                rid = shared[key]
            else:
                first, rid = True, round_ids + 1
            illegal = _round_legal(perm)
            if illegal:
                if first:   # once a round, not once a rank that recorded it
                    findings.append(Finding(
                        ErrorClass.ERR_RANK, "matching-round",
                        f"{ev.op} round {perm}: {illegal}", ev.comm,
                    ))
                continue

            def mine(r: int, own=own) -> bool:
                return own is None or r == own

            if ev.data.get("mode", "sendrecv") == "sendrecv":
                round_ids = max(round_ids, rid)
                members[rid] = sorted({r for pair in perm for r in pair})
                for r in members[rid]:
                    queues[(ev.comm, r)]     # a member's queue, if only empty
                for s, d in perm:
                    if mine(s):
                        queues[(ev.comm, s)].append(
                            _Op("xchg", s, peer=d, round_id=rid))
                    if d != s and mine(d):
                        queues[(ev.comm, d)].append(
                            _Op("xchg", d, peer=s, round_id=rid))
            else:   # "sync": unbuffered blocking sends issued before receives
                for s, d in perm:
                    if mine(s):
                        queues[(ev.comm, s)].append(_Op("send", s, peer=d))
                for s, d in perm:
                    if mine(d):
                        queues[(ev.comm, d)].append(_Op("recv", d, peer=s))
        elif ev.kind in ("send", "recv"):
            r = (ev.ranks or (0,))[0]
            queues[(ev.comm, int(r))].append(
                _Op(ev.kind, int(r), peer=int(ev.data["peer"])))
    return queues, findings, members


def check_deadlock(ledger: Ledger | None = None) -> list[Finding]:
    ledger = ledger or _default_ledger()
    queues, findings, round_members = _expand_ops(ledger)
    # simulate matching per communicator independently
    comms = sorted({c for c, _ in queues})
    for comm in comms:
        ranks = sorted(r for c, r in queues if c == comm)
        ptr = {r: 0 for r in ranks}

        def current(r: int) -> _Op | None:
            q = queues[(comm, r)]
            return q[ptr[r]] if ptr[r] < len(q) else None

        progress = True
        while progress:
            progress = False
            # 1. blocking send/recv pairs whose partners are both current
            for r in ranks:
                op = current(r)
                if op is None or op.kind != "send":
                    continue
                partner = current(op.peer) if op.peer in ptr else None
                if partner is not None and partner.kind == "recv" and partner.peer == r:
                    ptr[r] += 1
                    ptr[op.peer] += 1
                    progress = True
            # 2. sendrecv rounds: complete when every participant is at the round
            pending_rounds: dict[int, list[int]] = defaultdict(list)
            for r in ranks:
                op = current(r)
                if op is not None and op.kind == "xchg":
                    pending_rounds[op.round_id].append(r)
            for rid, members in pending_rounds.items():
                all_here = all(
                    (cur := current(r)) is not None and cur.kind == "xchg"
                    and cur.round_id == rid
                    for r in round_members[rid]
                )
                if all_here:
                    # a rank that is both origin and target of the round holds
                    # several contiguous xchg ops for it — drain them all
                    for r in round_members[rid]:
                        q = queues[(comm, r)]
                        while (ptr[r] < len(q) and q[ptr[r]].kind == "xchg"
                               and q[ptr[r]].round_id == rid):
                            ptr[r] += 1
                    progress = True
                    break
        blocked = {r: current(r) for r in ranks if current(r) is not None}
        if not blocked:
            continue
        cycle = _wait_cycle(blocked)
        if cycle:
            path = " -> ".join(str(r) for r in cycle)
            findings.append(Finding(
                ErrorClass.ERR_PENDING, "deadlock",
                f"wait-for cycle {path}: every rank in the cycle is blocked "
                f"in an unbuffered send/recv waiting on the next — the "
                f"schedule deadlocks (use the combined send_recv form or "
                f"reorder the rounds)", comm,
            ))
        else:
            detail = ", ".join(
                f"rank {r} blocked in {op.kind}"
                f"{' to' if op.kind == 'send' else ' from'} {op.peer}"
                for r, op in sorted(blocked.items())
            )
            findings.append(Finding(
                ErrorClass.ERR_PENDING, "unmatched-p2p",
                f"operations never matched: {detail} — the partner never "
                f"issues the matching call", comm,
            ))
    return findings


def _wait_cycle(blocked: dict[int, _Op]) -> list[int] | None:
    """A cycle in the wait-for graph of blocked ranks (each waits on its
    partner), or None if the stall is an unmatched op, not a cycle."""

    waits: dict[int, int] = {}
    for r, op in blocked.items():
        if op.peer in blocked:
            waits[r] = op.peer
    seen: dict[int, int] = {}
    for start in waits:
        path: list[int] = []
        r = start
        while r in waits and r not in seen:
            seen[r] = start
            path.append(r)
            r = waits[r]
        if r in path:       # closed a cycle within this walk
            return path[path.index(r):] + [r]
    return None


# ---------------------------------------------------------------------------
# (c) future / request lifecycle
# ---------------------------------------------------------------------------


def check_future_lifecycle(ledger: Ledger | None = None) -> list[Finding]:
    ledger = ledger or _default_ledger()
    findings: list[Finding] = []
    created: dict[int, str] = {}
    for ev in ledger.of_kind("tf_create"):
        created[ev.data["token"]] = ev.data.get("label", "")
    for ev in ledger.of_kind("tf_consume"):
        created.pop(ev.data["token"], None)
    if created:
        labels = sorted(set(filter(None, created.values()))) or ["<anonymous>"]
        findings.append(Finding(
            ErrorClass.ERR_REQUEST, "dangling-future",
            f"{len(created)} TraceFuture(s) never consumed at trace exit "
            f"(never forced by get()/then()/when_all — their communication "
            f"is silently dropped from the program): {', '.join(labels[:6])}",
        ))
    donated: dict[int, str] = {}
    for ev in ledger.of_kind("preq_init"):
        if ev.data.get("donated"):
            donated[ev.data["token"]] = ev.data.get("label", "")
    for ev in ledger.of_kind("preq_start"):
        if ev.data.get("donated") and ev.data.get("prev_outstanding"):
            label = donated.get(ev.data["token"], "")
            findings.append(Finding(
                ErrorClass.ERR_BUFFER, "donated-start-race",
                f"persistent request{f' {label!r}' if label else ''} with "
                f"donated buffers re-started while a previous start's future "
                f"is still unconsumed — the outstanding then() chain reads "
                f"donated-over memory",
            ))
    return findings


# ---------------------------------------------------------------------------
# (d) RMA epoch discipline
# ---------------------------------------------------------------------------


def check_rma_epochs(ledger: Ledger | None = None) -> list[Finding]:
    ledger = ledger or _default_ledger()
    findings: list[Finding] = []
    for ev in ledger.of_kind("rma_apply"):
        if ev.data["issue_epoch"] != ev.data["apply_epoch"]:
            findings.append(Finding(
                ErrorClass.ERR_WIN, "cross-epoch-put",
                f"put issued in fence epoch {ev.data['issue_epoch']} but "
                f"applied in epoch {ev.data['apply_epoch']} — a then() "
                f"continuation escaped its access epoch (complete the chain "
                f"before the closing fence)", f"win:{ev.data['win']}",
            ))
    attached: dict[int, int] = defaultdict(int)
    for ev in ledger.of_kind("rma_attach"):
        attached[ev.data["win"]] += ev.data["count"]
    for ev in ledger.of_kind("rma_detach"):
        attached[ev.data["win"]] -= ev.data["count"]
    for win, balance in sorted(attached.items()):
        if balance != 0:
            findings.append(Finding(
                ErrorClass.ERR_RMA_ATTACH, "attach-detach-imbalance",
                f"dynamic window ends the trace with {balance:+d} "
                f"attach/detach imbalance — pages (KV blocks) registered but "
                f"never released", f"win:{win}",
            ))
    return findings


# ---------------------------------------------------------------------------
# (e) file I/O / checkpoint joins
# ---------------------------------------------------------------------------


def check_io_joins(ledger: Ledger | None = None) -> list[Finding]:
    ledger = ledger or _default_ledger()
    findings: list[Finding] = []
    open_splits: dict[str, str] = {}
    for ev in ledger.of_kind("io_split_begin", "io_split_end"):
        key = ev.data["path"]
        if ev.kind == "io_split_begin":
            open_splits[key] = ev.data["name"]
        else:
            open_splits.pop(key, None)
    for path, name in sorted(open_splits.items()):
        findings.append(Finding(
            ErrorClass.ERR_IO, "split-collective-open",
            f"split collective on {name!r} begun but never ended — the "
            f"*_at_all_end call is missing", path,
        ))
    saves: dict[int, int] = defaultdict(int)
    for ev in ledger.of_kind("ckpt_save"):
        saves[ev.data["mgr"]] += 1
    for ev in ledger.of_kind("ckpt_join"):
        saves[ev.data["mgr"]] = 0
    for mgr, n in sorted(saves.items()):
        if n > 0:
            findings.append(Finding(
                ErrorClass.ERR_IO, "unjoined-save",
                f"{n} checkpoint save(s) in flight at trace exit and never "
                f"joined — a torn save would read as success (call "
                f"manager.wait())", f"ckpt:{mgr}",
            ))
    return findings


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

ALL_CHECKS = (
    check_collective_order,
    check_deadlock,
    check_future_lifecycle,
    check_rma_epochs,
    check_io_joins,
)


def run_all(ledger: Ledger | None = None) -> list[Finding]:
    """Every event-graph checker over one ledger, findings concatenated."""

    ledger = ledger or _default_ledger()
    findings: list[Finding] = []
    for chk in ALL_CHECKS:
        findings.extend(chk(ledger))
    return findings
