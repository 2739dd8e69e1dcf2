"""The port's analyzer (``repro_torch.analysis``) against the reference's
(``repro.analysis``): the seeded-defect suite of ``tests/test_analysis.py``
with every event recorded per rank, as the port's hooks record them — each
checker fires on its defect with the reference's ``ErrorClass`` and stays
silent on the clean variant — the deadlock property (hypothesis), the
ledger files and their merge, the interface's hooks end to end on 4 gloo
ranks (a reordered collective on one rank is ``ERR_NOT_SAME`` from the
merged ledgers), the static meta-checks over the port, and the lint CLI.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import checkers as jcheckers
from repro.analysis import events as jevents
from repro_torch.analysis import checkers, events, lint, static
from repro_torch.core import errors, tool
from repro_torch.core.errors import ErrorClass
from torch_ranks import run_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
ROUND = [(0, 1), (1, 2), (2, 0)]          # 3-cycle permutation


@pytest.fixture()
def recording():
    """Fresh ledger with recording on (via the cvar, so the MPI_T path is
    exercised); everything restored afterwards."""

    events.reset()
    tool.cvar_set("analysis_recording", True)
    try:
        yield events.ledger()
    finally:
        tool.cvar_set("analysis_recording", False)
        events.reset()


def codes(findings, check=None):
    return [f.code for f in findings if check is None or f.check == check]


def round_per_rank(comm, perm, *, mode, size):
    """One matching round as the port's hooks record it: every rank of the
    communicator records its own part."""

    for r in range(size):
        events.record_p2p_round(comm, perm, mode=mode, size=size, rank=r)


def test_event_kinds_and_codes_are_the_references():
    assert [c.__name__ for c in checkers.ALL_CHECKS] == \
        [c.__name__ for c in jcheckers.ALL_CHECKS]
    f = checkers.Finding(ErrorClass.ERR_PENDING, "deadlock", "m", "s")
    j = jcheckers.Finding(jcheckers.ErrorClass.ERR_PENDING, "deadlock", "m", "s")
    assert f.as_dict() == j.as_dict() and str(f) == str(j)
    assert events.comm_id("c") == jevents.comm_id("c")


# ---------------------------------------------------------------------------
# recording toggle
# ---------------------------------------------------------------------------


def test_recording_off_by_default():
    assert tool.cvar_get("analysis_recording") is False
    assert events.RECORDING is False
    before = len(events.ledger())
    events.record_collective("c", "allreduce", rank=0)
    assert len(events.ledger()) == before, "recorded while disabled"


def test_cvar_toggles_recording(recording):
    assert events.RECORDING is True
    events.record_collective("c", "allreduce", rank=0)
    assert len(events.ledger()) == 1
    tool.cvar_set("analysis_recording", False)
    events.record_collective("c", "allreduce", rank=0)
    assert len(events.ledger()) == 1
    tool.cvar_set("analysis_recording", True)


# ---------------------------------------------------------------------------
# (a) collective order / signature
# ---------------------------------------------------------------------------


def test_clean_collective_order(recording):
    for r in range(4):
        events.record_collective("c", "allreduce", torch.zeros(3), rank=r)
        events.record_collective("c", "allgather", torch.zeros(3), rank=r)
    assert checkers.check_collective_order() == []


def test_mismatched_collective_order(recording):
    events.record_collective("c", "allreduce", rank=0)
    events.record_collective("c", "allgather", rank=0)
    events.record_collective("c", "allgather", rank=1)   # swapped on rank 1
    events.record_collective("c", "allreduce", rank=1)
    f = checkers.check_collective_order()
    assert codes(f, "collective-order") == [ErrorClass.ERR_NOT_SAME]


def test_mismatched_collective_signature(recording):
    events.record_collective("c", "allreduce", torch.zeros(3), rank=0)
    events.record_collective("c", "allreduce", torch.zeros(3, dtype=torch.int32), rank=1)
    f = checkers.check_collective_order()
    assert codes(f, "collective-signature") == [ErrorClass.ERR_NOT_SAME]


def test_collective_count_mismatch(recording):
    events.record_collective("c", "allreduce", rank=0)
    events.record_collective("c", "allreduce", rank=1)
    events.record_collective("c", "allreduce", rank=0)   # rank 1 never re-enters
    f = checkers.check_collective_order()
    assert codes(f, "collective-order") == [ErrorClass.ERR_NOT_SAME]


def test_dtype_bucket_of_an_aggregate():
    tree = {"b": torch.zeros(2, dtype=torch.bfloat16), "a": [np.zeros(2, np.float32), 3]}
    assert events.dtype_bucket(tree) == ("float32", "int", "torch.bfloat16")


# ---------------------------------------------------------------------------
# (b) deadlock, every round recorded per rank
# ---------------------------------------------------------------------------


def test_sendrecv_ring_is_clean(recording):
    round_per_rank("c", ROUND, mode="sendrecv", size=3)
    assert checkers.check_deadlock() == []


def test_sync_cycle_deadlocks(recording):
    round_per_rank("c", ROUND, mode="sync", size=3)
    f = checkers.check_deadlock()
    assert codes(f, "deadlock") == [ErrorClass.ERR_PENDING]
    assert "wait-for cycle" in f[0].message


def test_unmatched_send(recording):
    events.record_p2p("send", 0, 1, comm="c")
    f = checkers.check_deadlock()
    assert codes(f, "unmatched-p2p") == [ErrorClass.ERR_PENDING]


def test_matched_send_recv_stream(recording):
    events.record_p2p("send", 0, 1, comm="c")
    events.record_p2p("recv", 1, 0, comm="c")
    assert checkers.check_deadlock() == []


def test_illegal_matching_round(recording):
    round_per_rank("c", [(0, 1), (0, 2)], mode="sendrecv", size=3)
    f = checkers.check_deadlock()
    assert codes(f, "matching-round") == [ErrorClass.ERR_RANK]   # once, not once a rank


def test_a_rank_that_skips_a_round_leaves_the_others_unmatched(recording):
    """Per-rank rounds match in order: rank 2 never records the round its
    peers are in."""

    for r in (0, 1):
        events.record_p2p_round("c", ROUND, mode="sendrecv", size=3, rank=r)
    f = checkers.check_deadlock()
    assert codes(f) == [ErrorClass.ERR_PENDING]


def _partial_perms(n):
    """Every injective partial map on {0..n-1} as an edge list."""

    ranks = range(n)
    for k in range(n + 1):
        for srcs in itertools.combinations(ranks, k):
            for dsts in itertools.permutations(ranks, k):
                yield tuple(zip(srcs, dsts))


def _has_cycle(perm):
    nxt = dict(perm)
    for start in nxt:
        seen = set()
        r = start
        while r in nxt:
            if r in seen:
                return True
            seen.add(r)
            r = nxt[r]
    return False


def _check_deadlock_property(schedule):
    """The detector flags ERR_PENDING/deadlock iff some sync round of the
    schedule is cyclic, and stays silent otherwise — on the rounds recorded
    per rank (each rank its part), as on the reference's single-controller
    rounds, with the same verdict as the reference's checker."""

    jevents.reset()
    prev = jevents.set_recording(True)
    try:
        for mode, perm in schedule:
            jevents.record_p2p_round("c", perm, mode=mode, size=4)
    finally:
        jevents.set_recording(prev)
    want = jcheckers.check_deadlock()
    jevents.reset()

    events.reset()
    prev = events.set_recording(True)
    try:
        for mode, perm in schedule:
            round_per_rank("c", perm, mode=mode, size=4)
    finally:
        events.set_recording(prev)
    f = checkers.check_deadlock()
    events.reset()
    expected = any(m == "sync" and _has_cycle(p) for m, p in schedule)
    flagged = any(x.check == "deadlock" for x in f)
    assert flagged == expected, (schedule, [str(x) for x in f])
    if expected:
        assert ErrorClass.ERR_PENDING in codes(f, "deadlock")
    else:
        assert f == [], (schedule, [str(x) for x in f])
    assert [(x.code.name, x.check) for x in f] == [(x.code.name, x.check) for x in want]


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_perm_st = st.builds(
    lambda pairs: tuple(zip([s for s, _ in pairs], [d for _, d in pairs])),
    st.lists(st.tuples(st.integers(0, 3), st.integers(0, 3)), max_size=4),
).filter(
    lambda p: len({s for s, _ in p}) == len(p)
    and len({d for _, d in p}) == len(p)
)


@settings(max_examples=300, deadline=None)
@given(st.lists(
    st.tuples(st.sampled_from(["sync", "sendrecv"]), _perm_st),
    min_size=1, max_size=3,
))
def test_deadlock_detector_property(schedule):
    _check_deadlock_property(schedule)


@pytest.mark.parametrize("schedule", [
    # acyclic sync chain after a legal sendrecv ring
    [("sendrecv", ((0, 1), (1, 2), (2, 0))), ("sync", ((0, 1), (1, 2)))],
    # cycle buried in the second round
    [("sync", ((0, 1),)), ("sync", ((1, 2), (2, 1)))],
    # self-loop is a 1-cycle
    [("sync", ((2, 2),))],
    # reversal across rounds is fine: round 1 completes before round 2
    [("sync", ((0, 1),)), ("sync", ((1, 0),))],
    # the same ring is legal combined, fatal unbuffered
    [("sendrecv", ((0, 1), (1, 0))), ("sync", ((0, 1), (1, 0)))],
])
def test_deadlock_detector_multi_round(schedule):
    _check_deadlock_property(schedule)


def test_deadlock_detector_every_single_round_of_three():
    for mode in ("sync", "sendrecv"):
        for perm in _partial_perms(3):
            _check_deadlock_property([(mode, perm)])


# ---------------------------------------------------------------------------
# (c) future / request lifecycle
# ---------------------------------------------------------------------------


def test_dangling_future(recording):
    t = events.next_token()
    events.record_future_create(t, "immediate_allreduce", rank=0)
    f = checkers.check_future_lifecycle()
    assert codes(f, "dangling-future") == [ErrorClass.ERR_REQUEST]
    assert "immediate_allreduce" in f[0].message


def test_consumed_future_clean(recording):
    t = events.next_token()
    events.record_future_create(t, "immediate_allreduce", rank=0)
    events.record_future_consume(t, "get", rank=0)
    assert checkers.check_future_lifecycle() == []


def test_donated_start_race(recording):
    t = events.next_token()
    events.record_persistent_init(t, donated=True, rank=0)
    events.record_persistent_start(
        t, donated=True, prev_outstanding=True, has_continuations=True, rank=0)
    f = checkers.check_future_lifecycle()
    assert codes(f, "donated-start-race") == [ErrorClass.ERR_BUFFER]


def test_donated_start_sequential_clean(recording):
    t = events.next_token()
    events.record_persistent_init(t, donated=True, rank=0)
    for _ in range(3):
        events.record_persistent_start(
            t, donated=True, prev_outstanding=False, has_continuations=False, rank=0)
    assert checkers.check_future_lifecycle() == []


def test_interface_futures_and_persistent_starts(recording):
    """The port's own futures: an immediate collective's future and a
    persistent start's, consumed or not, and a start fired while the
    previous start's future is unconsumed."""

    from repro_torch.core.communicator import world

    comm = world(device_type="cpu")
    x = torch.ones(4)
    comm.immediate_allreduce(x).get()
    comm.immediate_allreduce(x).then(lambda f: f.get()).get()
    assert checkers.run_all() == []
    req = comm.persistent(lambda t: t * 2, x)
    first = req.start(x)
    second = req.start(x)                 # the first is still unconsumed
    second.get()
    f = checkers.run_all()
    assert codes(f) == [ErrorClass.ERR_REQUEST], [str(x) for x in f]
    assert "persistent_start" in f[0].message
    first.get()
    assert checkers.run_all() == []
    donated = comm.persistent(lambda t: t * 2, x, donate_argnums=(0,))
    pending = donated.start(x)
    donated.start(x).get()
    assert codes(checkers.run_all()) == [ErrorClass.ERR_REQUEST, ErrorClass.ERR_BUFFER]
    pending.get()


# ---------------------------------------------------------------------------
# (d) RMA epochs
# ---------------------------------------------------------------------------


def test_cross_epoch_put(recording):
    # unreachable through the public API (fence completes the epoch's
    # requests before the epoch increments) — seeded at the ledger layer
    events.record_rma_apply(1, issue_epoch=0, apply_epoch=2, rank=0)
    f = checkers.check_rma_epochs()
    assert codes(f, "cross-epoch-put") == [ErrorClass.ERR_WIN]


def test_same_epoch_put_clean(recording):
    events.record_rma_apply(1, issue_epoch=1, apply_epoch=1, rank=0)
    assert checkers.check_rma_epochs() == []


def test_attach_detach_imbalance(recording):
    events.record_rma_pages("rma_attach", 7, 3, rank=0)
    f = checkers.check_rma_epochs()
    assert codes(f, "attach-detach-imbalance") == [ErrorClass.ERR_RMA_ATTACH]
    events.record_rma_pages("rma_detach", 7, 3, rank=0)
    assert checkers.check_rma_epochs() == []


def test_window_records_through_the_interface(recording):
    """A dynamic window of one rank: attach, a put and an rput in a fence
    epoch; the detach balances it."""

    from repro_torch.core.communicator import world
    from repro_torch.core.descriptors import WindowSpec
    from repro_torch.core.onesided import create_window

    comm = world(device_type="cpu")
    win = create_window(comm, torch.zeros(4, 2), WindowSpec(dynamic=True, num_pages=4))
    win.attach([0, 1])
    win.fence()
    win.put(torch.ones(4, 2), [(0, 0)], page=0)
    win.rput(torch.ones(4, 2), [(0, 0)], page=1)
    win.fence()
    kinds = [e.kind for e in events.ledger().events]
    assert kinds.count("rma_put") == 2 and kinds.count("rma_apply") == 2
    assert kinds.count("win_fence") == 2
    assert codes(checkers.run_all()) == [ErrorClass.ERR_RMA_ATTACH]
    win.detach([0, 1])
    assert checkers.run_all() == []


# ---------------------------------------------------------------------------
# (e) I/O and checkpoint joins
# ---------------------------------------------------------------------------


def test_open_split_collective(recording):
    events.record_io_split("io_split_begin", "/tmp/f.bin", "write_at_all", rank=0)
    f = checkers.check_io_joins()
    assert codes(f, "split-collective-open") == [ErrorClass.ERR_IO]
    events.record_io_split("io_split_end", "/tmp/f.bin", "write_at_all", rank=0)
    assert checkers.check_io_joins() == []


def test_unjoined_checkpoint_save(recording):
    events.record_ckpt("ckpt_save", 1, 0, rank=0)
    f = checkers.check_io_joins()
    assert codes(f, "unjoined-save") == [ErrorClass.ERR_IO]
    events.record_ckpt("ckpt_join", 1, rank=0)
    assert checkers.check_io_joins() == []


def test_checkpoint_save_and_join_through_the_interface(recording, tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.save(1, {"w": torch.ones(3)})
    assert codes(checkers.run_all()) == [ErrorClass.ERR_IO]
    mgr.wait()
    assert checkers.run_all() == []


# ---------------------------------------------------------------------------
# per-rank ledger files and their merge
# ---------------------------------------------------------------------------


def test_ledger_files_round_trip_and_merge_keys_local_ids_by_rank(tmp_path):
    paths = []
    for r in range(2):
        led = events.Ledger()
        led.append("tf_create", ranks=(r,), data={"token": 1, "label": "x"})
        if r == 0:
            led.append("tf_consume", ranks=(r,), data={"token": 1, "how": "get"})
        led.append("collective", comm="c", op="allreduce", ranks=(r,),
                   data={"bucket": ("float32",)})
        led.append("p2p_round", comm="c", op="send_recv", ranks=(r,),
                   data={"perm": ((0, 1), (1, 0)), "mode": "sendrecv", "size": 2})
        paths.append(events.dump(tmp_path / f"rank{r}.jsonl", led))
    merged = events.merge(events.load(p) for p in paths)
    assert len(merged) == 7
    f = checkers.run_all(merged)
    # rank 1's token 1 is its own future (not rank 0's, consumed): dangling
    assert codes(f) == [ErrorClass.ERR_REQUEST], [str(x) for x in f]


# ---------------------------------------------------------------------------
# integration: the interface's hooks on 4 gloo ranks, merged ledgers
# ---------------------------------------------------------------------------


def test_interface_recording_end_to_end(tmp_path):
    np.savez(tmp_path / "inputs.npz", workdir=np.array(str(tmp_path)))
    ranks = run_ranks("analysis", 4, tmp_path)
    # the clean program: each rank's ring send_recv and collectives matched
    clean = events.merge(events.load(tmp_path / f"clean{r}.jsonl") for r in range(4))
    kinds = {e.kind for e in clean.events}
    assert {"collective", "p2p_round", "tf_create", "tf_consume"} <= kinds
    assert {e.ranks for e in clean.of_kind("collective")} == {(r,) for r in range(4)}
    assert checkers.run_all(clean) == []
    # the defect: rank 1's two collectives swapped, and a leaked future a rank
    defect = events.merge(events.load(tmp_path / f"defect{r}.jsonl") for r in range(4))
    f = checkers.run_all(defect)
    assert sorted((x.code.name, x.check) for x in f) == [
        ("ERR_NOT_SAME", "collective-order"), ("ERR_REQUEST", "dangling-future")]
    order = next(x for x in f if x.check == "collective-order")
    assert "rank 0 issues allreduce" in order.message and "rank 1 issues reduce" in order.message
    assert "4 " in next(x for x in f if x.check == "dangling-future").message
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r]["clean"], ranks[0]["clean"])


# ---------------------------------------------------------------------------
# meta-checks: pvar registry and swallowed failures, over the port
# ---------------------------------------------------------------------------

PORT_TREES = [str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py"), str(ROOT / "tools")]


def test_every_written_pvar_is_registered():
    f = static.unregistered_pvars(PORT_TREES)
    assert f == [], [str(x) for x in f]


def test_no_swallowed_failures_in_the_port():
    f = static.swallowed_failures(PORT_TREES)
    assert f == [], [str(x) for x in f]


def test_pvar_strict_rejects_unregistered():
    prev = tool.pvar_strict(True)
    try:
        with pytest.raises(errors.Error) as ei:
            tool.pvar_count("definitely_not_a_registered_pvar")
        assert ei.value.klass == ErrorClass.ERR_ARG
        tool.pvar_count("persistent_start")     # registered: still fine
    finally:
        tool.pvar_strict(prev)


def test_static_scan_flags_seeded_defects(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "from repro_torch.core import tool\n"
        "try:\n    pass\nexcept Exception:\n    pass\n"
        "tool.pvar_count('never_registered_xyz')\n"
    )
    f = static.run_static([str(tmp_path)])
    assert ErrorClass.ERR_OTHER in codes(f, "swallowed-failure")
    assert ErrorClass.ERR_ARG in codes(f, "unregistered-pvar")
    ok = tmp_path / "ok.py"
    ok.write_text(
        "try:\n    pass\n"
        "except Exception:  # lint: allow-broad-except — reraised below\n"
        "    raise\n"
    )
    assert static.swallowed_failures([str(ok)]) == []


# ---------------------------------------------------------------------------
# the lint CLI
# ---------------------------------------------------------------------------


def test_lint_static_strict_over_the_port_is_clean(capsys):
    assert lint.main(["--no-run", "--strict"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


@pytest.mark.parametrize("target", lint.CLI_TARGETS, ids=lambda t: (
    f"{t[1][1].rsplit('.', 1)[1]}-{t[0]}rank"))
def test_lint_default_targets_give_no_findings(target):
    """The CLI targets, one case each; the example targets that precede
    them are run and checked by ``test_torch_examples_*.py`` (one run each
    serves the comparison with the reference and the lint's check)."""

    ranks, argv = target
    assert target in lint.DEFAULT_TARGETS
    assert lint.lint_target(ranks, argv) == []


def test_lint_defaults_are_the_examples_then_the_clis():
    """As the reference's lint defaults to ``examples/``, the port's to
    ``examples_torch/``: every script, on its head's ``# lint-ranks``, with
    its ``# lint-args`` and ``--device cpu``, then the three CLIs."""

    scripts = sorted((lint.ROOT / "examples_torch").glob("*.py"))
    names = sorted(p.name for p in (lint.ROOT / "examples").glob("*.py"))
    assert [p.name for p in scripts] == names and len(names) == 11
    examples = lint.DEFAULT_TARGETS[:len(scripts)]
    assert lint.DEFAULT_TARGETS[len(scripts):] == lint.CLI_TARGETS
    ranks = {"quickstart": 8, "elastic_train": 8, "session_train_serve": 4,
             "disaggregated_serve": 4, "pipeline_expert_train": 4, "long_context_train": 4,
             "serve_batched": 2, "fault_tolerant_train": 2, "async_checkpoint": 1,
             "continuous_batching_serve": 1, "train_lm": 1}
    for script, (n, argv) in zip(scripts, examples):
        assert argv[0] == f"examples_torch/{script.name}" and n == ranks[script.stem]
        assert argv[-2:] == ("--device", "cpu")
    train_lm = dict(zip(scripts, examples))[lint.ROOT / "examples_torch" / "train_lm.py"]
    assert train_lm[1][1:] == ("--small", "--steps", "60", "--device", "cpu")
    # the reference's lint-args line is kept as it is
    assert lint._lint_args(lint.ROOT / "examples" / "train_lm.py") == \
        lint._lint_args(lint.ROOT / "examples_torch" / "train_lm.py")


def test_lint_strict_over_an_example_path(capsys):
    """``python -m repro_torch.analysis.lint examples_torch/<script> --strict``
    runs the script as a default target runs it and finds nothing."""

    assert lint.main([str(lint.ROOT / "examples_torch" / "async_checkpoint.py"),
                      "--strict"]) == 0
    out = capsys.readouterr().out
    assert "async_checkpoint.py --device cpu (1 rank)" in out
    assert "1 target(s) analyzed, 0 finding(s)" in out


def test_lint_reports_a_failing_and_a_hanging_script(tmp_path):
    fails = tmp_path / "fails.py"
    fails.write_text("raise SystemExit(3)\n")
    f = lint.lint_target(1, (str(fails),), timeout=120)
    assert [(x.code, x.check) for x in f] == [(ErrorClass.ERR_OTHER, "script-failed")]
    hangs = tmp_path / "hangs.py"
    hangs.write_text("import time\ntime.sleep(60)\n")
    f = lint.lint_target(1, (str(hangs),), timeout=3)
    assert [(x.code, x.check) for x in f] == [(ErrorClass.ERR_OTHER, "script-timeout")]


def test_lint_merges_a_scripts_ranks(tmp_path):
    """A script on 2 ranks whose rank 0 records one collective fewer than
    rank 1 (it runs it with recording off, so the run completes): the
    merged ledgers report the count mismatch."""

    script = tmp_path / "extra.py"
    script.write_text(
        "import torch\n"
        "from repro_torch.analysis import events\n"
        "from repro_torch.core.communicator import world\n"
        "comm = world(device_type='cpu')\n"
        "comm.allreduce(torch.ones(2))\n"
        "events.set_recording(comm.rank() != 0)\n"
        "comm.allgather(torch.ones(2))\n"
        "events.set_recording(True)\n"
    )
    f = lint.lint_target(2, (str(script),), timeout=120)
    assert [(x.code, x.check) for x in f] == [(ErrorClass.ERR_NOT_SAME, "collective-order")], \
        [str(x) for x in f]
    assert "rank 0 issues 1 collectives but rank 1 issues 2" in f[0].message
