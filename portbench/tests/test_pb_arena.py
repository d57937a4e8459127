"""The arena that keeps every call's outputs until the check: each call in
its own slot, chunk after chunk where the window outruns the first; a
fault in a call past the first chunk still fails the run; the calls line
reports what the window allocated; the window issues calls ahead as far
as its lookahead and closes once every call has ended."""

import json

import torch

from portbench import run

CELL = "plicp_utm30lx.bag"


def test_the_arena_keeps_each_call_in_its_slot():
    outs = [{"pose": torch.full((2, 3), float(i)),
             "valid": torch.tensor([i % 2 == 0, True])} for i in range(5)]
    kept = run.Arena(outs[0], cap=2)
    for out in outs:
        kept.keep(out)
    assert len(kept.chunks) == 3
    assert all(chunk["pose"].shape == (2, 2, 3) for chunk in kept.chunks)
    for i, out in enumerate(outs):
        assert all(torch.equal(kept[i][k], v) for k, v in out.items())
    # a slot is 6 float32 poses and 2 flags; 6 slots made, 5 written
    assert kept.slot_bytes == 2 * 3 * 4 + 2
    assert kept.unfilled_bytes() == kept.slot_bytes


def _calls_line(info) -> dict:
    line = next(x for x in info if x.startswith("portbench calls "))
    return json.loads(line.split(" ", 2)[2])


def test_a_fault_past_the_first_chunk_fails_the_run(tiny_root, monkeypatch):
    cap = 3
    monkeypatch.setattr(run, "arena_calls", lambda seconds, fastest_s: cap)
    cell = run.find_cell(CELL, False, tiny_root)
    program = cell.entry.program
    made, first = [], {}

    def faulty(params, bag):
        call = program(params, bag)

        def wrapped(a, b):
            # the program's outputs of its first call of each chunk, so
            # that the short window makes many calls whatever the CPU's load
            if (a, b) not in first:
                first[a, b] = call(a, b)
            out = {k: v.clone() for k, v in first[a, b].items()}
            # the window's calls past the arena's first chunk: one pose
            # made NaN in each, the window's last call among them
            if len(made) >= 1 + run.PROBE_CALLS + cap:
                out["pose"][0] = float("nan")
            made.append((a, b))
            return out
        return wrapped

    cell.entry.program = faulty
    result, info, checks = run.run_cell(cell, 2**31 + 2**22 + 3, 0.05, False,
                                        "cpu")
    calls = _calls_line(info)
    n = result["attempted"] // 2  # TINY: 2 pairs a call
    assert n > cap, "the window made too few calls to outrun the arena"
    assert len(made) == 1 + run.PROBE_CALLS + n
    assert calls["arena_calls"] == cap
    assert calls["kept_chunks"] == -(-n // cap)
    assert result["failed"] == n - cap
    assert not result["correct"]
    assert any("FAILED" in c for c in checks)


def test_the_calls_line_reports_the_windows_allocations(tiny_root):
    cell = run.find_cell(CELL, False, tiny_root)
    result, info, _ = run.run_cell(cell, 2**31 + 2**22 + 4, 0.2, False, "cpu")
    calls = _calls_line(info)
    assert {"kept_chunks", "window_segments", "window_alloc_retries",
            "arena_calls", "probe_s", "arena_bytes", "arena_unfilled_bytes",
            "issue_median_s", "ahead_calls", "wait_s",
            "close_wait_s"} <= set(calls)
    assert calls["arena_unfilled_bytes"] < calls["arena_bytes"]
    assert len(calls["probe_s"]) == run.PROBE_CALLS
    assert calls["kept_chunks"] >= 1 and calls["arena_calls"] >= 1
    # the allocator's statistics exist on the card alone
    assert calls["window_segments"] is None
    assert calls["window_alloc_retries"] is None
    assert result["correct"] and result["failed"] == 0


def test_the_window_matches_each_chunk_of_the_bag_once(tiny_root):
    # TINY: 4 pairs in calls of 2; a window of no length makes both calls
    cell = run.find_cell(CELL, False, tiny_root)
    result, info, _ = run.run_cell(cell, 2**31 + 2**22 + 5, 0.0, False, "cpu")
    assert result["attempted"] == 4 and result["correct"]
    assert json.loads(info[0].split(" ", 2)[2])["calls"] == 2


def test_the_lookahead_holds_its_seconds_of_calls():
    assert run.lookahead_calls(2.5e-3) == 1600
    assert run.lookahead_calls(0.1) == 40
    # a call longer than the lookahead still lets one call run ahead
    assert run.lookahead_calls(10.0) == 1


def test_each_call_is_timed_from_the_end_of_the_one_before():
    assert run._intervals(1.0, [1.5, 2.25, 4.0]) == [0.5, 0.75, 1.75]


def test_the_window_waits_for_the_calls_ahead_of_its_lookahead(
        tiny_root, monkeypatch):
    # a lookahead of one call: before each call past the first the window
    # waits for the one before it to end
    monkeypatch.setattr(run, "lookahead_calls", lambda fastest_s: 1)
    waited = []
    monkeypatch.setattr(run, "_wait", waited.append)
    cell = run.find_cell(CELL, False, tiny_root)
    result, info, _ = run.run_cell(cell, 2**31 + 2**22 + 6, 0.05, False, "cpu")
    calls = _calls_line(info)
    n = result["attempted"] // 2  # TINY: 2 pairs a call
    assert calls["ahead_calls"] == 1
    assert len(waited) == n - 1
    assert result["correct"]
