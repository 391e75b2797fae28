"""The yardstick's operations, bytes and the window arithmetic."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import harness, yardstick

RECIPE = harness.read_json(os.path.join(harness.ROOT, "benchmark", "configs",
                                        "ac_h768.json"))["recipe"]


@pytest.mark.parametrize("H, both, actor", [(768, 3_342_336, 1_704_960),
                                            (1024, 5_505_024, 2_797_568)])
def test_forward_flops_at_the_committed_widths(H, both, actor):
    assert yardstick.forward_flops(H) == both
    assert yardstick.forward_flops(H, critic=False) == actor
    assert yardstick.forward_flops(H, actor=False) == both - actor


def test_forward_bytes_count_each_input_and_output_once():
    H, B = 768, 8192
    weights = (297 * H + H + H * H + H + H * 45 + 45) + (297 * H + H + H * H + H + H + 1)
    assert yardstick.forward_bytes(B, H) == 4 * weights + B * (4 * 297 + 45) + B * 4 * 46
    assert yardstick.forward_bytes(B, H, critic=False, weight_sets=13) == \
        4 * 13 * (297 * H + H + H * H + H + H * 45 + 45) + B * (4 * 297 + 45) + B * 4 * 45


def test_update_work_without_the_slot():
    """23.7 TFLOP an update at H=768 and 39.0 at H=1024 with all 64 steps."""
    w = yardstick.update_work(RECIPE, 0, 64)
    assert w.forward_flops == 65 * 8192 * 3_342_336 + 64 * 8192 * 1_704_960
    assert w.learner_flops == 64 * 32768 * 3 * 3_342_336
    assert round(w.flops / 1e12, 1) == 23.7
    assert round(yardstick.update_work(dict(RECIPE, hidden=1024), 0, 64).flops / 1e12, 1) == 39.0


def test_update_work_with_the_static_slot():
    """The search on 1,024 games: the root, 3 rounds of 2 actor plies and the
    critic's leaves on 32,768 lanes, every turn."""
    w = yardstick.update_work(RECIPE, 1024, 64)
    search = 64 * (1024 * 1_704_960 + 3 * 32768 * (2 * 1_704_960 + 1_637_376))
    assert w.forward_flops == 65 * 8192 * 3_342_336 + 64 * 7168 * 1_704_960 + search
    assert round(w.flops / 1e12, 1) == 55.5


def test_eval_work_and_least_time():
    bot = {"m": 16, "k0": 6, "horizon": 4}
    w = yardstick.eval_work(768, bot, 100, 33)
    per_turn = 100 * 1_704_960 + 4 * 9600 * (4 * 1_704_960 + 1_637_376) + 100 * 1_704_960
    assert w.flops == 33 * per_turn
    # At B=8192 with value the forward is bound by its operations.
    one = yardstick.Work(768).forward(8192)
    assert one.least_seconds() == pytest.approx(8192 * 3_342_336 / yardstick.PEAK_FLOPS)
    # A pool slot of 4 rows is bound by reading its weights.
    tiny = yardstick.Work(768).forward(4, critic=False)
    assert tiny.least_seconds() == pytest.approx(
        yardstick.forward_bytes(4, 768, critic=False) / yardstick.PEAK_BYTES)


def test_the_window_takes_all_work_over_all_time_and_a_stall_lowers_it():
    steady = [1.0, 2.0, 3.0, 4.0]
    rate, seconds = harness.window_rate(0.0, steady, [100] * 4)
    assert (rate, seconds) == (100.0, 4.0)
    stalled = [1.0, 2.0, 5.0, 6.0]  # the third operation waited 2 s
    rate2, seconds2 = harness.window_rate(0.0, stalled, [100] * 4)
    assert seconds2 == 6.0 and rate2 == pytest.approx(400 / 6) and rate2 < rate


def test_the_window_ends_at_the_first_boundary_at_or_after_its_length():
    now = [0.0]

    def clock():
        return now[0]

    def op():
        now[0] += 0.75
        return 10

    win = harness.run_window(op, 2.0, clock=clock)
    assert win["ops"] == 3 and win["seconds"] == pytest.approx(2.25)
    assert win["rate"] == pytest.approx(30 / 2.25)


def test_the_trace_summary_reads_busy_time_kernel_a_and_idle_gaps():
    ms = 1_000_000
    events = [
        ("op", "range", 0, 100 * ms),
        ("rollout", "range", 0, 60 * ms),
        ("epochs", "range", 60 * ms, 100 * ms),
        ("aten::nonzero", "host", 10 * ms, 30 * ms),
        ("fused_ac_wgmma_kernel", "device", 5 * ms, 10 * ms),
        ("elementwise", "device", 30 * ms, 40 * ms),
        ("elementwise", "device", 35 * ms, 45 * ms),
        ("Memcpy", "copy", 70 * ms, 90 * ms),
        ("late", "device", 120 * ms, 130 * ms),  # outside the window
    ]
    s = harness.summarize_trace(events)
    assert s["kernels"] == 3 and s["kernel_a_launches"] == 1
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.005 + 0.015 + 0.02)
    assert s["kernel_a_s"] == pytest.approx(0.005)
    gaps = dict(s["idle_gaps"])
    assert gaps["rollout: aten::nonzero"] == pytest.approx(0.02)
    # Each gap goes to what held at its middle: 0-5 ms and 45-70 ms (middle
    # 57.5) to the rollout, 90-100 ms to the epochs.
    assert gaps["rollout"] == pytest.approx(0.005 + 0.025)
    assert gaps["epochs"] == pytest.approx(0.01)
    assert dict(s["device_ops"])["elementwise"] == pytest.approx(0.02)
    json.dumps(s)
    assert harness.summarize_trace(events[1:]) is None  # no window


@pytest.mark.parametrize("cell, metric, want", [
    ("update", "rollout_ms.update", 3000.0), ("update", "opponent_ms.update", 2000.0),
    ("update", "engine_self_ms.update", 500.0), ("update", "epochs_ms.update", 1000.0),
    ("update", "launches_per_update.update", 1000.0), ("update", "device_idle.update", 60.0),
    ("update", "kernel_a_roofline.update", None), ("update", "mfu.update", None),
    ("eval", "device_idle.eval", 60.0), ("eval", "rollout_ms.update", "none"),
])
def test_the_readers_take_their_numbers_from_the_record(cell, metric, want):
    work = yardstick.Work(768).forward(8192)
    rec = {"kind": cell, "ops": 2, "window_s": 10.0, "op_seconds": [1.0, 3.0, 0.9],
           "spans": {"rollout": 6.0, "opponent": 4.0, "dual_step": 5.0, "epochs": 2.0},
           "profile": {"kernels": 1000, "busy_s": 0.4, "window_s": 1.0, "kernel_a_s": 0.001},
           "flops": 2 * work.flops, "profiled_work": work}
    got = harness.reader(metric)(rec)
    if want == "none":
        assert got is None
    elif metric.startswith("kernel_a_roofline"):
        assert got == pytest.approx(100 * work.least_seconds() / 0.001)
    elif metric.startswith("mfu"):
        assert got == pytest.approx(100 * 2 * work.flops / 10.0 / yardstick.PEAK_FLOPS)
    else:
        assert got == pytest.approx(want)


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = {"kind": "update", "ops": 1, "window_s": 1.0, "spans": {}, "profile": {},
           "flops": 0, "profiled_work": None}
    for metric in ("rollout_ms.update", "kernel_a_roofline.update", "device_idle.update",
                   "launches_per_update.update", "mfu.update"):
        assert harness.reader(metric)(rec) is None


def test_profiler_events_are_read_by_kind():
    """A CPU session: the spans come back as ranges, the operations inside
    them as host operations (a CPU run has no device events to sum)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans = harness.Spans(lambda: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("op"), spans.span("rollout"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    events = harness.kineto_events(prof, set(spans.counts))
    kinds = {(n, k) for n, k, _, _ in events}
    assert ("op", "range") in kinds and ("rollout", "range") in kinds
    assert any(k == "host" and n.startswith("aten::") for n, k in kinds)
    assert all(e >= s for _, _, s, e in events)
    assert harness.summarize_trace(events) is None  # no device work
