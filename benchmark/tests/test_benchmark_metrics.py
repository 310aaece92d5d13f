"""Each metric's arithmetic on synthetic runs, and the operation counts
against a hand count."""

import types

import numpy as np
import pytest

from benchmark import checks, flops, manifest, trace
from benchmark.run import Run
from benchmark.spans import Spans

CANON = (64, (512,) * 8, (4,))


def fake_run(**kw):
    cell = types.SimpleNamespace(**kw.pop("cell", {}))
    spans = Spans()
    for name, ivs in kw.pop("spans", {}).items():
        spans.samples[name] = list(ivs)
    run = types.SimpleNamespace(cell=cell, spans=spans, trace=None, trace_reduced=None, window_s=1.0, setup_s=1.0,
                                device=types.SimpleNamespace(type="cuda"),
                                config={"decoder": {"code_len": 64, "hidden": [512] * 8, "latent_in": [4]}})
    for k, v in kw.items():
        setattr(run, k, v)
    run.untraced = types.MethodType(Run.untraced, run)
    run.untraced_s = types.MethodType(Run.untraced_s, run)
    return run


def test_rate_over_the_whole_window():
    run = fake_run(cell={"frames_s": [0.2] * 10}, window_s=4.0)
    assert manifest.reader("slam_fps")(run) == pytest.approx(2.5)


def test_p90_over_all_frames():
    frames = list(np.linspace(0.1, 1.0, 100))
    run = fake_run(cell={"frames_s": frames})
    assert manifest.reader("frame_ms_p90")(run) == pytest.approx(1e3 * np.percentile(frames, 90))
    # ten frames lie beyond it
    assert sum(f * 1e3 > manifest.reader("frame_ms_p90")(run) for f in frames) == 10


def test_time_per_object():
    run = fake_run(cell={"objects": 400}, window_s=14.0)
    assert manifest.reader("gn_ms_per_object")(run) == pytest.approx(35.0)


def test_span_means_over_the_untraced_window():
    spans = {"track": [(0, 0.2), (1, 1.4)], "keyframe_drain": [(0.5, 0.6)]}
    run = fake_run(spans=spans)
    assert manifest.reader("track_ms")(run) == pytest.approx(300.0)
    assert manifest.reader("ba_dispatch_ms")(run) is None
    # with a device trace over [0, 0.9], only the spans begun after it count
    run = fake_run(spans=spans, trace=types.SimpleNamespace(t0=0.0, t1=0.9))
    assert manifest.reader("track_ms")(run) == pytest.approx(400.0)
    assert manifest.reader("keyframe_drain_ms")(run) is None


def test_pose_gap_by_hand():
    T = np.eye(4)
    moved = T.copy()
    moved[1, 3] += 0.002
    moved[0, 1] = 1e-4
    assert checks.pose_gap((), (moved, None, None), (T, None, None)) == pytest.approx(0.002)


def test_idle_share_and_gaps_from_synthetic_intervals():
    iv = [(0.0, 0.1), (0.05, 0.2), (0.55, 0.6), (0.9, 1.0)]
    assert trace.busy_seconds(iv, 0.0, 1.0) == pytest.approx(0.35)
    spans = {"frame": [(0.0, 1.0)], "ba_dispatch": [(0.25, 0.5)]}
    gaps = trace.idle_gaps(iv, 0.0, 1.0, spans)
    assert gaps[0] == ["ba_dispatch", pytest.approx(0.35)]
    assert gaps[1] == ["frame", pytest.approx(0.3)]
    spans["ba_dispatch"].append((0.7, 0.8))
    assert trace.idle_gaps(iv, 0.0, 1.0, spans)[0] == ["ba_dispatch", pytest.approx(0.65)]
    run = fake_run(trace_reduced={"busy_s": 0.4, "window_s": 1.0})
    assert manifest.reader("device_idle.slam")(run) == pytest.approx(60.0)
    assert trace.device_ops([("a", 0, 1), ("b", 0, 3), ("a", 5, 6)]) == [["b", 3], ["a", 2]]


def test_decoder_flops_by_hand():
    # 67x512 + 512x512 + 512x512 + 512x445 + 4 x (512x512) + 512x1 multiply-adds
    macs = 67 * 512 + 2 * 512 * 512 + 512 * 445 + 4 * 512 * 512 + 512
    assert flops.forward_flops_per_row(*CANON) == 2 * macs == 3_671_040
    assert flops.value_and_grad_flops_per_row(*CANON) == 7_342_080
    assert 2048 * flops.value_and_grad_flops_per_row(*CANON) == pytest.approx(15.03e9, rel=1e-3)


def test_k1_roofline_and_gn_mfu():
    t = types.SimpleNamespace(t0=0.0, events=[("decoder_fused_kernel", 0.0, 0.0004), ("sgemm", 0.0, 0.1),
                                              ("decoder_fused_kernel", 0.001, 0.0017)])
    run = fake_run(cell={"k1_rows_per_call": lambda: [2048, 8192]}, trace=t)
    work = (2048 + 8192) * 7_342_080
    assert manifest.reader("k1_roofline")(run) == pytest.approx(100 * work / 495e12 / 0.0011)
    # the calls and the time after the trace stopped: 10 calls in [1, 3]
    calls = [(0.1 * i, 0.1 * i + 0.05) for i in range(5)] + [(1.0 + 0.2 * i, 1.1 + 0.2 * i) for i in range(10)]
    run = fake_run(cell={"grid_rows": [1e6], "grad_rows": [1e5]}, spans={"gn_call": calls}, window_s=3.0, t_end=3.0,
                   trace=types.SimpleNamespace(t0=0.0, t1=1.0))
    per_call = 1e6 * 3_671_040 + 1e5 * 7_342_080
    assert manifest.reader("gn_mfu")(run) == pytest.approx(100 * per_call * 10 / 2.0 / 495e12)
