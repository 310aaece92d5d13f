"""The readers of the spans inside the tracker, local BA and the object GN
on synthetic spans: each one's arithmetic, None where its span never opened
in the untraced part of the window (a program without the span), and the
samples begun before the device trace stopped left out."""

import types

import pytest

from benchmark import manifest
from benchmark.run import Run
from benchmark.spans import Spans

PER_FRAME = {          # metric: the spans summed per `track` span
    "track_orb_ms": ("track_orb",),
    "track_search_ms": ("track_stereo", "track_search"),
    "track_pose_ms": ("pose_opt",),
    "track_host_ms": ("track_pack", "track_apply"),
}
MEANS = {"ba_pack_ms": "ba_pack", "ba_lm_step_ms": "ba_lm_step", "gn_iter_ms": "gn_iter"}


def fake_run(spans: dict, t1: float | None = None):
    s = Spans()
    for name, ivs in spans.items():
        s.samples[name] = list(ivs)
    run = types.SimpleNamespace(spans=s, trace=None if t1 is None else types.SimpleNamespace(t0=0.0, t1=t1),
                                window_s=10.0, t_end=10.0)
    run.untraced = types.MethodType(Run.untraced, run)
    return run


def frames_and_inner():
    """Three frames at 0, 1 and 2 s, 0.5 s each, with every tracker span
    inside each; BA and GN spans between them."""
    spans = {"track": [(k, k + 0.5) for k in range(3)]}
    durations = {"track_orb": 0.10, "track_stereo": 0.02, "track_search": 0.03, "pose_opt": 0.04,
                 "track_pack": 0.05, "track_apply": 0.06}
    for name, d in durations.items():
        n = 2 if name in ("track_search", "pose_opt") else 1
        spans[name] = [(k + 0.01 + 0.001 * i, k + 0.01 + 0.001 * i + d) for k in range(3) for i in range(n)]
    spans["ba_pack"] = [(0.6, 0.62), (1.6, 1.64)]
    spans["ba_lm_step"] = [(0.85 + 0.01 * i, 0.855 + 0.01 * i) for i in range(15)]
    spans["gn_iter"] = [(2.6 + 0.01 * i, 2.608 + 0.01 * i) for i in range(10)]
    return spans, durations


def test_per_frame_sums_over_the_track_spans():
    spans, d = frames_and_inner()
    run = fake_run(spans)
    expect = {
        "track_orb_ms": 1e3 * d["track_orb"],
        "track_search_ms": 1e3 * (d["track_stereo"] + 2 * d["track_search"]),
        "track_pose_ms": 1e3 * 2 * d["pose_opt"],
        "track_host_ms": 1e3 * (d["track_pack"] + d["track_apply"]),
    }
    for name, value in expect.items():
        assert manifest.reader(name)(run) == pytest.approx(value), name


def test_means_per_span():
    spans, _ = frames_and_inner()
    run = fake_run(spans)
    assert manifest.reader("ba_pack_ms")(run) == pytest.approx(30.0)
    assert manifest.reader("ba_lm_step_ms")(run) == pytest.approx(5.0)
    assert manifest.reader("gn_iter_ms")(run) == pytest.approx(8.0)


@pytest.mark.parametrize("metric", [*PER_FRAME, *MEANS])
def test_none_where_the_span_never_opened(metric):
    """A program without the new spans (only `track`, the parent's) reads
    None, and so does a run whose span opened only under the trace."""
    spans, _ = frames_and_inner()
    names = PER_FRAME.get(metric, (MEANS.get(metric),))
    parent = {"track": spans["track"], "keyframe_drain": [(0.5, 0.6)]}
    assert manifest.reader(metric)(fake_run(parent)) is None
    traced_only = dict(spans)
    for name in names:
        traced_only[name] = [(0.001, 0.002)]
    assert manifest.reader(metric)(fake_run(traced_only, t1=0.9)) is None


@pytest.mark.parametrize("metric", [*PER_FRAME, *MEANS])
def test_samples_begun_before_the_trace_stopped_are_left_out(metric):
    """With a device trace that stopped at 0.9 s, frame 0 and every span
    begun in it are left out, from the sums and from the frame count."""
    spans, _ = frames_and_inner()
    # frame 0's spans read ten times longer: counted, they would show
    slow = {n: [(a, a + 10 * (b - a)) if a < 0.9 else (a, b) for a, b in ivs] for n, ivs in spans.items()
            if n != "track"}
    slow["track"] = spans["track"]
    run, plain = fake_run(slow, t1=0.9), fake_run({n: [iv for iv in ivs if iv[0] >= 0.9]
                                                    for n, ivs in spans.items()})
    assert manifest.reader(metric)(run) == pytest.approx(manifest.reader(metric)(plain))
    if metric in PER_FRAME:
        assert manifest.reader(metric)(run) == pytest.approx(manifest.reader(metric)(fake_run(spans)))
