"""The port's process-wide telemetry hook (`dspslam_tpu_torch.utils.timing`)
and the spans and counters the tracker, local BA and the object GN report
through it, on the CPU.

Checked: with no sink `span` records nothing and allocates nothing while
`count` still totals; an attached sink gets each span once with a duration
that brackets the work; `attached` restores the previous sink, also on an
exception. A three-frame stereo drive over tests/fixtures/mini_kitti opens
every tracker span inside its frame's `track` interval, and no two spans of
one name overlap. A GN call opens `gn_iter` once per iteration and the
render grid counts its rows; `bundle_adjust` opens `ba_lm_step` once per LM
step.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from dspslam_tpu_torch.utils import timing

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_kitti")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: with parallel
    test workers, each worker's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """A sink keeping each span's (start, end) as `benchmark/spans.py` does
    (the end stamped at the add), and its counts."""

    def __init__(self):
        self.samples: dict[str, list[tuple[float, float]]] = {}
        self.counts: dict[str, int] = {}

    def add(self, name, seconds):
        end = time.perf_counter()
        self.samples.setdefault(name, []).append((end - seconds, end))

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


def no_overlap(samples):
    for name, ivs in samples.items():
        ivs = sorted(ivs)
        for (a0, b0), (a1, _) in zip(ivs, ivs[1:]):
            assert a1 >= b0, f"two {name} spans overlap"


# ---------------------------------------------------------------- the hook
def test_no_sink_records_nothing_and_allocates_nothing(monkeypatch):
    """No sink: `span` hands out one shared no-op context (nothing is made
    per call) and never reads the clock; `count` still totals."""

    class NoClock:
        def perf_counter(self):
            raise AssertionError("the clock was read")

    with timing.attached(None):
        assert timing.sink() is None
        shared = timing.span("a")
        assert timing.span("b") is shared and type(shared).__slots__ == ()
        monkeypatch.setattr(timing, "time", NoClock())
        for _ in range(3):
            with timing.span("x") as ctx:
                assert ctx is None
        before = timing.totals().get("telemetry_test", 0)
        timing.count("telemetry_test", 3)
        timing.count("telemetry_test")
        assert timing.totals()["telemetry_test"] == before + 4
        with timing.attached(Recorder()):        # with a sink the clock is read
            with pytest.raises(AssertionError, match="clock"):
                with timing.span("x"):
                    pass


def test_attached_sink_gets_each_span_once_bracketing_the_work():
    rec = Recorder()
    with timing.attached(rec):
        t0 = time.perf_counter()
        with timing.span("outer"):
            with timing.span("inner"):
                time.sleep(0.01)
        t1 = time.perf_counter()
        timing.count("telemetry_test_rows", 7)
    assert set(rec.samples) == {"outer", "inner"}
    (a, b), = rec.samples["outer"]
    (c, d), = rec.samples["inner"]
    assert t0 <= a <= c and d <= b <= t1
    assert d - c >= 0.01 and b - a >= d - c
    assert rec.counts == {"telemetry_test_rows": 7}
    totals = timing.totals()
    assert isinstance(totals, dict) and totals is not timing.totals()


def test_attached_restores_the_previous_sink_also_on_an_exception():
    first, second = Recorder(), Recorder()
    outer = timing.sink()
    with timing.attached(first):
        with pytest.raises(ValueError):
            with timing.attached(second):
                assert timing.sink() is second
                raise ValueError("inside")
        assert timing.sink() is first
        previous = timing.attach(second)
        assert previous is first and timing.detach() is second
        assert timing.sink() is None
        timing.attach(first)
    assert timing.sink() is outer


def test_stage_timer_is_a_sink_with_counts():
    timer = timing.StageTimer()
    with timing.attached(timer):
        with timing.span("stage_a"):
            pass
        timing.count("rows", 5)
        timing.count("rows", 2)
    assert timer.report()["stage_a"]["count"] == 1 and timer.counts == {"rows": 7}
    assert "rows" in str(timer) and "stage_a" in str(timer)
    timer.clear()
    assert not timer.samples and not timer.counts


# ---------------------------------------------------------------- the tracker
TRACKER_SPANS = ("track_pack", "track_orb", "track_stereo", "track_search", "pose_opt", "track_apply",
                 "track_modular", "result_fetch")


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """Three stereo frames of mini_kitti through SLAMSystem(device="cpu")
    with a recording sink: the first frames track stage by stage, the last
    through the fused program."""
    from dspslam_tpu_torch.apps import dsp_slam
    from dspslam_tpu_torch.config import SystemConfig
    from dspslam_tpu_torch.datasets.kitti import KITTISequence

    with open(os.path.join(FIXTURE, "config.template.json")) as f:
        cfg = json.loads(f.read().replace("{SEQ}", FIXTURE))
    path = tmp_path_factory.mktemp("telemetry") / "config.json"
    path.write_text(json.dumps(cfg))
    system_cfg = SystemConfig.load(str(path))
    seq = KITTISequence(FIXTURE, system_cfg.detection)
    system = dsp_slam.build_system(system_cfg, seq, device="cpu", enable_loop=False)
    rec = Recorder()
    previous = system.attach_telemetry(rec)
    try:
        for k in range(seq.num_frames):
            system.track_stereo(*seq.load_stereo_gray(k), seq.timestamp(k))
    finally:
        timing.attach(previous)
    return system, rec


def test_drive_opens_every_tracker_span_inside_its_frame(drive):
    system, rec = drive
    assert len(rec.samples["track"]) == 3
    assert system.state.name == "OK"
    missing = [n for n in TRACKER_SPANS if n not in rec.samples]
    assert not missing, missing
    frames = sorted(rec.samples["track"])
    for name in TRACKER_SPANS:
        for a, b in rec.samples[name]:
            assert any(f0 <= a and b <= f1 for f0, f1 in frames), f"{name} outside every track span"
    # two searches and two pose optimisations per fused frame
    fused = len(rec.samples["track_apply"])
    assert fused >= 1
    assert len(rec.samples["track_search"]) == 2 * fused
    assert len(rec.samples["track_orb"]) == len(rec.samples["track_stereo"]) == fused
    assert len(rec.samples["pose_opt"]) >= 2 * fused


def test_drive_spans_of_one_name_never_overlap(drive):
    _, rec = drive
    no_overlap(rec.samples)


# ---------------------------------------------------------------- GN and BA
def test_gn_call_opens_gn_iter_per_iteration_and_counts_grid_rows():
    from dspslam_tpu_torch.models import deepsdf
    from dspslam_tpu_torch.shape import gn

    B, P, R, S, iters = 2, 16, 12, 6, 3
    decoder = deepsdf.SphereDecoder(deepsdf.make_sphere_params(code_len=8, device="cpu"))
    cfg = gn.GNConfig(code_len=8, num_depth_samples=S, num_iterations=iters, k4=0.0, max_grad_points=32)
    g = torch.Generator().manual_seed(0)
    t = torch.eye(4).repeat(B, 1, 1)
    t[:, 2, 3] = 5.0
    dirs = torch.nn.functional.normalize(torch.randn(B, P, 3, generator=g), dim=-1)
    pts = dirs + t[:, None, :3, 3]
    rays = torch.cat([0.05 * torch.randn(B, R, 2, generator=g), torch.ones(B, R, 1)], -1)
    ones_p, ones_r = torch.ones(B, P), torch.ones(B, R)
    rec = Recorder()
    before = timing.totals().get("grid_rows", 0)
    with timing.attached(rec):
        out = gn.batched_reconstruct(decoder, cfg)(t, pts, ones_p, rays, ones_r, 4.0 * ones_r, ones_r,
                                                   torch.zeros(B, 8))
    assert torch.isfinite(out["t_cam_obj"]).all()
    assert len(rec.samples["gn_iter"]) == iters
    for name in ("gn_sdf", "gn_render", "gn_solve"):
        assert len(rec.samples[name]) == iters
    assert rec.counts["grid_rows"] == iters * B * R * S
    assert timing.totals()["grid_rows"] - before == iters * B * R * S
    iters_iv = sorted(rec.samples["gn_iter"])
    for name in ("gn_sdf", "gn_render", "gn_solve"):
        for a, b in rec.samples[name]:
            assert any(f0 <= a and b <= f1 for f0, f1 in iters_iv)
    no_overlap(rec.samples)


def test_bundle_adjust_opens_ba_lm_step_per_step():
    from dspslam_tpu_torch.backend import ba

    rng = np.random.default_rng(1)
    K, P = 3, 40
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_poses[:, 0, 3] = -0.3 * np.arange(K)
    points = np.concatenate([rng.uniform(-2, 2, (P, 2)), rng.uniform(6, 10, (P, 1))], -1).astype(np.float32)
    obs_kf = np.repeat(np.arange(K), P).astype(np.int32)
    obs_pt = np.tile(np.arange(P), K).astype(np.int32)
    pc = points[obs_pt] + kf_poses[obs_kf, :3, 3]
    uv = 400.0 * pc[:, :2] / pc[:, 2:] + 256.0
    obs_uvr = np.concatenate([uv, (uv[:, :1] - 160.0 / pc[:, 2:])], -1).astype(np.float32)
    O = K * P
    args = [torch.from_numpy(a) for a in (
        kf_poses, np.array([1, 0, 0], np.float32), points + 0.01, np.ones(P, np.float32), obs_kf, obs_pt,
        obs_uvr, np.ones(O, np.float32), np.ones(O, np.float32), np.ones(O, np.float32))]
    intr = torch.tensor([400.0, 400.0, 256.0, 256.0, 160.0])
    schedule = (2, 3)
    rec = Recorder()
    with timing.attached(rec):
        out = ba.bundle_adjust(*args, intr, 1e-3, None, schedule)
    assert torch.isfinite(out["points"]).all()
    assert len(rec.samples["ba_lm_step"]) == sum(schedule)
    assert len(rec.samples["ba_reclassify"]) == len(schedule) - 1
    no_overlap(rec.samples)
