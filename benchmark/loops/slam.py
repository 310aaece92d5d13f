"""The SLAM cells: drives through a synthetic street, back to back, each on
a fresh `dspslam_tpu_torch.slam.system.SLAMSystem`, until the window ends.

A closed loop: the next frame is offered when the tracker returns. Each
frame's time is its `track_stereo` / `track_mono` call; a drive's final
`flush()` is timed into its last frame, and the drive that the window's end
cuts is flushed there. Stereo frames are uploaded one frame ahead (inside
the window, as a camera driver would), mono frames go in as host images.
With objects, each keyframe gets the ground-truth-derived detections of its
frame, as DSP-SLAM's offline labels give them (`GroundTruthDetections`).

`correct` follows the program step by step from its own state, as the
references cannot run a whole SLAM system: a sample of the window's calls
(drawn from the seed) of the tracker's pose optimisation, of local BA and
of the object GN is re-solved by the plain references from the inputs the
program was given, and no frame may be lost once a drive's tracking has
started. Each drive's trajectory error against the world's true poses is
recorded beside them (`ate_over_travel`, compared where the cell's limits
name it).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks, faults, gncheck, scene
from ..common import SetupLog, load_or_render, synchronize
from ..fit import cached_fit
from ..reference import ba as ba_ref
from ..reference import gn as gn_ref
from ..reference import pose as pose_ref


class Sampler:
    """Which calls of a stream to keep, drawn from the seed: the first at a
    uniform position in [0, spacing), then every `spacing`-th, at most
    `cap`."""

    def __init__(self, rng: np.random.Generator, spacing: int, cap: int):
        self.next, self.spacing, self.left = int(rng.integers(spacing)), spacing, cap
        self.calls = 0

    def take(self) -> bool:
        keep = self.left > 0 and self.calls == self.next
        if keep:
            self.next += self.spacing
            self.left -= 1
        self.calls += 1
        return keep


class Capture:
    """Keeps (args, output, the decoder calls made inside) of the calls to
    `fn` that `sampler` picks; with a `tap` (gncheck.DecoderTap) the
    decoder's calls during a kept call are recorded too. With `clone` the
    kept tensors are copies taken at the call (on the device, in its
    stream), for a caller that reuses its buffers."""

    def __init__(self, fn, sampler: Sampler, tap=None, clone: bool = False):
        self.fn, self.sampler, self.tap, self.clone = fn, sampler, tap, clone
        self.kept: list = []

    def _copy(self, x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(self._copy(v) for v in x)
        return x

    def __call__(self, *args, **kwargs):
        keep = self.sampler.take()
        if keep and self.tap is not None:
            self.tap.record = []
        if keep and self.clone:
            args, kwargs = self._copy(args), {k: self._copy(v) for k, v in kwargs.items()}
        try:
            out = self.fn(*args, **kwargs)
        finally:
            record = None if self.tap is None else self.tap.record
            if self.tap is not None:
                self.tap.record = None
        if keep:
            self.kept.append((args, self._copy(out) if self.clone else out, record, kwargs))
        return out


class GroundTruthDetections:
    """The detection source of a drive: each keyframe's detections made
    from the world's true spheres (scene.make_detections), as offline
    labels."""

    def __init__(self, drive, rng, spans):
        self.drive, self.rng, self.spans = drive, rng, spans

    def __call__(self, idx):
        from dspslam_tpu_torch.objects.detections import Detection

        idx = min(idx, len(self.drive.traj) - 1)
        with self.spans.span("detections"):
            dets = scene.make_detections(self.drive.traj[idx], self.drive.centers(idx), self.drive.radius, self.rng)
        return [Detection(**d) for d in dets]


class SlamCell:
    def __init__(self, config: dict, mix: dict, seed: int, device, spans, log: SetupLog):
        self.config, self.mix, self.seed, self.device, self.spans, self.log = config, mix, seed, device, spans, log
        self.checked: dict[str, int] = {}
        self.frames_s: list[float] = []
        self.drives_done: list[dict] = []
        self.decoder_weights = None
        self.ba_capture = self.gn_capture = self.pose_capture = None
        self.trace, self.trace_until = None, float("inf")   # a traced window's profiler and its end
        self.stereo = mix["sensor"] == "stereo"
        self.objects = bool(mix.get("objects"))
        self.variant = None           # a planted fault or the control (faults.py); None in a benchmark run

    # ------------------------------------------------------------------ set-up
    def setup(self):
        log, dev = self.log, self.device
        with log.stage("imports"):
            from dspslam_tpu_torch.backend import ba  # noqa: F401
            from dspslam_tpu_torch.slam import system  # noqa: F401
        if dev.type == "cuda":
            with log.stage("kernels"):
                from dspslam_tpu_torch.kernels import decoder_fused, fast_score

                fast_score.build()
                if self.objects:
                    decoder_fused.build()
        if self.objects:
            with log.stage("decoder_fit"):
                ws, bs, loss, hit = cached_fit(self.config["decoder"], dev, steps=self.mix["decoder_fit_steps"])
                self.decoder_weights = (ws, bs)
                log.notes.update(decoder_fit_l1=loss, decoder_fit_cache_hit=hit)
        with log.stage("render"):
            self.drives = [scene.Drive(self.config["camera"], self.mix, s) for s in self.mix["world"]["texture_seeds"]]
            log.notes["render_cache_hits"] = sum(load_or_render(d) for d in self.drives)
        rng = np.random.default_rng(self.seed)
        # the order of the drives, then every random draw of the traffic
        self.order = rng.permutation(len(self.drives))
        self.det_rng = np.random.default_rng(rng.integers(2 ** 63))
        self.capture_rng = np.random.default_rng(rng.integers(2 ** 63))
        if self.objects:
            ws, bs = self.decoder_weights
            self.decoder = self._port_decoder(ws, bs)
            if self.variant == "tf32":
                faults.control_decoder(self.decoder, ws, bs, self.config["decoder"]["latent_in"])
            self.tap = gncheck.DecoderTap(self.decoder, self.mix["check"]["grid_rows"],
                                          np.random.default_rng(rng.integers(2 ** 63)))
        with log.stage("warmup_frames"):
            self.drive(self.drives[self.order[0]], self.mix["warmup_frames"], None, np.random.default_rng(0),
                       record=False)
            synchronize(dev)

    def _port_decoder(self, ws, bs):
        from dspslam_tpu_torch.models import deepsdf

        d = self.config["decoder"]
        precision = "default" if self.variant == "tf32" else d["matmul_precision"]
        cfg = deepsdf.DecoderConfig(code_len=d["code_len"], hidden=tuple(d["hidden"]),
                                    latent_in=tuple(d["latent_in"]), matmul_precision=precision)
        return deepsdf.DeepSDFDecoder(cfg, ws, bs)

    # ------------------------------------------------------------------ the system
    def build_system(self, spans):
        from dspslam_tpu_torch.frontend import orb
        from dspslam_tpu_torch.objects.pipeline import ObjectPipeline
        from dspslam_tpu_torch.shape import gn
        from dspslam_tpu_torch.slam.local_mapping import LocalMapperConfig
        from dspslam_tpu_torch.slam.system import SLAMSystem
        from dspslam_tpu_torch.slam.tracking import TrackerConfig

        cam, trk, o = self.config["camera"], self.config["tracker"], self.config["orb"]
        bf = cam["baseline_fx"] if self.stereo else cam["fx"] * trk["mono_bf_over_fx"]
        factory = None
        if self.objects:
            gcfg = gn.GNConfig(**self.config["optimizer"])
            det = self.config["detection"]

            def factory(slam_map):
                pipe = ObjectPipeline(slam_map, self.decoder, gcfg, max_detections=det["max_detections"],
                                      max_surface_points=det["max_surface_points"], max_rays=det["max_rays"],
                                      extract_meshes=True, voxels_dim=self.config["voxels_dim"])
                if self.gn_capture is not None:
                    self.gn_capture.fn = faults.wrap_gn(pipe.batched_recon, self.variant)
                    pipe.batched_recon = self.gn_capture
                return pipe

        system = SLAMSystem(
            tracker_cfg=TrackerConfig(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], bf=bf,
                                      width=cam["width"], height=cam["height"],
                                      min_init_features=trk["min_init_features"],
                                      max_frames_between_kf=trk["max_frames_between_kf"],
                                      search_radius_motion=trk["search_radius_motion"], pipelined=trk["pipelined"]),
            orb_params=orb.ORBParams(n_features=o["n_features"], n_levels=o["n_levels"],
                                     scale_factor=o["scale_factor"], fast_threshold=float(o["ini_th_fast"]),
                                     min_threshold=float(o["min_th_fast"])),
            object_pipeline_factory=factory,
            local_mapper_cfg=LocalMapperConfig(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], bf=bf,
                                               async_ba=True, async_keyframe=True, async_objects=self.objects,
                                               ba_objects=self.objects),
            device=self.device,
        )
        system.attach_telemetry(spans)
        return system

    # ------------------------------------------------------------------ one drive
    def drive(self, d, n_frames: int, deadline: float | None, det_rng, record: bool = True):
        """Track `n_frames` of drive `d` (fewer if `deadline` passes first)
        on a fresh system; returns the drive's record."""
        from dspslam_tpu_torch.slam.map import to_torch

        spans = self.spans
        with spans.span("system_build"):
            system = self.build_system(spans)
        if self.objects:
            system.detection_source = GroundTruthDetections(d, det_rng, spans)
        dt = 1.0 / self.config["camera"]["fps"]

        def upload(k):
            with spans.span("upload"):
                return tuple(to_torch(img, self.device) for img in d.frames[k])

        times = []
        pair = upload(0) if self.stereo else None
        for k in range(n_frames):
            t0 = time.perf_counter()
            with spans.span("frame"):
                if self.stereo:
                    nxt = upload(k + 1) if k + 1 < n_frames else None
                    system.track_stereo(*pair, k * dt)
                    pair = nxt
                else:
                    system.track_mono(d.frames[k][0], k * dt)
                last = k == n_frames - 1 or (deadline is not None and time.perf_counter() >= deadline)
                if last:
                    with spans.span("flush"):
                        system.flush()
            times.append(time.perf_counter() - t0)
            if self.trace is not None and self.trace.prof is not None and time.perf_counter() >= self.trace_until:
                self.trace.stop()       # between two frames: the rest of the window runs untraced
            if last:
                break
        rec = {"texture_seed": int(d.texture_seed), "frames": len(times),
               "trajectory": [(int(round(ts / dt)), np.array(T_cw, np.float64), bool(lost))
                              for ts, T_cw, lost in system.tracker.trajectory],
               "keyframes": len(system.map.keyframes)}
        if record:
            self.frames_s.extend(times)
            self.drives_done.append(rec)
        return rec

    # ------------------------------------------------------------------ the window
    def window(self, seconds: float, trace=None) -> float:
        """Drives back to back until `seconds` pass; returns the window's
        length (from its start to the last flush's return)."""
        from dspslam_tpu_torch.backend import ba
        from dspslam_tpu_torch.slam import pose_opt

        chk = self.mix["check"]
        original, original_pose = ba.bundle_adjust, pose_opt.optimize_pose
        self.ba_capture = Capture(faults.wrap_ba(original, self.variant),
                                  Sampler(self.capture_rng, chk["ba_spacing"], chk["sample_cap"]))
        if self.objects:
            self.gn_capture = Capture(None, Sampler(self.capture_rng, chk["gn_spacing"], chk["sample_cap"]), self.tap)
        # the tracker's programs pass buffers of the map that later frames
        # overwrite: the kept calls are copies
        self.pose_capture = Capture(faults.wrap_pose(original_pose, self.variant),
                                    Sampler(self.capture_rng, chk["pose_spacing"], chk["pose_cap"]), clone=True)
        ba.bundle_adjust, pose_opt.optimize_pose = self.ba_capture, self.pose_capture
        try:
            t_start = time.perf_counter()
            deadline = t_start + seconds
            if trace is not None:
                self.trace, self.trace_until = trace, t_start + self.mix.get("trace_seconds", seconds)
                trace.start()
            i = 0
            while time.perf_counter() < deadline:
                d = self.drives[self.order[i % len(self.order)]]
                self.drive(d, self.mix["frames_per_drive"], deadline, self.det_rng)
                i += 1
            if trace is not None and trace.prof is not None:
                trace.stop()
            return time.perf_counter() - t_start
        finally:
            ba.bundle_adjust, pose_opt.optimize_pose = original, original_pose

    def attempted_failed(self) -> tuple[int, int]:
        """Frames offered, and frames lost once the drive's tracking had
        started (a mono drive's frames before its two-view initialisation
        have no pose by design)."""
        lost = 0
        for r in self.drives_done:
            first = next((k for k, _, is_lost in r["trajectory"] if not is_lost), None)
            lost += sum(1 for k, _, is_lost in r["trajectory"] if is_lost and first is not None and k > first)
        return len(self.frames_s), lost

    def release(self):
        if self.objects:
            self.tap.remove()
        self.decoder = self.tap = None

    # ------------------------------------------------------------------ correct
    def check(self) -> dict:
        """Each number of the run (the cell's limits pick those compared),
        worst over the window: frames lost once a drive's tracking started
        (the true trajectory loses none); the sampled pose optimisations,
        BA solves and GN calls against the references; each drive's ATE
        over its travel (also kept per drive in `self.trajectory`)."""
        out = {}
        self.trajectory = []
        lost_after_init = 0
        ates = []
        for r in self.drives_done:
            d = next(x for x in self.drives if x.texture_seed == r["texture_seed"])
            tracked = [(k, T) for k, T, lost in r["trajectory"] if not lost]
            first = tracked[0][0] if tracked else None
            lost_after_init += sum(1 for k, _, lost in r["trajectory"] if lost and first is not None and k > first)
            if first is None and r["frames"] >= self.mix["check"]["min_frames_for_ate"]:
                lost_after_init += r["frames"]          # a drive whose tracking never started
            ate = None
            if len(tracked) >= self.mix["check"]["min_frames_for_ate"]:
                est = np.stack([np.linalg.inv(T)[:3, 3] for _, T in tracked])
                gt = np.stack([d.traj[k][:3, 3] for k, _ in tracked])
                ate = checks.ate_over_travel(est, gt, scale=not self.stereo)
                ates.append(ate)
            self.trajectory.append({"texture_seed": r["texture_seed"], "frames": r["frames"], "init_frame": first,
                                    "ate_over_travel": ate})
        out["lost_after_init"] = float(lost_after_init)
        out["ate_over_travel"] = max(ates, default=0.0)
        readings = [checks.pose_gap(args, prog, pose_ref.optimize_pose(*args, **kwargs))
                    for args, prog, _, kwargs in self.pose_capture.kept]
        if not readings:
            raise RuntimeError("no pose optimisation of the tracker was sampled in the window")
        out["track_pose_gap"] = max(readings)
        self.checked["pose_solves"] = len(readings)
        readings = [checks.ba_gaps(args, prog, self.reference_ba(args, kwargs))
                    for args, prog, _, kwargs in self.ba_capture.kept]
        if not readings:
            raise RuntimeError("no local BA solve was sampled in the window")
        out.update(checks.worst(readings))
        self.checked["ba_solves"] = len(readings)
        if self.objects:
            dec, dec64 = gncheck.plain_decoders(*self.decoder_weights, self.config["decoder"]["latent_in"])
            params = gn_ref.GNParams.from_config(self.config["optimizer"])
            readings = []
            for args, prog, record, _ in self.gn_capture.kept:
                gaps = gncheck.gn_call_gaps(args, prog, record, dec, dec64, params)
                gaps.pop("rows")
                readings.append(gaps)
            if not readings:
                raise RuntimeError("no object GN call was sampled in the window")
            out.update(checks.worst(readings))
            self.checked["gn_calls"] = len(readings)
        return out

    def reference_ba(self, args, kwargs):
        a = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
        if isinstance(a[12], dict):
            a[12] = {k: v.clone() for k, v in a[12].items()}
        return ba_ref.bundle_adjust(*a, **kwargs)


Cell = SlamCell
