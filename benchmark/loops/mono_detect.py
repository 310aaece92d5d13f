"""The mono detect cell: DSP-SLAM's monocular deployment with Mask R-CNN
online on every keyframe (`detect_online: true`), through the port's
normal path.

Drives (benchmark/orbit.py): a camera circling a parked object, back to
back, each on a fresh `SLAMSystem` with the port's `MonoObjectPipeline`,
closed loop, frames given as host images (loops/slam.py's `SlamCell`
drives them). Mono association votes with the keyframe's fresh map
points, so the local mapper runs triangulation, the detection, the object
stage (a first reconstruction's seed and flip as one B = 2 GN call, the
64^3 mesh) inside the keyframe's frame.

Set-up writes the configuration's Mask R-CNN weights (seeded random, in
mmdet's checkpoint layout, benchmark/detweights.py), builds the network
through the port's `datasets.kitti.get_detector_2d`, fits the decoder,
renders the drives and runs one whole drive. In the window each keyframe
calls the port's `datasets.mono.detect_online_mono` on its grey frame and
fetches the result; random weights find next to nothing, so the object
pipeline then gets the detection that the port's `build_mono_detection`
makes of the world's true masks and boxes (an offline label). A port that
lacks the online mono path fails at the start of set-up.

`correct` is kitti_full's check of the SLAM path and the object GN (on
the mono calls), Mask R-CNN followed stage by stage on sampled keyframes
(benchmark/detcheck.py, at 768 x 1344), two numbers of the mono GN's
steps and four of the mono stages against benchmark/reference/mono.py,
each on a seeded sample of the window's calls.

detcheck.py compares each proposal's box for its best class. The seeded
weights give nearly even class probabilities, and a proposal's two best
can tie within float32's rounding: seen once, 3.4e-7 apart, where the
port and the reference took different classes, boxes 15.7 px apart, a
`det2d_box_gap` of 5.6e-4 from a sound run. Here the box is compared for
the port's class wherever the reference's probability of that class is
within CLASS_BAND of its best (a tie either may take, as the NMS checks
take them); every class's probability is compared as before.

A mono GN step moves the object's surface by meters (the PCA seed is far
from the sparse points, and no foreground depth holds the scale): from the
program's own state the float32 reference and the same step in float64
end up a few percent of the step apart, and K1's rounding moves the
program's step as much. So gncheck.py's `gn_step_gap(_median)`, in meters,
reads as high in a sound run as in the TF32 control, and the mono GN's
steps are compared relative to the step (gncheck.py's states, read from
the decoder's rows; per object the largest difference of the metric SDF
at its live surface points, over the same of the reference's step itself,
at least MOVE_FLOOR; the largest object):

  gn_step_rel_median  per sampled call, the median over its steps, the
                  worst call (one step of a first reconstruction, just
                  after its largest move, can read several percent);
  gn_out_rel_gap  the call's last step, whose state is the call's output
                  (nothing else holds the returned pose and code), the
                  worst call;

  mono_det_miss   `build_mono_detection` replayed from its inputs (the
                  masks and boxes): the eroded mask's pixels that differ,
                  plus one for another box, plus the background rays that
                  differ by more than RAY_TOL or are missing, counted;
  mono_seed_gap   the PCA cuboid (`cuboid.compute_cuboid_pca`) from the
                  object's member points and the scale floor
                  (`cuboid.floor_scale_to_domain`) from the program's own
                  cuboid: ||prog - ref|| / ||ref|| over the 3 x 4 Sim(3),
                  the nearer of the reference's pose and its flip (the
                  eigenvectors' signs leave that pair, both of which the
                  GN tries), the worst call;
  mono_pick_miss  first reconstructions (B = 2 calls) that the GN
                  check sampled whose kept candidate the reference GN's two
                  losses forbid: each candidate's loss worked out again by
                  one reference GN step from the program's own state before
                  its last iteration (read from the decoder's rows, as
                  gncheck.py reads states); the program kept the other, and
                  the two reference losses are more than PICK_BAND apart
                  (relative), counted;
  mesh_grid_gap   the 64^3 SDF grid (`mesh.decode_sdf_grid`) at a seeded
                  sample of `grid_rows` voxels against the float32 plain
                  decoder at the same voxel's point, the largest
                  difference.

Counters the port keeps while the window runs go into the set-up line's
notes (`window_counts`), with the keyframes that ran Mask R-CNN (the
`detect_mono` spans) and the drives completed.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import checks, detcheck, detfaults, detweights, faults, gncheck, monofaults, orbit
from ..common import synchronize
from ..fit import cached_fit
from ..reference import gn as gn_ref
from ..reference import lie
from ..reference import maskrcnn as ref2d
from ..reference import mono as ref_mono
from .slam import Capture, GroundTruthDetections, Sampler, SlamCell

COUNTERS = ("mono_dets", "mono_objects_born", "mono_gn_calls", "mono_gn_rows", "mono_meshes",
            "det2d_nms_rounds", "det2d_kept", "nms_launches")
RAY_TOL = 1e-6          # a background ray's entries (float32 products of the same pixels)
PICK_BAND = 1e-4        # relative: two reference losses closer than this are a tie either pick may take
MOVE_FLOOR = 0.1        # m: a GN step that moves the surface less is measured against this
CLASS_BAND = 1e-5       # two class probabilities closer than this are a tie either class may take


def tap(module, name: str, sampler: Sampler) -> Capture:
    """Wraps `module.name` in place in a `Capture` of the calls `sampler`
    picks (the function is back with `setattr(module, name, capture.fn)`)."""
    capture = Capture(getattr(module, name), sampler)
    setattr(module, name, capture)
    return capture


class PickLog:
    """First reconstructions: `wrap` goes around the GN check's capture and
    notes a B = 2 call that it kept; `best_of` goes around the module's and
    pairs that call with the program's losses, which candidates are finite
    and the index of the one it kept."""

    def __init__(self, best_of):
        self.fn = best_of
        self.pending = None
        self.kept: list = []

    def wrap(self, capture: Capture):
        def recon(*args):
            n = len(capture.kept)
            out = capture(*args)
            self.pending = capture.kept[-1] if len(capture.kept) > n and args[0].shape[0] == 2 else None
            return out
        return recon

    def best_of(self, results):
        out = self.fn(results)
        if self.pending is not None and len(results) == 2:
            kept = next((i for i, r in enumerate(results) if r is out), None)
            args, _, record, _ = self.pending
            self.kept.append((args, record, [r["loss"] for r in results],
                              [bool(np.isfinite(r["t_cam_obj"]).all()) for r in results], kept))
        self.pending = None
        return out


class MonoDetections:
    """A drive's detection source: a keyframe's call runs the port's online
    mono detection on its frame, then returns the detection built by the
    port from the frame's true masks and boxes."""

    def __init__(self, cell, labels: GroundTruthDetections):
        self.cell, self.labels = cell, labels

    def __call__(self, idx):
        from dspslam_tpu_torch.datasets import mono

        cell, d = self.cell, self.labels.drive
        k = min(idx, len(d.traj) - 1)
        keep = cell.det_sampler is not None and cell.det_sampler.take()
        if keep:
            cell.tap2d.record = {}
        try:
            mono.detect_online_mono(cell.det2d, d.frames[k][0], cell.invK, cell.det_cfg)
        finally:
            rec, cell.tap2d.record = cell.tap2d.record, None
        if keep:
            cell.det_kept.append({"image": d.frames[k][0], "rec": rec})
        with self.labels.spans.span("detections"):
            boxes, masks = d.instances(k)
        c = cell.det_cfg
        det = mono.build_mono_detection(masks, boxes, cell.invK, min_mask_area=c.min_mask_area,
                                        bg_stride=c.downsample_ratio, max_bg_rays=c.max_bg_rays,
                                        mask_erosion=c.mask_erosion, dist_coeffs=None)
        return [det] if det is not None else []


@functools.cache
def _system_class():
    """SLAMSystem whose detection source, once assigned, is wrapped by
    `MonoDetections`: loops/slam.py assigns each drive's labels source
    after building the system."""
    from dspslam_tpu_torch.slam.system import SLAMSystem

    class MonoDetectSystem(SLAMSystem):
        cell = None

        def __setattr__(self, name, value):
            if name == "detection_source" and isinstance(value, GroundTruthDetections):
                value = MonoDetections(self.cell, value)
            super().__setattr__(name, value)

    return MonoDetectSystem


class MonoDetectCell(SlamCell):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.det_sampler = self.pick_log = None
        self.det_kept: list[dict] = []
        self.taps: dict[str, tuple] = {}
        self.tap2d = None
        self._saved_det = self._saved_mono = {}

    # ------------------------------------------------------------------ set-up
    def setup(self):
        # the port's online mono path: a port without it fails here, at once
        from dspslam_tpu_torch.datasets.kitti import get_detector_2d
        from dspslam_tpu_torch.datasets.mono import detect_online_mono  # noqa: F401
        from dspslam_tpu_torch.objects.mono_pipeline import best_of  # noqa: F401

        from dspslam_tpu_torch.config import DetectionConfig
        from dspslam_tpu_torch.datasets import mono
        from dspslam_tpu_torch.detect import maskrcnn, pointpillars
        from dspslam_tpu_torch.objects import cuboid
        from dspslam_tpu_torch.objects import mono_pipeline
        from dspslam_tpu_torch.shape import mesh
        from dspslam_tpu_torch.utils import timing

        log, dev, det, cam = self.log, self.device, self.config["detection"], self.config["camera"]
        seed_2d = int(np.random.default_rng([self.seed, 17]).integers(2 ** 31))
        with log.stage("detector_weights"):
            self.weights_2d, hit = detweights.write("maskrcnn", det["detector_2d"], seed_2d)
            log.notes["detector_weights_cache_hits"] = int(hit)
        fields = {f.name for f in dataclasses.fields(DetectionConfig)}
        self.det_cfg = DetectionConfig(**{**{k: v for k, v in det.items() if k in fields},
                                          "weight_path_2d": self.weights_2d})
        with log.stage("detector"):
            self.det2d = get_detector_2d(self.det_cfg, "cars", device=dev)
        self.invK = np.linalg.inv(np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]],
                                           np.float32)).astype(np.float32)
        sd2 = ref2d.load(self.weights_2d, dev) if self.variant == detfaults.CONTROL else None
        self._saved_det = detfaults.install(self.variant, maskrcnn, pointpillars, sd2)
        self._saved_mono = monofaults.install(self.variant, mono, cuboid, mono_pipeline, mesh)
        self.tap2d = detcheck.StageTap(maskrcnn, detcheck.STAGES_2D)
        self.modules = {"mono": mono, "cuboid": cuboid, "pipeline": mono_pipeline, "mesh": mesh}
        with log.stage("imports"):
            from dspslam_tpu_torch.backend import ba  # noqa: F401
            from dspslam_tpu_torch.slam import system  # noqa: F401
        if dev.type == "cuda":
            with log.stage("kernels"):
                from dspslam_tpu_torch.kernels import decoder_fused, fast_score

                fast_score.build()
                decoder_fused.build()
        with log.stage("decoder_fit"):
            ws, bs, loss, hit = cached_fit(self.config["decoder"], dev, steps=self.mix["decoder_fit_steps"])
            self.decoder_weights = (ws, bs)
            log.notes.update(decoder_fit_l1=loss, decoder_fit_cache_hit=hit)
        with log.stage("render"):
            self.drives = [orbit.OrbitDrive(cam, self.mix, s) for s in self.mix["world"]["texture_seeds"]]
            log.notes["render_cache_hits"] = sum(orbit.load_or_render(d) for d in self.drives)
        rng = np.random.default_rng(self.seed)
        # the order of the drives, then every random draw of the traffic
        self.order = rng.permutation(len(self.drives))
        self.det_rng = np.random.default_rng(rng.integers(2 ** 63))
        self.capture_rng = np.random.default_rng(rng.integers(2 ** 63))
        self.mono_rng = np.random.default_rng(rng.integers(2 ** 63))
        self.decoder = self._port_decoder(ws, bs)
        if self.variant == "tf32":
            faults.control_decoder(self.decoder, ws, bs, self.config["decoder"]["latent_in"])
        self.tap = gncheck.DecoderTap(self.decoder, self.mix["check"]["grid_rows"],
                                      np.random.default_rng(rng.integers(2 ** 63)))
        with log.stage("warmup_frames"):
            self.drive(self.drives[self.order[0]], self.mix["warmup_frames"], None, np.random.default_rng(0),
                       record=False)
            synchronize(dev)
        self._counts0 = timing.totals()

    # ------------------------------------------------------------------ the system
    def build_system(self, spans):
        from dspslam_tpu_torch.frontend import orb
        from dspslam_tpu_torch.objects.mono_pipeline import MonoObjectPipeline
        from dspslam_tpu_torch.shape import gn
        from dspslam_tpu_torch.slam.local_mapping import LocalMapperConfig
        from dspslam_tpu_torch.slam.tracking import TrackerConfig

        cam, trk, o, det = self.config["camera"], self.config["tracker"], self.config["orb"], self.config["detection"]
        bf = cam["fx"] * trk["mono_bf_over_fx"]
        gcfg = gn.GNConfig(**self.config["optimizer"])

        def factory(slam_map):
            pipe = MonoObjectPipeline(slam_map, self.decoder, gcfg, max_surface_points=det["max_surface_points"],
                                      max_rays=det["max_rays"], extract_meshes=True,
                                      voxels_dim=self.config["voxels_dim"], **self.mix.get("pipeline", {}))
            if self.gn_capture is not None:
                self.gn_capture.fn = faults.wrap_gn(pipe.recon, self.variant)
                pipe.recon = self.pick_log.wrap(self.gn_capture)
            return pipe

        system = _system_class()(
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
                                               async_ba=True, async_keyframe=True, async_objects=True,
                                               ba_objects=True),
            device=self.device,
        )
        object.__setattr__(system, "cell", self)
        system.attach_telemetry(spans)
        return system

    # ------------------------------------------------------------------ the window
    def window(self, seconds: float, trace=None) -> float:
        from dspslam_tpu_torch.utils import timing

        chk, rng, m = self.mix["check"], self.mono_rng, self.modules
        self.det_sampler = Sampler(rng, chk["det_spacing"], chk["det_cap"])

        def site(module, name, key):
            return module, name, tap(module, name, Sampler(rng, chk[key + "_spacing"], chk[key + "_cap"]))

        self.taps = {"det": site(m["mono"], "build_mono_detection", "mono_det"),
                     "pca": site(m["cuboid"], "compute_cuboid_pca", "seed"),
                     "floor": site(m["cuboid"], "floor_scale_to_domain", "seed"),
                     "mesh": site(m["mesh"], "decode_sdf_grid", "mesh")}
        self.pick_log = PickLog(m["pipeline"].best_of)
        m["pipeline"].best_of = self.pick_log.best_of
        try:
            return super().window(seconds, trace)
        finally:
            m["pipeline"].best_of = self.pick_log.fn
            for module, name, capture in reversed(list(self.taps.values())):
                setattr(module, name, capture.fn)
            self.det_sampler = None
            now = timing.totals()
            counts = {k: now.get(k, 0) - self._counts0.get(k, 0) for k in COUNTERS}
            counts["detect_mono_calls"] = len(self.spans.samples.get("detect_mono", ()))
            counts["drives_completed"] = sum(r["frames"] == self.mix["frames_per_drive"] for r in self.drives_done)
            self.log.notes["window_counts"] = counts

    def release(self):
        super().release()
        if self.tap2d is not None:
            self.tap2d.remove()
        detfaults.restore(self._saved_det)
        monofaults.restore(self._saved_mono)
        self.det2d = self.tap2d = None

    # ------------------------------------------------------------------ correct
    def check(self) -> dict:
        """kitti_full's numbers on the mono path, the detector's on the
        sampled keyframes and the mono stages' (the module's docstring)."""
        out = super().check()
        det = self.config["detection"]
        sd2 = ref2d.load(self.weights_2d, self.device)
        readings = [det2d_gaps(k["rec"], sd2, k["image"], det["detector_2d"]) for k in self.det_kept]
        if not readings:
            raise RuntimeError("no keyframe's detection was sampled in the window")
        out.update(checks.worst(readings))
        self.checked["detect_keyframes"] = len(readings)
        out.update(self.mono_numbers())
        return out

    def step_numbers(self, dec, dec64, params) -> dict:
        """The mono GN's steps against the reference's, relative to the
        step (the module's docstring), worst over the sampled calls."""
        readings = [step_rel_gaps(args, prog, record, dec, dec64, params)
                    for args, prog, record, _ in self.gn_capture.kept]
        readings = [r for r in readings if r is not None]
        if not readings:
            raise RuntimeError("no object GN call with all its iterations was sampled in the window")
        return checks.worst(readings)

    def mono_numbers(self) -> dict:
        taps, out = {k: capture.kept for k, (_, _, capture) in self.taps.items()}, {}
        dets = taps["det"]
        if not dets:
            raise RuntimeError("no mono detection was sampled in the window")
        out["mono_det_miss"] = float(max(det_miss(*k) for k in dets))
        seeds = [pca_gap(*k) for k in taps["pca"]] + [floor_gap(*k) for k in taps["floor"]]
        if not seeds:
            raise RuntimeError("no object seed was sampled in the window")
        out["mono_seed_gap"] = max(seeds)
        if not self.pick_log.kept:
            raise RuntimeError("no first reconstruction was sampled in the window")
        dec, dec64 = gncheck.plain_decoders(*self.decoder_weights, self.config["decoder"]["latent_in"])
        params = gn_ref.GNParams.from_config(self.config["optimizer"])
        out.update(self.step_numbers(dec, dec64, params))
        picks = [pick_reading(dec, params, *k) for k in self.pick_log.kept]
        out["mono_pick_miss"] = float(sum(p["miss"] for p in picks))
        out["mono_loss_gap"] = max(p["loss_gap"] for p in picks)
        out["mono_candidates_apart"] = min(p["apart"] for p in picks)
        meshes = taps["mesh"]
        if not meshes:
            raise RuntimeError("no mesh was sampled in the window")
        rng = np.random.default_rng(self.mono_rng.integers(2 ** 63))
        out["mesh_grid_gap"] = max(mesh_gap(dec, rng, self.mix["check"]["grid_rows"], *k) for k in meshes)
        self.checked.update(mono_detections=len(dets), mono_seeds=len(seeds), mono_picks=len(picks),
                            mono_meshes=len(meshes))
        return out


def det2d_gaps(rec: dict, sd: dict, image, cfg: dict) -> dict:
    """detcheck.py's 2D numbers of one sampled keyframe, the R-CNN's boxes
    compared with class ties taken (the module's docstring)."""
    out = detcheck.det2d_gaps(rec, sd, image, cfg)
    box = box_gap(rec, sd)
    out.update(det2d_box_gap=box, det2d_head_gap=max(out["det2d_rpn_gap"], box, out["det2d_mask_gap"]))
    return out


def box_gap(rec: dict, sd: dict) -> float:
    """The R-CNN head against the reference's: every class's probability,
    and each proposal's box for the port's class where the reference's
    probability of it is within CLASS_BAND of its best, else for the
    reference's best class."""
    feats = rec["resnet_fpn"][0][1]
    (_, _, props, valid, image_hw, _), (boxes, _, classes, probs) = rec["box_head"][0]
    head = "roi_head.bbox_head."
    x = ref2d.roi_align(feats, props, 7).flatten(1)
    for i in range(2):
        x = torch.relu(ref2d._fc(x, sd, f"{head}shared_fcs.{i}", ref2d.F32))
    r_probs = torch.softmax(ref2d._fc(x, sd, head + "fc_cls", ref2d.F32), dim=-1)[:, :-1]    # background last
    reg = ref2d._fc(x, sd, head + "fc_reg", ref2d.F32).reshape(len(x), -1, 4)
    rows = torch.arange(len(x), device=x.device)
    best = torch.argmax(r_probs, dim=-1)
    cls = torch.where(r_probs[rows, best] - r_probs[rows, classes] <= CLASS_BAND, classes, best)
    d = reg[rows, cls] * torch.tensor(ref2d.TARGET_STDS, device=x.device)
    r_boxes = ref2d.clip(ref2d.decode(d, props), image_hw)
    live = valid > 0
    return max(detcheck.rel(probs[live], r_probs[live]), detcheck.rel(boxes[live], r_boxes[live]))


def det_miss(args, det, _, kwargs) -> int:
    """The differences of one `build_mono_detection` call from the
    reference's (the module's docstring)."""
    masks, boxes, invK = args[:3]
    ref = ref_mono.mono_detection(masks, boxes, invK, kwargs["min_mask_area"], kwargs["bg_stride"],
                                  kwargs["max_bg_rays"], kwargs["mask_erosion"])
    if det is None or ref is None:
        return int((det is None) != (ref is None))
    miss = int(np.count_nonzero(det.mask != ref["mask"])) + int(not np.array_equal(det.bbox, ref["bbox"]))
    p = np.zeros((0, 3), np.float32) if det.rays is None else det.rays
    r = np.zeros((0, 3), np.float32) if ref["rays"] is None else ref["rays"]
    n = min(len(p), len(r))
    return miss + abs(len(p) - len(r)) + int((np.abs(p[:n] - r[:n]).max(-1, initial=0.0) > RAY_TOL).sum())


def step_rel_gaps(args, prog: dict, record: list, dec, dec64, p: gn_ref.GNParams) -> dict | None:
    """gn_step_rel_median and gn_out_rel_gap of one sampled GN call (the
    module's docstring); None where its iterations did not all run on every
    object (gncheck's gn_calls_short counts that call)."""
    B, P, L = args[0].shape[0], args[1].shape[1], p.code_len
    surf = [r for r in record if r[0] == "k1"][0::2]
    if len(surf) != p.num_iterations or any(x.shape[0] != B * P for _, x, _, _ in surf):
        return None
    live = (args[2] > 0) & (args[2].sum(-1, keepdim=True) > 0)
    objects = live.any(-1)
    if not objects.any():
        return {"gn_step_rel_median": 0.0, "gn_out_rel_gap": 0.0}
    states = [(gncheck.recover_pose(args[1], x.reshape(B, P, -1)[..., L:L + 3]), x.reshape(B, P, -1)[:, 0, :L])
              for _, x, _, _ in surf]
    following = states[1:] + [(lie.inverse_sim3(prog["t_cam_obj"]), prog["code"])]

    def apart(a, b):
        """each object's largest surface difference (m) at its live points"""
        d = (gncheck.metric_sdf(dec64, *a, args[1]) - gncheck.metric_sdf(dec64, *b, args[1])).abs()
        return torch.where(live, d, 0.0).amax(-1)

    rel = []
    for state, nxt in zip(states, following):
        ref = gn_ref.step(dec, p, *state, *args[1:7])[:2]
        rel.append(float((apart(nxt, ref) / apart(state, ref).clamp(min=MOVE_FLOOR))[objects].max()))
    return {"gn_step_rel_median": float(np.median(rel)), "gn_out_rel_gap": rel[-1]}


def _sim3_rel(prog, ref) -> float:
    a, b = np.asarray(prog, np.float64)[:3, :4], np.asarray(ref, np.float64)[:3, :4]
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def pca_gap(args, out, _, kwargs) -> float:
    ref = ref_mono.cuboid_pca(args[0])
    if out is None or ref is None:
        return 0.0 if (out is None) == (ref is None) else float("inf")
    T = ref["T_wo_sim3"]
    return min(_sim3_rel(out["T_wo_sim3"], T), _sim3_rel(out["T_wo_sim3"], ref_mono.flip(T)))


def floor_gap(args, out, _, kwargs) -> float:
    return _sim3_rel(out, ref_mono.floor_scale(*args[:2]))


def pick_reading(dec, params, args, record, losses, finite, kept) -> dict:
    """One first reconstruction: whether its kept candidate is one the
    reference's losses allow, the program's losses against the reference's
    (relative), and how far apart the reference's two losses are
    (relative)."""
    surf = [r for r in record if r[0] == "k1"][0::2]
    if len(surf) != params.num_iterations:      # the configuration's iterations did not all run
        return {"miss": 1, "loss_gap": float("inf"), "apart": 0.0}
    B, P, L = args[0].shape[0], args[1].shape[1], params.code_len
    rows = surf[-1][1].reshape(B, P, -1)
    T, code = gncheck.recover_pose(args[1], rows[..., L:L + 3]), rows[:, 0, :L]
    rl = gn_ref.step(dec, params, T, code, *args[1:7])[3].double().cpu().numpy()
    scale = max(float(np.abs(rl).max()), 1e-30)
    want = ref_mono.pick(rl, finite)
    tie = kept is not None and want is not None and abs(rl[kept] - rl[want]) <= PICK_BAND * scale
    gap = float(np.max(np.abs(np.asarray(losses, np.float64) - rl) / np.maximum(np.abs(rl), 1e-30)))
    return {"miss": int(kept != want and not tie), "loss_gap": gap, "apart": float(abs(rl[0] - rl[1]) / scale)}


def mesh_gap(dec, rng, rows: int, args, grid, _, kwargs) -> float:
    """A seeded sample of one 64^3 grid against the plain decoder at the
    same voxels' points ([-1, 1]^3, x slowest, z fastest)."""
    _, code, dim = args[:3]
    lin = np.linspace(-1.0, 1.0, dim, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    idx = rng.choice(len(pts), min(rows, len(pts)), replace=False)
    x = torch.from_numpy(pts[idx]).to(grid.device)
    ref = dec(torch.cat([code.reshape(1, -1).expand(len(idx), -1), x], -1))
    return float((grid.reshape(-1)[torch.from_numpy(idx).to(grid.device)] - ref).abs().max())


Cell = MonoDetectCell
