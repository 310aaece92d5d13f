"""Tracking front-end: the per-frame state machine for stereo, monocular
and RGB-D input.

Port of dspslam_tpu/slam/tracking.py (the reference's Tracking thread,
Tracking.cc:275-517): extract -> depth (stereo matching, the RGB-D depth
image, none for mono) -> motion-model projection matching -> motion-only
pose GN -> local-map tracking -> keyframe decision -> map-point spawning
from depth. Mono starts with a two-view initialization (matches on the
device, H / F recovery on the host) and gets its points from the local
mapper's triangulation.

In the steady state the whole device pipeline runs as one program
(slam/frame_step.py) with one result fetch per frame; initialization,
loss and fallbacks use the modular stage-by-stage code. With
`TrackerConfig.pipelined` the host runs one frame behind the camera:
frame k+1 is queued on the device before frame k's results are read, and
those results stream back through non-blocking copies into pinned host
memory, which `_finalize_inflight` waits for with a CUDA event.

`Tracker(..., device=None)` runs on the card and raises without one;
pass device="cpu" to run on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np
import torch

from ..frontend import matcher, orb, stereo, undistort
from ..ops import lie_np
from ..utils import timing
from . import frame_step, initializer, pose_opt
from .map import Frame, KeyFrame, Map, MapPoint, entry_device, feats_to_numpy, to_torch

LOCAL_POINT_CAP = 4096


class State(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclasses.dataclass
class TrackerConfig:
    fx: float = 707.0912
    fy: float = 707.0912
    cx: float = 601.8873
    cy: float = 183.1104
    bf: float = 379.8145
    width: int = 1241
    height: int = 376
    th_depth: float = 35.0              # "ThDepth": close-point gate in baselines
    max_frames_between_kf: int = 10     # fps
    min_frames_between_kf: int = 0
    min_init_features: int = 500
    min_track_matches: int = 10
    min_inliers: int = 10
    search_radius_motion: float = 15.0
    search_radius_local: float = 5.0
    # plumb-bob lens coefficients (k1, k2, p1, p2, k3); stereo input must
    # be rectified (the reference asserts the same)
    dist_coeffs: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # constant-velocity model smoothing in the SE(3) tangent (1.0 = the
    # reference's raw frame-to-frame motion). The raw model feeds
    # estimation error back doubled (pred = 2 e_k - e_{k-1}); below 1 the
    # per-frame pose noise enters the next prediction attenuated.
    velocity_smoothing: float = 0.6
    # one-frame software pipelining of the fused stereo path: frame k+1 is
    # queued before frame k's results are read; host state runs one frame
    # behind the camera. Callers must flush() at sequence end.
    pipelined: bool = False

    @property
    def intrinsics(self) -> np.ndarray:
        return np.asarray([self.fx, self.fy, self.cx, self.cy, self.bf], np.float32)

    @property
    def depth_threshold(self):
        """Close-point depth gate in meters: ThDepth * baseline
        (reference Tracking.cc: mThDepth = mbf * ThDepth / fx)."""
        return self.th_depth * self.bf / self.fx


def tracker_from_system_config(system_cfg, slam_map: Map | None = None,
                               pipelined: bool = False, device=None) -> "Tracker":
    """A Tracker with the settings dspslam_tpu/apps/dsp_slam.py:34-47
    derives from a SystemConfig (camera, ORB budget and thresholds)."""
    cam = system_cfg.camera
    cfg = TrackerConfig(
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, bf=cam.baseline_fx,
        width=cam.width, height=cam.height, th_depth=cam.depth_threshold,
        max_frames_between_kf=int(cam.fps),
        dist_coeffs=(cam.k1, cam.k2, cam.p1, cam.p2, cam.k3),
        pipelined=pipelined,
    )
    params = orb.ORBParams(
        n_features=system_cfg.orb.n_features,
        scale_factor=system_cfg.orb.scale_factor,
        n_levels=system_cfg.orb.n_levels,
        fast_threshold=system_cfg.orb.ini_th_fast,
        min_threshold=system_cfg.orb.min_th_fast,
    )
    return Tracker(cfg, Map() if slam_map is None else slam_map, params, device=device)


def _prefetch_to_host(tree: dict):
    """Start device->host copies of every tensor of a dict of dicts into
    pinned host memory; returns (host tree, event recorded after the
    copies, or None on the CPU). The copies stream back while the device
    runs the next frame; read the host tree after `event.synchronize()`."""
    on_card = any(
        v.is_cuda for d in tree.values() for v in d.values() if isinstance(v, torch.Tensor)
    )
    if not on_card:
        return tree, None
    host = {}
    for name, d in tree.items():
        host[name] = {}
        for k, v in d.items():
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[name][k] = buf.copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _host_result(host: dict, event) -> dict:
    """Wait for `_prefetch_to_host`'s copies; the dicts as numpy."""
    if event is not None:
        event.synchronize()
    return {name: feats_to_numpy(d) for name, d in host.items()}


def _pack_map_points(entries, cap):
    """entries: (id, pos, desc, level, dist_create) -> padded arrays."""
    ids = np.full(cap, -1, np.int64)
    pos = np.zeros((cap, 3), np.float32)
    desc = np.zeros((cap, 8), np.uint32)
    level = np.zeros(cap, np.int32)
    dist0 = np.ones(cap, np.float32)
    n = min(len(entries), cap)
    for i in range(n):
        ids[i], pos[i], desc[i], level[i], dist0[i] = entries[i]
    valid = (ids >= 0).astype(np.float32)
    return ids, pos, desc, level, dist0, valid


class Tracker:
    def __init__(self, config: TrackerConfig, slam_map: Map,
                 orb_params: orb.ORBParams = orb.ORBParams(), device=None):
        self.device = entry_device(device, "Tracker")
        self.cfg = config
        self.map = slam_map
        self.orb_params = orb_params
        self.intrinsics = torch.from_numpy(config.intrinsics).to(self.device)
        self.state = State.NOT_INITIALIZED
        self.last_frame: Frame | None = None
        self.velocity: np.ndarray | None = None   # T_cl: last->current motion
        self.ref_kf: KeyFrame | None = None
        self.last_kf_frame_id = -1
        self.frames_since_kf = 0
        self.new_keyframes: list[KeyFrame] = []   # queue for local mapping
        self.trajectory: list[tuple[float, np.ndarray, bool]] = []
        self.relocalizer = None                   # hook: relocalization (later slice)
        self.localization_only = False            # tracking against a frozen map
        self.mapper_idle_fn = None                # set by the system facade
        # pipelined-mode state (cfg.pipelined)
        self.frame_seq = 0                        # per-call sequence index
        self._current_seq = -1                    # seq of the frame being finalized
        self._chain = None                        # device-side chain state tuple
        self._inflight: list = []                 # dispatched-not-finalized FIFO
        self._inflight_poisoned = False           # chain broke; redo from images
        self._init_ref: Frame | None = None       # mono: the two-view reference frame
        self.n_redone = 0                         # frames re-tracked by _redo_poisoned

    # ------------------------------------------------------------------
    def _upload_image(self, img) -> torch.Tensor:
        """Image on the tracker's device, uint8 kept (the device programs
        cast to f32). On the card the copy goes through pinned memory and
        does not wait for the device's queued work."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        a = np.asarray(img)
        t = torch.from_numpy(np.ascontiguousarray(a if a.dtype == np.uint8 else a.astype(np.float32)))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_device(self, *arrays):
        """Host numpy arrays -> device tensors (uint32 as int32 bits)."""
        return tuple(to_torch(a, self.device) for a in arrays)

    def _radii(self):
        return (float(self.cfg.search_radius_motion), float(self.cfg.search_radius_local))

    # ------------------------------------------------------------------
    def process_stereo(self, img_l: np.ndarray, img_r: np.ndarray,
                       timestamp: float) -> Frame | None:
        """Per-frame stereo tracking (rectified images). The steady state
        runs the fused one-program path; initialization, loss and fallback
        paths run the modular stage-by-stage code. With cfg.pipelined the
        steady state returns the previous frame's result (None on the first
        pipelined call); callers flush() at sequence end."""
        return self._process("stereo", (img_l, img_r), timestamp)

    def process_mono(self, img: np.ndarray, timestamp: float) -> Frame | None:
        """Monocular per-frame tracking: two-view initialization, then as
        process_stereo without the stereo residual. The steady state runs
        fused (or pipelined) only for a distortion-free camera; with lens
        coefficients it stays modular, which undistorts keypoints on the
        host (Frame::UndistortKeyPoints)."""
        return self._process("mono", (img,), timestamp)

    def process_rgbd(self, img: np.ndarray, depth: np.ndarray,
                     timestamp: float) -> Frame | None:
        """RGB-D per-frame tracking: each keypoint's depth from the depth
        image gives a virtual right-view coordinate. Fused (or pipelined)
        with the depth lookup on the device for distortion-free cameras;
        distorted ones stay modular (the lookup at raw pixels, then host
        undistortion)."""
        return self._process("rgbd", (img, depth), timestamp)

    def _process(self, mode: str, imgs: tuple, timestamp: float) -> Frame | None:
        self._current_seq = self.frame_seq
        self.frame_seq += 1
        steady = (
            self.state == State.OK
            and self.ref_kf is not None
            and (mode == "stereo" or not undistort.has_distortion(self.cfg.dist_coeffs))
            and (
                self._chain is not None
                or (self.velocity is not None and self.last_frame is not None)
            )
        )
        if self.cfg.pipelined:
            if steady:
                return self._process_pipelined(mode, imgs, timestamp)
            self.flush()
            return self._process_modular(mode, imgs, timestamp)
        if steady and self.velocity is not None and self.last_frame is not None:
            return self._process_fused(mode, imgs, timestamp)
        return self._process_modular(mode, imgs, timestamp)

    def _upload(self, mode: str, imgs: tuple) -> tuple:
        """A frame's images on the device; an RGB-D depth image as f32."""
        if mode == "rgbd":
            img, depth = imgs
            if not isinstance(depth, torch.Tensor):
                depth = np.asarray(depth, np.float32)
            return self._upload_image(img), self._upload_image(depth).to(torch.float32)
        return tuple(self._upload_image(x) for x in imgs)

    def _program(self, mode: str, imgs: tuple, local: tuple, T_pred=None, last=None):
        """The mode's fused frame program from a motion prediction and the
        last frame's points, or with T_pred None its chained program from
        self._chain. Returns (feats, depth dict or None for mono, result,
        chain or None)."""
        p, r, bf, intr = self.orb_params, self._radii(), float(self.cfg.bf), self.intrinsics
        if T_pred is not None:
            args = (T_pred, *last, *local)
            if mode == "stereo":
                feats, st, result = frame_step.track_frame_stereo(p, r, *imgs, bf, bf / 0.5, intr, *args)
            elif mode == "rgbd":
                feats, st, result = frame_step.track_frame_rgbd(p, r, *imgs, bf, intr, *args)
            else:
                (feats, result), st = frame_step.track_frame_mono(p, r, *imgs, intr, *args), None
            return feats, st, result, None
        a = float(self.cfg.velocity_smoothing)
        args = (*self._chain, *local)
        if mode == "stereo":
            return frame_step.track_frame_stereo_chained(p, r, a, *imgs, bf, bf / 0.5, intr, *args)
        if mode == "rgbd":
            return frame_step.track_frame_rgbd_chained(p, r, a, *imgs, bf, intr, *args)
        feats, result, chain = frame_step.track_frame_mono_chained(p, r, a, *imgs, intr, *args)
        return feats, None, result, chain

    @staticmethod
    def _frame(timestamp: float, feats: dict, st: dict | None) -> Frame:
        if st is None:
            return Frame(timestamp, feats)
        return Frame(timestamp, feats, depth=st["depth"], u_right=st["u_right"])

    def _last_pack(self):
        """Device pack of the last frame's tracked map points."""
        with timing.span("track_pack"):
            ids = self.last_frame.map_point_ids
            _, lpos, ldesc, llvl, ldist, lval = _pack_map_points(
                self._entries_from_ids(ids[ids >= 0]), LOCAL_POINT_CAP
            )
            return self._to_device(lpos, ldesc, llvl, ldist, lval)

    def _process_fused(self, mode: str, imgs: tuple, timestamp: float) -> Frame:
        dev_imgs = self._upload(mode, imgs)
        last = self._last_pack()
        (cid, cpos, _, _, _, cval), dev = self._local_pack()
        T_pred = (self.velocity @ self.last_frame.T_cw).astype(np.float32)
        feats_j, st_j, result_j, _ = self._program(mode, dev_imgs, dev, *self._to_device(T_pred), last)
        # one fetch for everything the host needs this frame
        with timing.span("result_fetch"):
            tree = {"feats": feats_j, "result": result_j}
            if st_j is not None:
                tree["st"] = st_j
            out = _host_result(*_prefetch_to_host(tree))
        frame = self._frame(timestamp, out["feats"], out.get("st"))
        frame, _ = self._apply_fused_result(frame, out["result"], cid, cpos, cval)
        return frame

    def _apply_fused_result(self, frame, result, cid, cpos, cval, velocity=None):
        """Host bookkeeping after a fused / pipelined device program: pose
        acceptance, match bookkeeping, stats, KF decision, fallbacks.
        Returns (frame, ok); ok False means the device track was rejected
        and the modular fallback ran (recovered or LOST)."""
        with timing.span("track_apply"):
            n_in = int(result["n_inliers"])
            # motion-model acceptance mirrors the reference: the prediction
            # stage must find >= 20 matches (Tracking::TrackWithMotionModel),
            # else tracking falls back to the prior-free reference-KF search
            ok = int(result["n_motion"]) >= max(self.cfg.min_track_matches, 20) \
                and n_in >= max(self.cfg.min_inliers, 30) \
                and bool(np.isfinite(result["T_cw"]).all())
            if ok:
                frame.T_cw = np.asarray(result["T_cw"], np.float32)
                idx = result["match_idx"]
                inlier = result["inlier"]
                frame.map_point_ids[:] = -1
                for c in np.nonzero(inlier > 0)[0]:
                    kp = int(idx[c])
                    if kp >= 0 and cid[c] >= 0:
                        frame.map_point_ids[kp] = cid[c]
                self.n_inliers = n_in
                self.state = State.OK
                if velocity is not None:
                    self.velocity = np.asarray(velocity, np.float32)
                else:
                    self._update_velocity(frame)
                self._update_point_stats(frame, cid, cpos, cval)
                if self._need_new_keyframe(frame):
                    self._create_keyframe(frame)
                self.frames_since_kf += 1
            else:
                # fall back to the modular path (reference-KF search etc.)
                mod_ok = self._track_reference_keyframe(frame)
                if mod_ok:
                    mod_ok = self._track_local_map(frame)
                if mod_ok:
                    self.state = State.OK
                    self._update_velocity(frame)
                    if self._need_new_keyframe(frame):
                        self._create_keyframe(frame)
                    self.frames_since_kf += 1
                else:
                    self.state = State.LOST
                    if len(self.map.keyframes) <= 5 and self.relocalizer is None:
                        self.reset()
            self.trajectory.append((frame.timestamp, frame.T_cw.copy(), self.state != State.OK))
            self.last_frame = frame
            return frame, ok

    def _local_pack(self):
        """Packed local-map candidates, host + device copies, cached until
        the map changes (keyframe insertion / culling)."""
        with timing.span("track_pack"):
            cache_key = (self.ref_kf.id, len(self.map.points), len(self.map.keyframes))
            if getattr(self, "_local_cache_key", None) != cache_key:
                kf_ids = self.map.local_keyframes(self.ref_kf, 20)
                local_entries = self._entries_from_ids(self.map.points_seen_by(kf_ids))
                self._local_cache = _pack_map_points(local_entries, LOCAL_POINT_CAP)
                cid, cpos, cdesc, clvl, cdist, cval = self._local_cache
                self._local_cache_dev = self._to_device(cpos, cdesc, clvl, cdist, cval)
                # object refs aligned with cid rows, resolved once per refresh
                self._local_cache_objs = [
                    self.map.points.get(int(i)) if i >= 0 else None for i in cid
                ]
                self._local_cache_key = cache_key
            return self._local_cache, self._local_cache_dev

    # ------------------------------------------------------------------
    # pipelined steady-state path (cfg.pipelined)
    def _seed_chain(self):
        """Seed the device chain state from host tracking state."""
        self._chain = (
            *self._to_device(
                np.asarray(self.last_frame.T_cw, np.float32),
                np.asarray(self.velocity, np.float32),
            ),
            *self._last_pack(),
        )

    def _redo_poisoned(self):
        """Re-track the poisoned in-flight frames synchronously, in order,
        from their retained images (their device chain was rejected).
        Returns the last recovered frame."""
        q, self._inflight = self._inflight, []
        self._inflight_poisoned = False
        out = None
        cur_seq = self._current_seq
        for h in q:
            if not (
                self.state == State.OK and self.velocity is not None
                and self.last_frame is not None and self.ref_kf is not None
            ):
                break
            self._current_seq = h["seq"]
            self.n_redone += 1
            out = self._process_fused(h["mode"], h["imgs"], h["timestamp"])
        self._current_seq = cur_seq
        return out

    def _process_pipelined(self, mode: str, imgs: tuple, timestamp: float):
        if self._inflight and self._inflight_poisoned:
            self._redo_poisoned()
            if self.state != State.OK:
                return self._process_modular(mode, imgs, timestamp)

        dev_imgs = self._upload(mode, imgs)
        (cid, cpos, _, _, _, cval), dev = self._local_pack()
        if self._chain is None:
            self._seed_chain()
        feats_j, st_j, result_j, chain = self._program(mode, dev_imgs, dev)
        # feats stay on the device: Frame materializes them lazily (only
        # keyframes read them on the host)
        tree = {"result": result_j}
        if st_j is not None:
            tree["st"] = st_j
        host, event = _prefetch_to_host(tree)
        self._inflight.append({
            "mode": mode, "seq": self._current_seq, "timestamp": timestamp, "imgs": dev_imgs,
            "feats_j": feats_j, "host": host, "event": event,
            "cid": cid, "cpos": cpos, "cval": cval,
        })
        self._chain = chain
        return self._drain_inflight()

    def _drain_inflight(self):
        """Finalize every queue entry but the newest (one frame in flight).
        Returns the newest finalized frame (None while filling)."""
        out = None
        while len(self._inflight) > 1 and not self._inflight_poisoned:
            out = self._finalize_inflight(self._inflight.pop(0))
        return out

    def _finalize_inflight(self, h) -> Frame:
        """Wait for a dispatched frame's results and run the host
        bookkeeping (one frame behind in pipelined mode)."""
        with timing.span("result_fetch"):
            out = _host_result(h["host"], h["event"])
        result = out["result"]
        frame = self._frame(h["timestamp"], h["feats_j"], out.get("st"))
        cur_seq = self._current_seq
        self._current_seq = h["seq"]
        frame, ok = self._apply_fused_result(
            frame, result, h["cid"], h["cpos"], h["cval"], velocity=result["velocity"],
        )
        self._current_seq = cur_seq
        if not ok:
            # the device chain carried a rejected pose: drop it and mark
            # newer in-flight frames for synchronous re-tracking
            self._chain = None
            if self._inflight:
                self._inflight_poisoned = True
        return frame

    def flush(self) -> Frame | None:
        """Drain all pipelined in-flight frames (sequence end / mode
        switches). Returns the last finalized frame, if any."""
        out = None
        while self._inflight:
            if self._inflight_poisoned:
                out = self._redo_poisoned() or out
            else:
                out = self._finalize_inflight(self._inflight.pop(0)) or out
        return out

    def _process_modular(self, mode: str, imgs: tuple, timestamp: float) -> Frame:
        """Stage-by-stage tracking: initialization, loss and fallback frames."""
        with timing.span("track_modular"):
            if mode == "stereo":
                jl, jr = self._upload(mode, imgs)
                feats_l, feats_r = orb.extract_stereo(jl, jr, self.orb_params)
                st = stereo.stereo_match(
                    feats_l, feats_r, jl, jr, float(self.cfg.bf),
                    float(self.cfg.bf / 0.5),  # max disparity ~ minZ 0.5 m
                )
                out = _host_result(*_prefetch_to_host({"feats": feats_l, "st": st}))
                frame = self._frame(timestamp, out["feats"], out["st"])
            else:
                feats = orb.extract(self._upload_image(imgs[0]), self.orb_params)
                feats = _host_result(*_prefetch_to_host({"feats": feats}))["feats"]
                st = None
                if mode == "rgbd":
                    # the depth lookup reads RAW pixels (the sensor image); the
                    # geometry downstream uses undistorted ones
                    # (Frame::ComputeStereoFromRGBD)
                    depth = imgs[1]
                    depth = depth.cpu().numpy() if isinstance(depth, torch.Tensor) else np.asarray(depth)
                    xy = feats["xy"].astype(np.int32)
                    d = depth[np.clip(xy[:, 1], 0, depth.shape[0] - 1),
                              np.clip(xy[:, 0], 0, depth.shape[1] - 1)].astype(np.float32)
                    d = np.where(feats["valid"] > 0, d, -1.0)
                self._undistort_feats(feats)
                if mode == "rgbd":
                    ur = np.where(d > 0, feats["xy"][:, 0] - self.cfg.bf / np.maximum(d, 1e-6), -1.0)
                    st = {"depth": d, "u_right": ur}
                frame = self._frame(timestamp, feats, st)
            self._track(frame, mono=mode == "mono")
            return frame

    def _undistort_feats(self, feats: dict):
        """Replace raw keypoint pixels with undistorted ones in place
        (Frame::UndistortKeyPoints). No-op for zero coefficients."""
        if not undistort.has_distortion(self.cfg.dist_coeffs):
            return
        K = np.array([[self.cfg.fx, 0, self.cfg.cx], [0, self.cfg.fy, self.cfg.cy], [0, 0, 1.0]],
                     np.float64)
        feats["xy"] = undistort.undistort_points(feats["xy"], K, self.cfg.dist_coeffs)

    # ------------------------------------------------------------------
    def _track(self, frame: Frame, mono: bool = False):
        if self.state == State.NOT_INITIALIZED:
            if mono:
                self._initialize_mono(frame)
            else:
                self._initialize_stereo(frame)
        elif self.state == State.LOST:
            ok = self.relocalizer is not None and self.relocalizer.try_relocalize(frame)
            if ok:
                ok = self._track_local_map(frame)
            if ok:
                self.state = State.OK
                self.velocity = None
        else:
            ok = self._track_with_motion_model(frame)
            if not ok:
                ok = self._track_reference_keyframe(frame)
            if ok:
                ok = self._track_local_map(frame)
            if ok:
                self.state = State.OK
                self._update_velocity(frame)
                if self._need_new_keyframe(frame):
                    self._create_keyframe(frame)
                self.frames_since_kf += 1
            else:
                self.state = State.LOST
                # lost right after initialization (<= 5 keyframes): reset
                # the map and re-initialize (Tracking.cc:483-491)
                if len(self.map.keyframes) <= 5 and self.relocalizer is None:
                    self.reset()
        self.trajectory.append((frame.timestamp, frame.T_cw.copy(), self.state != State.OK))
        self.last_frame = frame

    def _update_velocity(self, frame: Frame):
        """Constant-velocity model update, smoothed on the SE(3) geodesic
        when velocity_smoothing < 1."""
        if self.last_frame is None:
            return
        v_obs = (frame.T_cw @ self.last_frame.T_wc).astype(np.float32)
        a = float(self.cfg.velocity_smoothing)
        if self.velocity is None or a >= 1.0:
            self.velocity = v_obs
        else:
            self.velocity = lie_np.interp_se3(self.velocity, v_obs, a)

    def reset(self):
        """Full system reset: wipe the map and return to initialization."""
        self.map.keyframes.clear()
        self.map.points.clear()
        self.map.objects.clear()
        self.state = State.NOT_INITIALIZED
        self.last_frame = None
        self.velocity = None
        self.ref_kf = None
        self.new_keyframes.clear()
        self._chain = None
        self._inflight = []
        self._inflight_poisoned = False
        self._local_cache_key = None
        self._init_ref = None
        self.frames_since_kf = 0

    # ------------------------------------------------------------------
    def _initialize_mono(self, frame: Frame):
        """Two-view initialization (MonocularInitialization,
        Tracking.cc:574-767): hold a reference frame, match each new frame
        against it in wide windows on the device, recover H or F on the
        host (slam/initializer.py), and spawn the first two keyframes with
        the triangulated points at median depth 1."""
        n_valid = int(frame.feats["valid"].sum())
        if self._init_ref is None:
            if n_valid >= 100:
                self._init_ref = frame
            return
        ref = self._init_ref
        if n_valid < 100:
            self._init_ref = None
            return
        idx, _ = matcher.match_in_windows(ref.feats_torch(self.device), frame.feats_torch(self.device),
                                          radius=100.0, max_dist=50, ratio=0.9)
        idx = idx.cpu().numpy()
        m = np.nonzero(idx >= 0)[0]
        if len(m) < 80:
            self._init_ref = frame   # restart from the newer frame
            return
        p1 = ref.feats["xy"][m]
        p2 = frame.feats["xy"][idx[m]]
        K = np.array([[self.cfg.fx, 0, self.cfg.cx], [0, self.cfg.fy, self.cfg.cy], [0, 0, 1.0]])
        out = initializer.initialize_two_view(p1, p2, K)
        if out is None:
            return
        ref.T_cw = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = out["R"]
        T2[:3, 3] = out["t"]
        frame.T_cw = T2
        kf1 = KeyFrame(ref)
        kf2 = KeyFrame(frame)
        kf1.seq_idx = kf2.seq_idx = self._current_seq
        self.map.add_keyframe(kf1)
        self.map.add_keyframe(kf2)
        for j in np.nonzero(out["good_mask"])[0]:
            kp_ref = int(m[j])
            kp_cur = int(idx[m[j]])
            p = MapPoint(out["points3d"][j], ref.feats["desc"][kp_ref], kf1.id,
                         int(ref.feats["level"][kp_ref]), float(np.linalg.norm(out["points3d"][j])))
            self.map.add_point(p)
            self.map.add_observation(p, kf1, kp_ref)
            self.map.add_observation(p, kf2, kp_cur)
            frame.map_point_ids[kp_cur] = p.id
            ref.map_point_ids[kp_ref] = p.id
        self.map.update_covisibility(kf1)
        self.map.update_covisibility(kf2)
        self.new_keyframes.extend([kf1, kf2])
        self.ref_kf = kf2
        self.last_kf_frame_id = frame.id
        self.frames_since_kf = 0
        self.state = State.OK
        self.velocity = (frame.T_cw @ np.linalg.inv(ref.T_cw)).astype(np.float32)
        self._init_ref = None

    def _initialize_stereo(self, frame: Frame):
        n_valid = int(frame.feats["valid"].sum())
        if n_valid < self.cfg.min_init_features:
            return
        frame.T_cw = np.eye(4, dtype=np.float32)
        # stereo initialization creates a point for EVERY valid-depth
        # keypoint (Tracking::StereoInitialization)
        kf = self._spawn_keyframe_with_points(frame, min_points=None)
        if kf is None:
            return
        self.ref_kf = kf
        self.state = State.OK
        self.velocity = np.eye(4, dtype=np.float32)

    # ------------------------------------------------------------------
    def _project_points(self, T_cw, pos):
        pc = pos @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = self.cfg.fx * pc[:, 0] / z + self.cfg.cx
        v = self.cfg.fy * pc[:, 1] / z + self.cfg.cy
        in_img = (
            (pc[:, 2] > 0.1)
            & (u >= 0) & (u < self.cfg.width)
            & (v >= 0) & (v < self.cfg.height)
        )
        return np.stack([u, v], -1).astype(np.float32), in_img

    def _match_and_optimize(self, frame: Frame, entries, radius) -> int:
        """Project candidate map points, match, run pose GN. Returns #inliers."""
        ids, pos, desc, _, _, valid = _pack_map_points(entries, LOCAL_POINT_CAP)
        proj_xy, in_img = self._project_points(frame.T_cw, pos)
        valid = valid * in_img
        if valid.sum() < self.cfg.min_track_matches:
            return 0
        # the octave gate of the projection search is off (its default), so
        # no level is predicted for the candidates
        idx, dist = matcher.match_by_projection(
            *self._to_device(proj_xy, valid.astype(np.float32), desc), None,
            frame.feats_torch(self.device), radius=radius,
        )
        idx, dist = idx.cpu().numpy(), dist.cpu().numpy()
        matched = np.nonzero(idx >= 0)[0]
        if len(matched) < self.cfg.min_track_matches:
            return 0
        # resolve conflicts: one keypoint can win several points; keep best
        kp_of = {}
        for m in matched:
            kp = int(idx[m])
            if kp not in kp_of or dist[m] < dist[kp_of[kp]]:
                kp_of[kp] = m
        kp_idx = np.asarray(list(kp_of.keys()), np.int64)
        pt_slot = np.asarray(list(kp_of.values()), np.int64)

        n = len(kp_idx)
        cap = LOCAL_POINT_CAP
        pts_w = np.zeros((cap, 3), np.float32)
        obs = np.zeros((cap, 3), np.float32)
        inv_s2 = np.ones(cap, np.float32)
        vmask = np.zeros(cap, np.float32)
        smask = np.zeros(cap, np.float32)
        pts_w[:n] = pos[pt_slot]
        obs[:n, :2] = frame.feats["xy"][kp_idx]
        ur = frame.u_right[kp_idx] if frame.u_right is not None else -np.ones(n)
        obs[:n, 2] = np.where(ur > 0, ur, 0)
        smask[:n] = (ur > 0).astype(np.float32)
        inv_s2[:n] = 1.0 / frame.feats["sigma2"][kp_idx]
        vmask[:n] = 1.0

        T, inlier, _ = pose_opt.optimize_pose(
            *self._to_device(np.asarray(frame.T_cw, np.float32), pts_w, obs, inv_s2, vmask, smask),
            self.intrinsics,
        )
        inlier = inlier.cpu().numpy()[:n] > 0
        frame.T_cw = T.cpu().numpy()
        frame.map_point_ids[:] = -1
        frame.map_point_ids[kp_idx[inlier]] = ids[pt_slot[inlier]]
        return int(inlier.sum())

    def _track_with_motion_model(self, frame: Frame) -> bool:
        if self.velocity is None or self.last_frame is None:
            return False
        frame.T_cw = (self.velocity @ self.last_frame.T_cw).astype(np.float32)
        entries = self._entries_from_ids(
            self.last_frame.map_point_ids[self.last_frame.map_point_ids >= 0]
        )
        n_in = self._match_and_optimize(frame, entries, self.cfg.search_radius_motion)
        return n_in >= self.cfg.min_inliers

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        if self.ref_kf is None:
            return False
        frame.T_cw = self.ref_kf.T_cw.copy() if self.last_frame is None \
            else self.last_frame.T_cw.copy()
        entries = self._entries_from_ids(
            self.ref_kf.map_point_ids[self.ref_kf.map_point_ids >= 0]
        )
        n_in = self._match_and_optimize(frame, entries, 3 * self.cfg.search_radius_motion)
        return n_in >= self.cfg.min_inliers

    def _track_local_map(self, frame: Frame) -> bool:
        if self.ref_kf is None:
            return False
        kf_ids = self.map.local_keyframes(self.ref_kf, 20)
        entries = self._entries_from_ids(self.map.points_seen_by(kf_ids))
        n_in = self._match_and_optimize(frame, entries, self.cfg.search_radius_local)
        self.n_inliers = n_in
        if entries:
            ids = np.array([e[0] for e in entries])
            pos = np.stack([e[1] for e in entries])
            self._update_point_stats(frame, ids, pos, np.ones(len(ids)))
        # the reference accepts local-map tracking only with >= 30 inliers
        return n_in >= max(self.cfg.min_inliers, 30)

    def _entries_from_ids(self, ids):
        entries = []
        for p_id in ids:
            p = self.map.points.get(int(p_id))
            if p is None or p.bad:
                continue
            entries.append((p.id, p.position, p.descriptor, p.level, p.dist_create))
        return entries

    # ------------------------------------------------------------------
    def _update_point_stats(self, frame: Frame, ids, pos, valid):
        """IncreaseVisible for every local candidate in the frustum,
        IncreaseFound for tracked inliers (Tracking::SearchLocalPoints /
        TrackLocalMap), so that found_ratio decays for stale points."""
        T = frame.T_cw
        pc = pos @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        zs = np.where(z > 1e-6, z, 1e-6)
        u = self.cfg.fx * pc[:, 0] / zs + self.cfg.cx
        v = self.cfg.fy * pc[:, 1] / zs + self.cfg.cy
        vis = (
            (np.asarray(valid) > 0) & (z > 0.1)
            & (u >= 0) & (u < self.cfg.width)
            & (v >= 0) & (v < self.cfg.height)
        )
        found = np.isin(ids, frame.map_point_ids[frame.map_point_ids >= 0])
        # the cached local pack carries pre-resolved object refs
        cache = getattr(self, "_local_cache", None)
        objs = self._local_cache_objs if cache is not None and ids is cache[0] else None
        for i in np.nonzero(vis)[0]:
            p = objs[i] if objs is not None else self.map.points.get(int(ids[i]))
            if p is not None:
                p.n_visible += 1
                if found[i]:
                    p.n_found += 1

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Keyframe policy (Tracking::NeedNewKeyFrame): insert when enough
        frames have passed, or when tracking support has visibly decayed
        relative to the reference keyframe after a minimum spacing."""
        if self.localization_only or self.ref_kf is None:
            return False
        if self.frames_since_kf >= self.cfg.max_frames_between_kf:
            return True
        if self.frames_since_kf < max(self.cfg.min_frames_between_kf, 2):
            return False
        # decay-rule insertions wait for an idle local mapper
        if self.mapper_idle_fn is not None and not self.mapper_idle_fn():
            return False
        ref_matches = int((self.ref_kf.map_point_ids >= 0).sum())
        tracked = int((frame.map_point_ids >= 0).sum())
        if frame.depth is not None:
            close_untracked = (
                (frame.depth > 0)
                & (frame.depth < self.cfg.depth_threshold)
                & (frame.map_point_ids < 0)
            ).sum()
            if tracked < 100 and close_untracked > 70:
                return True
        return tracked < 0.5 * ref_matches and tracked > 15

    def _spawn_keyframe_with_points(self, frame: Frame, min_points=100):
        kf = KeyFrame(frame)
        kf.seq_idx = self._current_seq
        self.map.add_keyframe(kf)
        # carry over tracked points
        for kp_idx in np.nonzero(frame.map_point_ids >= 0)[0]:
            p = self.map.points.get(int(frame.map_point_ids[kp_idx]))
            if p is not None and not p.bad:
                self.map.add_observation(p, kf, int(kp_idx))
        # spawn new close points from stereo depth (Tracking.cc:1118-1160)
        if frame.depth is not None:
            depth = frame.depth
            candidates = np.nonzero(
                (depth > 0) & (frame.feats["valid"] > 0) & (frame.map_point_ids < 0)
            )[0]
            order = candidates[np.argsort(depth[candidates])]
            created = 0
            T_wc = frame.T_wc
            for kp_idx in order:
                z = float(depth[kp_idx])
                if min_points is not None and z > self.cfg.depth_threshold \
                        and created >= min_points:
                    break
                u, v = frame.feats["xy"][kp_idx]
                xc = np.array(
                    [(u - self.cfg.cx) * z / self.cfg.fx,
                     (v - self.cfg.cy) * z / self.cfg.fy, z, 1.0], np.float32
                )
                xw = (T_wc @ xc)[:3]
                p = MapPoint(xw, frame.feats["desc"][kp_idx], kf.id,
                             int(frame.feats["level"][kp_idx]), z)
                self.map.add_point(p)
                self.map.add_observation(p, kf, int(kp_idx))
                frame.map_point_ids[kp_idx] = p.id
                created += 1
        self.map.update_covisibility(kf)
        self.new_keyframes.append(kf)
        self.last_kf_frame_id = frame.id
        self.frames_since_kf = 0
        return kf

    def _create_keyframe(self, frame: Frame):
        kf = self._spawn_keyframe_with_points(frame)
        self.ref_kf = kf
        return kf
