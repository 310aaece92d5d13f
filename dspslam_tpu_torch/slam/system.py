"""System facade: tracker + local mapper + object pipeline + savers.

Port of dspslam_tpu/slam/system.py (the reference's System class,
System.cc) for stereo, monocular and RGB-D input: one host loop drives the
stages per frame. The savers write the reference's three text formats
(System_util.cc:108-149): MapPoints.txt (xyz per line), MapObjects.txt
(id / 3x4 Sim(3) T_wo row / code row), Cameras.txt (KITTI 3x4 T_wc rows,
lost frames skipped), and TUM trajectories.

`SLAMSystem(..., device=None)` runs on the card and raises without one
(pass device="cpu" to run on the CPU); on the card it turns TF32 off in
cuBLAS and cuDNN itself. `attach_vocabulary` adds the keyframe database
and relocalization after tracking loss (every modality);
`enable_loop_closing` adds the loop closer, which shares that database.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..frontend import orb
from ..utils import timing
from .local_mapping import LocalMapper, LocalMapperConfig
from .map import Map, entry_device
from .tracking import Tracker, TrackerConfig


class SLAMSystem:
    def __init__(self, tracker_cfg: TrackerConfig | None = None, orb_params: orb.ORBParams | None = None,
                 object_pipeline_factory=None, detection_source=None,
                 local_mapper_cfg: LocalMapperConfig | None = None, device=None):
        self.device = entry_device(device, "SLAMSystem")
        self.map = Map()
        self.tracker_cfg = tracker_cfg or TrackerConfig()
        self.tracker = Tracker(self.tracker_cfg, self.map, orb_params or orb.ORBParams(),
                               device=self.device)
        c = self.tracker_cfg
        lm_cfg = local_mapper_cfg or LocalMapperConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf)
        object_pipeline = object_pipeline_factory(self.map) if object_pipeline_factory else None
        self.local_mapper = LocalMapper(self.map, lm_cfg, object_pipeline, device=self.device)
        # NeedNewKeyFrame's AcceptKeyFrames() gate (Tracking.cc): weak-
        # tracking keyframe insertion waits for pending triangulation
        self.tracker.mapper_idle_fn = self.local_mapper.accepting_keyframes
        self.detection_source = detection_source   # fn(frame_idx) -> list[Detection]
        self.loop_closer = None
        self.vocabulary = None
        self.kf_db = None
        self.frame_idx = 0
        self._last_map_state = None

    def attach_telemetry(self, timer):
        """Per-stage wall-clock attribution (dsp_slam.cc:76-115) through
        the process-wide hook (`utils.timing.attach`): each track call
        splits into `track`, `keyframe_drain` and `background_poll`, and
        the tracker, the local mapper, BA, the object GN and the kernels'
        launchers add their spans and counters to the same sink. Returns
        the sink attached before."""
        return timing.attach(timer)

    def attach_vocabulary(self, vocabulary):
        """Always-on KeyFrameDatabase + Relocalizer (System.cc:76-87,
        Tracking.cc:1374): relocalization works in every modality; loop
        closing stays opt-in (enable_loop_closing). Every new keyframe's BoW
        vector enters the database, and culled keyframes leave it
        (KeyFrameDatabase::erase)."""
        from ..place.vocabulary import KeyFrameDatabase
        from .relocalization import Relocalizer

        if self.vocabulary is vocabulary and self.kf_db is not None:
            return
        self.vocabulary = vocabulary
        self.kf_db = KeyFrameDatabase(vocabulary)
        self.map.keyframe_erase_hooks.append(self.kf_db.erase)
        c = self.tracker_cfg
        self.tracker.relocalizer = Relocalizer(self.map, vocabulary, self.kf_db,
                                               [c.fx, c.fy, c.cx, c.cy, c.bf], device=self.device)

    def enable_loop_closing(self, vocabulary, fix_scale: bool = True):
        """Attach a loop closer (stereo default: fixed scale; the reference
        runs LoopClosing for stereo, System.cc:124-132). It shares the
        keyframe database with the relocalizer."""
        from ..place.loop_closing import LoopCloser

        self.attach_vocabulary(vocabulary)
        c = self.tracker_cfg
        self.loop_closer = LoopCloser(self.map, vocabulary, [c.fx, c.fy, c.cx, c.cy, c.bf],
                                      fix_scale=fix_scale, db=self.kf_db, device=self.device)

    # ------------------------------------------------------------------
    def track_stereo(self, img_l, img_r, timestamp: float):
        return self._track_common(lambda: self.tracker.process_stereo(img_l, img_r, timestamp))

    def track_mono(self, img, timestamp: float):
        return self._track_common(lambda: self.tracker.process_mono(img, timestamp))

    def track_rgbd(self, img, depth, timestamp: float):
        return self._track_common(lambda: self.tracker.process_rgbd(img, depth, timestamp))

    def _track_common(self, track_fn):
        tel = timing.sink()
        if tel is None:
            frame = track_fn()
            self._drain_keyframes()
            self._poll_background()
        else:
            t0 = time.perf_counter()
            frame = track_fn()
            t1 = time.perf_counter()
            tel.add("track", t1 - t0)
            self._drain_keyframes()
            t2 = time.perf_counter()
            if t2 - t1 > 1e-4:          # only frames that did keyframe work
                tel.add("keyframe_drain", t2 - t1)
            self._poll_background()
            t3 = time.perf_counter()
            if t3 - t2 > 1e-4:
                tel.add("background_poll", t3 - t2)
        self.frame_idx += 1
        return frame

    def _poll_background(self):
        """One deferred-stage step per frame: the local mapper's pending BA
        and the loop closer's backgrounded global BA."""
        self.local_mapper.poll()
        if self.loop_closer is not None:
            self.loop_closer.poll()

    def flush(self):
        """Drain the pipelined in-flight frame, every pending mapping stage
        and the backgrounded global BA (sequence end)."""
        frame = self.tracker.flush()
        if frame is not None:
            self._drain_keyframes()
        self.local_mapper.flush()
        if self.loop_closer is not None:
            self.loop_closer.flush()
        return frame

    def activate_localization_mode(self):
        """Tracking only: no keyframes against the frozen map
        (System::ActivateLocalizationMode)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def _drain_keyframes(self):
        while self.tracker.new_keyframes:
            kf = self.tracker.new_keyframes.pop(0)
            if self.loop_closer is not None:
                # a backgrounded global BA lands before new mapping work
                # packs the poses it will overwrite
                self.loop_closer.flush()
            if self.detection_source is not None:
                # kf.seq_idx: the track call that produced this keyframe (in
                # pipelined mode keyframes surface one call later)
                idx = kf.seq_idx if kf.seq_idx >= 0 else self.frame_idx
                kf.detections = self.detection_source(idx) or []
            if self.kf_db is not None and self.loop_closer is None:
                # no loop closer to do it: index the keyframe for
                # relocalization (Tracking.cc ComputeBoW + KFDB add)
                kf.bow = self.vocabulary.bow_vector(kf.feats_torch(self.device)["desc"],
                                                    kf.feats["valid"])
                self.kf_db.add(kf.id, kf.bow)
            self.local_mapper.process(kf)
            if self.loop_closer is not None and self.loop_closer.insert_keyframe(kf):
                # the loop correction rewrote the poses the pending local BA
                # was computed from (reference mbAbortBA)
                self.local_mapper.drop_pending_ba()
        # keyframe culling may have erased the tracker's reference
        ref = self.tracker.ref_kf
        if ref is not None and (ref.bad or ref.id not in self.map.keyframes):
            good = [k for k in sorted(self.map.keyframes) if not self.map.keyframes[k].bad]
            self.tracker.ref_kf = self.map.keyframes[good[-1]] if good else None

    # ------------------------------------------------------------------
    @property
    def state(self):
        return self.tracker.state

    def keyframe_poses(self):
        return {kf_id: kf.T_cw.copy() for kf_id, kf in sorted(self.map.keyframes.items())}

    # ------------------------------------------------------------------
    # savers (System_util.cc:108-149 formats)
    def save_map(self, out_dir: str):
        self.local_mapper.flush()      # the saved map includes the last BA solve
        if self.loop_closer is not None:
            self.loop_closer.flush()
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "MapPoints.txt"), "w") as f:
            for p in self.map.points.values():
                if not p.bad:
                    f.write(f"{p.position[0]:.9f} {p.position[1]:.9f} {p.position[2]:.9f}\n")
        with open(os.path.join(out_dir, "MapObjects.txt"), "w") as f:
            for obj_id in sorted(self.map.objects):
                obj = self.map.objects[obj_id]
                if obj.bad or obj.dynamic:
                    continue
                f.write(f"{obj.id}\n")
                f.write(" ".join(f"{obj.T_wo[i, j]:.9f}" for i in range(3) for j in range(4)) + "\n")
                f.write(" ".join(f"{c:.9f}" for c in obj.code) + "\n")
        self.save_trajectory_kitti(os.path.join(out_dir, "Cameras.txt"))

    def save_map_current_frame(self, out_dir: str, frame_idx: int):
        """Per-frame map dump (System::SaveMapCurrentFrame): the same three
        files in a frame-numbered subdirectory."""
        self.save_map(os.path.join(out_dir, f"{frame_idx:06d}"))

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 3x4 T_wc per tracked frame, lost frames skipped."""
        with open(path, "w") as f:
            for _, T_cw, lost in self.tracker.trajectory:
                if lost:
                    continue
                Rwc = T_cw[:3, :3].T
                vals = np.concatenate([Rwc, (-Rwc @ T_cw[:3, 3])[:, None]], axis=1).reshape(-1)
                f.write(" ".join(f"{v:.9f}" for v in vals) + "\n")

    def reset(self):
        """Full reset (System::Reset): wipe the map, drop deferred work."""
        self.local_mapper.drop_pending_ba()
        self.tracker.reset()
        if self.loop_closer is not None:
            self.loop_closer.flush()
        self.frame_idx = 0

    def shutdown(self):
        """System::Shutdown: drain all stages; the savers stay callable."""
        self.flush()

    def map_changed(self) -> bool:
        """System::MapChanged: True once after big map updates (loop closure,
        global BA, reset), seen through the map's cardinality and the
        loop-closure count."""
        state = (len(self.map.keyframes), len(self.map.points),
                 self.loop_closer.loops_closed if self.loop_closer else 0)
        changed = state != self._last_map_state
        self._last_map_state = state
        return changed

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM format over keyframe poses (System::SaveKeyFrameTrajectoryTUM)."""
        rows = [(kf.timestamp, kf.T_cw) for _, kf in sorted(self.map.keyframes.items()) if not kf.bad]
        self._write_tum(path, rows)

    def save_trajectory_tum(self, path: str):
        """TUM format: timestamp tx ty tz qx qy qz qw (System.cc:374-420)."""
        self._write_tum(path, [(ts, T_cw) for ts, T_cw, lost in self.tracker.trajectory if not lost])

    @staticmethod
    def _write_tum(path: str, rows):
        from scipy.spatial.transform import Rotation

        with open(path, "w") as f:
            for ts, T_cw in rows:
                R = T_cw[:3, :3].T
                t = -R @ T_cw[:3, 3]
                q = Rotation.from_matrix(R).as_quat()  # x, y, z, w
                f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")
