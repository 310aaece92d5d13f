"""Host-side SLAM data model: Map / KeyFrame / MapPoint / MapObject.

Port of dspslam_tpu/slam/map.py. Single-writer re-design of the
reference's mutex-guarded C++ map classes (reference include/
{Map,KeyFrame,MapPoint,MapObject}.h): entities are plain Python objects
and numpy arrays. Device code never touches these; tracking stages pack
the slices they need into fixed-shape tensors.

Frame features may arrive as device tensors from the pipelined tracker
and are materialized to numpy on first host read (`feats`); descriptors
then come back as (N, 8) uint32, the JAX package's type. `feats_torch`
returns device tensors, with descriptors as their int32 bit view.

Object extensions mirror the reference: map points carry object
membership (MapPoint.h:85-88), keyframes carry per-frame detections and
object associations (KeyFrame.h:200-211), and MapObject keeps the dual
Sim(3)/SE(3)+scale pose representation with the scale factored as
det(sR)^(1/3) (MapObject.cc:27-53).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

COVIS_THRESHOLD = 15


def feats_to_numpy(feats: dict) -> dict:
    """Host numpy copy of a feature / result dict of tensors; "desc" int32
    words come back as uint32."""
    out = {}
    for k, v in feats.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
            if k == "desc":
                v = v.view(np.uint32)
        out[k] = v
    return out


def resolve_device(device) -> torch.device:
    """torch.device with the index of the current card filled in, so that
    two names of one device compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def entry_device(device, who: str) -> torch.device:
    """The device of an entry point: None means cuda, and cuda without a
    usable card raises (no quiet run on the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device cuda was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    device = resolve_device(device)
    if device.type == "cuda":
        # geometry runs in full f32 (the JAX package pins "highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def to_torch(a, device) -> torch.Tensor:
    """A host array as a tensor on `device`; uint32 (descriptor words)
    becomes its int32 bit view. To the card it goes through pinned memory
    without waiting for the device's queued work."""
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _feats_torch(entity, device) -> dict:
    """An entity's features as tensors on `device`, reusing the device
    copy it was born with when that lies there (no re-upload)."""
    dev = entity._feats_dev
    if dev is not None and dev["xy"].device == resolve_device(device):
        return dev
    return {k: to_torch(v, device) for k, v in entity.feats.items()}


class Frame:
    """Per-frame container (reference Frame.cc): features + stereo depth +
    pose + per-keypoint map-point association."""

    _feats_dev = None  # class default (instances set it in __init__)

    _ids = itertools.count()

    def __init__(self, timestamp: float, feats: dict, depth=None, u_right=None):
        self.id = next(Frame._ids)
        self.timestamp = timestamp
        # feats may arrive as device tensors from a pipelined tracker and
        # materialize lazily: non-keyframe frames never read them on the
        # host. The device copy is kept after materialization
        # (feats_torch) so keyframe device programs never re-upload it.
        # Contract: the host dict must not be item-mutated after Frame
        # construction (undistortion happens before it; nothing else
        # writes) — use the `feats` setter to swap the whole dict.
        self._feats = feats                    # numpy OR device tensors
        self._feats_on_host = isinstance(feats["xy"], np.ndarray)
        self._feats_dev = None if self._feats_on_host else feats
        self.n = len(feats["xy"])
        self.depth = depth                     # (N,) or None
        self.u_right = u_right                 # (N,) or None
        self.T_cw = np.eye(4, dtype=np.float32)
        self.map_point_ids = np.full(self.n, -1, np.int64)
        self.outlier = np.zeros(self.n, bool)

    @property
    def feats(self) -> dict:
        if not self._feats_on_host:
            self._feats = feats_to_numpy(self._feats)
            self._feats_on_host = True
        return self._feats

    @feats.setter
    def feats(self, value: dict):
        self._feats = value
        self._feats_on_host = isinstance(value["xy"], np.ndarray)
        self._feats_dev = None if self._feats_on_host else value

    def feats_torch(self, device) -> dict:
        """Features as tensors on `device` (the frame's own device copy
        when it was born there)."""
        return _feats_torch(self, device)

    @property
    def T_wc(self):
        R = self.T_cw[:3, :3]
        t = self.T_cw[:3, 3]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        return T

    def camera_center(self):
        return self.T_wc[:3, 3]


class MapPoint:
    _ids = itertools.count()

    def __init__(self, position: np.ndarray, descriptor: np.ndarray,
                 ref_kf_id: int, level: int = 0, dist_create: float = 1.0):
        self.id = next(MapPoint._ids)
        self.position = np.asarray(position, np.float32)
        self.descriptor = np.asarray(descriptor)
        self.ref_kf_id = ref_kf_id
        self.level = int(level)      # pyramid level of the creating keypoint
        # viewing distance at creation: matching predicts the expected
        # octave from the CURRENT distance (ORB scale invariance only
        # spans ~1 level, so the gate must track distance — matching
        # against the creation level alone starves the matcher as the
        # camera approaches/recedes)
        self.dist_create = float(max(dist_create, 1e-3))
        self.observations: dict[int, int] = {}   # kf_id -> keypoint index
        self.normal = np.zeros(3, np.float32)
        self.min_distance = 0.0
        self.max_distance = np.inf
        self.n_visible = 1
        self.n_found = 1
        self.bad = False
        self.replaced_by: Optional[int] = None
        # object extensions (MapPoint.h:85-88)
        self.in_any_object = False
        self.object_id = -1
        self.keyframe_id_added_to_object = -1
        self.outlier_in_object = False

    @property
    def n_obs(self):
        return len(self.observations)

    def found_ratio(self):
        return self.n_found / max(self.n_visible, 1)


class KeyFrame:
    _ids = itertools.count()
    # class-level default: KeyFrames minted via __new__ (state_io load)
    # have no device feature copy
    _feats_dev = None

    def __init__(self, frame: Frame):
        self.id = next(KeyFrame._ids)
        self.frame_id = frame.id
        self.seq_idx = -1        # caller-visible sequence index (set by Tracker)
        self.timestamp = frame.timestamp
        self.feats = frame.feats               # materializes to host
        self._feats_dev = frame._feats_dev     # keep the device copy too
        self.n = frame.n
        self.depth = frame.depth
        self.u_right = frame.u_right
        self.T_cw = frame.T_cw.copy()
        self.map_point_ids = frame.map_point_ids.copy()
        self.covis: dict[int, int] = {}          # kf_id -> shared point count
        self.parent: Optional[int] = None
        self.children: set[int] = set()
        self.loop_edges: set[int] = set()
        self.bad = False
        self.not_erase = False
        self.to_be_erased = False
        self.bow: Optional[dict] = None          # filled by place recognition
        # object extensions (KeyFrame.h:200-211)
        self.detections: list = []               # objects.detections.Detection
        self.object_associations: dict[int, int] = {}  # det idx -> object id
        self.T_cw_before_gba = None

    def feats_torch(self, device) -> dict:
        """Features as tensors on `device` (see Frame.feats_torch)."""
        return _feats_torch(self, device)

    @property
    def T_wc(self):
        R = self.T_cw[:3, :3]
        t = self.T_cw[:3, 3]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
        return T

    def camera_center(self):
        return self.T_wc[:3, 3]

    def covisible_keyframes(self, k: Optional[int] = None) -> list[int]:
        """KF ids ordered by shared-point weight, optionally top-k."""
        ordered = sorted(self.covis.items(), key=lambda kv: -kv[1])
        ids = [kf_id for kf_id, _ in ordered]
        return ids[:k] if k else ids


class MapObject:
    """Object landmark with Sim(3) pose T_wo and a DeepSDF code
    (reference MapObject.cc)."""

    _ids = itertools.count()

    def __init__(self, T_wo_sim3: np.ndarray, code: np.ndarray, ref_kf_id: int):
        self.id = next(MapObject._ids)
        self.code = np.asarray(code, np.float32)
        self.ref_kf_id = ref_kf_id
        self.observations: dict[int, int] = {}   # kf_id -> detection index
        self.bad = False
        self.dynamic = False
        self.velocity = np.zeros(3, np.float32)
        # keyframe id of the last APPLIED pose measurement. Associations
        # with too few surface points to measure still record an entry in
        # `observations` (association.py:73) but leave the pose untouched;
        # consumers that compare the pose against ground truth at an
        # observation time must use this id, not max(observations) — for
        # a dynamic object the mismatch is velocity * keyframe_gap.
        self.last_measured_kf_id: Optional[int] = None
        # frame id of that keyframe: the constant-velocity prediction's
        # horizon starts there (it outlives the keyframe's culling)
        self.last_measured_frame_id: Optional[int] = None
        self.vertices: Optional[np.ndarray] = None
        self.faces: Optional[np.ndarray] = None
        self.point_ids: set[int] = set()
        self.replaced_by: Optional[int] = None
        self.n_observed = 1
        # warm-started joint-GN re-reconstructions applied so far (the
        # reference re-runs reconstruct_object on every new observation,
        # LocalMapping_util.cc:391; the pipeline bounds it — see
        # ObjectPipeline.max_shape_refinements)
        self.n_shape_refinements = 0
        self.set_pose_sim3(T_wo_sim3)

    def set_pose_sim3(self, T_wo: np.ndarray):
        """Store Sim(3) and the SE(3)+scale factoring (MapObject.cc:27-53)."""
        self.T_wo = np.asarray(T_wo, np.float32)
        sR = self.T_wo[:3, :3]
        self.scale = float(np.linalg.det(sR)) ** (1.0 / 3.0)
        self.T_wo_se3 = self.T_wo.copy()
        self.T_wo_se3[:3, :3] = sR / self.scale

    def set_pose_se3(self, T_wo_se3: np.ndarray, scale: Optional[float] = None):
        scale = self.scale if scale is None else scale
        T = np.asarray(T_wo_se3, np.float32).copy()
        T[:3, :3] = T[:3, :3] * scale
        self.set_pose_sim3(T)

    @property
    def T_ow(self):
        sR = self.T_wo[:3, :3]
        s = self.scale
        R = sR / s
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T / s
        T[:3, 3] = -(R.T / s) @ self.T_wo[:3, 3]
        return T


class Map:
    """Global store (reference Map.h) — keyframes, points, objects."""

    def __init__(self):
        self.keyframes: dict[int, KeyFrame] = {}
        self.points: dict[int, MapPoint] = {}
        self.objects: dict[int, MapObject] = {}
        self.n_dynamic_objects = 0
        self.big_change_index = 0
        # callbacks fired on keyframe erase — e.g. KeyFrameDatabase
        # compaction (reference KeyFrameDatabase::erase is called from
        # KeyFrame::SetBadFlag; without it the inverted index grows
        # unboundedly under keyframe culling)
        self.keyframe_erase_hooks: list = []

    # -- keyframes ---------------------------------------------------------
    def add_keyframe(self, kf: KeyFrame):
        self.keyframes[kf.id] = kf

    def erase_keyframe(self, kf_id: int):
        """Remove a keyframe and every covisibility, child and loop-edge
        entry naming it, in every keyframe that lists it (reference
        KeyFrame::SetBadFlag). The JAX package erased it only from the
        keyframes in its own `covis`, and a stale entry elsewhere crashed
        BA dispatch (KeyError: 48, ROADMAP fault R1)."""
        self.keyframes.pop(kf_id, None)
        for other in self.keyframes.values():
            other.covis.pop(kf_id, None)
            other.children.discard(kf_id)
            other.loop_edges.discard(kf_id)
        for hook in self.keyframe_erase_hooks:
            hook(kf_id)

    def check_invariants(self):
        """Raise AssertionError unless the keyframe graph is consistent:
        covisibility is symmetric with equal weights, and no covisibility,
        child, parent or loop-edge entry names an erased keyframe. Loop
        correction and global BA rewrite this graph; the tests call it
        after each."""
        kfs = self.keyframes
        for kf_id, kf in kfs.items():
            for other, w in kf.covis.items():
                assert other in kfs, f"keyframe {kf_id}: covis names erased {other}"
                assert kfs[other].covis.get(kf_id) == w, f"covis {kf_id}-{other} not symmetric"
            for name, ids in (("children", kf.children), ("loop edge", kf.loop_edges)):
                stale = [i for i in ids if i not in kfs]
                assert not stale, f"keyframe {kf_id}: {name} names erased {stale}"
            assert kf.parent is None or kf.parent in kfs, \
                f"keyframe {kf_id}: parent {kf.parent} erased"

    # -- points ------------------------------------------------------------
    def add_point(self, p: MapPoint):
        self.points[p.id] = p

    def erase_point(self, p_id: int):
        p = self.points.pop(p_id, None)
        if p is None:
            return
        p.bad = True
        for kf_id, kp_idx in p.observations.items():
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.map_point_ids[kp_idx] == p_id:
                kf.map_point_ids[kp_idx] = -1

    def add_observation(self, p: MapPoint, kf: KeyFrame, kp_idx: int):
        p.observations[kf.id] = kp_idx
        kf.map_point_ids[kp_idx] = p.id

    def replace_point(self, old: MapPoint, new: MapPoint):
        """Fuse: redirect all observations of `old` to `new` (MapPoint::Replace)."""
        if old.id == new.id:
            return
        for kf_id, kp_idx in list(old.observations.items()):
            kf = self.keyframes.get(kf_id)
            if kf is None:
                continue
            if kf_id not in new.observations:
                new.observations[kf_id] = kp_idx
                kf.map_point_ids[kp_idx] = new.id
            else:
                kf.map_point_ids[kp_idx] = -1
        new.n_visible += old.n_visible
        new.n_found += old.n_found
        old.bad = True
        old.replaced_by = new.id
        self.points.pop(old.id, None)

    # -- objects -----------------------------------------------------------
    def add_object(self, obj: MapObject):
        self.objects[obj.id] = obj

    def erase_object(self, obj_id: int):
        obj = self.objects.pop(obj_id, None)
        if obj is not None:
            obj.bad = True

    def replace_object(self, old: MapObject, new: MapObject):
        """Loop-closure fusion (MapObject::Replace, MapObject.cc:154-192)."""
        if old.id == new.id:
            return
        for kf_id, det_idx in old.observations.items():
            if kf_id not in new.observations:
                new.observations[kf_id] = det_idx
                kf = self.keyframes.get(kf_id)
                if kf is not None:
                    kf.object_associations[det_idx] = new.id
        for p_id in old.point_ids:
            p = self.points.get(p_id)
            if p is not None and p.object_id == old.id:
                p.object_id = new.id
                new.point_ids.add(p_id)
        old.bad = True
        old.replaced_by = new.id
        self.objects.pop(old.id, None)

    # -- covisibility ------------------------------------------------------
    def update_covisibility(self, kf: KeyFrame):
        """Recount shared map points (KeyFrame::UpdateConnections). Only
        keyframes still in the map count, and the relation stays symmetric:
        a keyframe that drops out of kf's list loses kf from its own."""
        counts: dict[int, int] = {}
        for p_id in kf.map_point_ids:
            if p_id < 0:
                continue
            p = self.points.get(p_id)
            if p is None or p.bad:
                continue
            for other_id in p.observations:
                if other_id != kf.id and other_id in self.keyframes:
                    counts[other_id] = counts.get(other_id, 0) + 1
        kept = {k: v for k, v in counts.items() if v >= COVIS_THRESHOLD}
        if not kept and counts:
            best = max(counts, key=counts.get)
            kept = {best: counts[best]}
        for other_id in kf.covis.keys() - kept.keys():
            other = self.keyframes.get(other_id)
            if other is not None:
                other.covis.pop(kf.id, None)
        kf.covis = kept
        for other_id, w in kept.items():
            self.keyframes[other_id].covis[kf.id] = w
        # spanning tree: attach to the strongest covisible parent
        if kf.parent is None and kept:
            parent_id = max(kept, key=kept.get)
            if parent_id != kf.id:
                kf.parent = parent_id
                parent = self.keyframes.get(parent_id)
                if parent is not None:
                    parent.children.add(kf.id)

    def local_keyframes(self, kf: KeyFrame, k: int = 20) -> list[int]:
        """kf + its top-k covisible neighbours (local BA window), only ids
        still in the map."""
        ids = [kf.id] + kf.covisible_keyframes(k)
        return [i for i in dict.fromkeys(ids) if i in self.keyframes]

    def points_seen_by(self, kf_ids: list[int]) -> list[int]:
        seen = {}
        for kf_id in kf_ids:
            kf = self.keyframes.get(kf_id)
            if kf is None:
                continue
            for p_id in kf.map_point_ids:
                if p_id >= 0 and p_id in self.points:
                    seen[p_id] = True
        return list(seen)
