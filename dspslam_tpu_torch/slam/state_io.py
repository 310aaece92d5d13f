"""SLAM map checkpoint / resume.

Port of dspslam_tpu/slam/state_io.py, host numpy. The full map (keyframes
with feature arrays, map points with observation graphs, objects with
codes and meshes) round-trips through one compressed npz with the JAX
package's keys, so a checkpoint written by either package loads in the
other: a mapping session can be suspended, inspected, or continued (e.g.
localization-only runs against a prebuilt map).

The port also saves and restores what the JAX copy drops: each object's
`last_measured_kf_id`, `last_measured_frame_id` (the dynamic-object
prediction horizon runs from it) and `n_shape_refinements` (the
refinement bound counts it), and each keyframe's `frame_id`. A checkpoint
without them (one the JAX package wrote) loads each object as the object
pipeline creates one at its `ref_kf_id`: last measured at that keyframe,
at that keyframe's frame id (-1 when the checkpoint has none), with no
refinement yet.
"""

from __future__ import annotations

import itertools

import numpy as np

from .map import Frame, KeyFrame, Map, MapObject, MapPoint

_FEAT_KEYS = ("xy", "desc", "angle", "level", "sigma2", "response", "valid")


def save_state(slam_map: Map, path: str):
    data = {}
    kf_ids = sorted(k for k, kf in slam_map.keyframes.items() if not kf.bad)
    data["kf_ids"] = np.asarray(kf_ids, np.int64)
    for i, kf_id in enumerate(kf_ids):
        kf = slam_map.keyframes[kf_id]
        data[f"kf{i}_T_cw"] = kf.T_cw
        data[f"kf{i}_mpids"] = kf.map_point_ids
        data[f"kf{i}_ts"] = np.float64(kf.timestamp)
        data[f"kf{i}_frame_id"] = np.int64(kf.frame_id)
        data[f"kf{i}_parent"] = np.int64(kf.parent if kf.parent is not None else -1)
        data[f"kf{i}_covis"] = np.asarray(
            [[k, v] for k, v in kf.covis.items()], np.int64
        ).reshape(-1, 2)
        data[f"kf{i}_loops"] = np.asarray(sorted(kf.loop_edges), np.int64)
        for key in _FEAT_KEYS:
            if key in kf.feats:
                data[f"kf{i}_f_{key}"] = kf.feats[key]
        if kf.depth is not None:
            data[f"kf{i}_depth"] = kf.depth
        if kf.u_right is not None:
            data[f"kf{i}_uright"] = kf.u_right

    pt_ids = sorted(p for p, pt in slam_map.points.items() if not pt.bad)
    data["pt_ids"] = np.asarray(pt_ids, np.int64)
    data["pt_pos"] = np.stack(
        [slam_map.points[p].position for p in pt_ids]
    ) if pt_ids else np.zeros((0, 3), np.float32)
    data["pt_desc"] = np.stack(
        [slam_map.points[p].descriptor for p in pt_ids]
    ) if pt_ids else np.zeros((0, 8), np.uint32)
    data["pt_ref"] = np.asarray(
        [slam_map.points[p].ref_kf_id for p in pt_ids], np.int64
    )
    obs = []
    for pi, p in enumerate(pt_ids):
        for kf_id, kp in slam_map.points[p].observations.items():
            obs.append([pi, kf_id, kp])
    data["pt_obs"] = np.asarray(obs, np.int64).reshape(-1, 3)
    data["pt_obj"] = np.asarray(
        [
            [int(slam_map.points[p].in_any_object), slam_map.points[p].object_id]
            for p in pt_ids
        ],
        np.int64,
    ).reshape(-1, 2)

    obj_ids = sorted(o for o, ob in slam_map.objects.items() if not ob.bad)
    data["obj_ids"] = np.asarray(obj_ids, np.int64)
    for i, o in enumerate(obj_ids):
        obj = slam_map.objects[o]
        data[f"obj{i}_Two"] = obj.T_wo
        data[f"obj{i}_code"] = obj.code
        data[f"obj{i}_ref"] = np.int64(obj.ref_kf_id)
        data[f"obj{i}_dyn"] = np.int64(obj.dynamic)
        data[f"obj{i}_vel"] = obj.velocity
        data[f"obj{i}_obs"] = np.asarray(
            [[k, v] for k, v in obj.observations.items()], np.int64
        ).reshape(-1, 2)
        # -1 stands for None (never measured)
        for key in ("last_measured_kf_id", "last_measured_frame_id"):
            v = getattr(obj, key, None)
            data[f"obj{i}_{key}"] = np.int64(-1 if v is None else v)
        data[f"obj{i}_n_refine"] = np.int64(getattr(obj, "n_shape_refinements", 0))
        if obj.vertices is not None:
            data[f"obj{i}_verts"] = obj.vertices
            data[f"obj{i}_faces"] = obj.faces
    np.savez_compressed(path, **data)


def _optional_id(z, key):
    v = int(z[key])
    return None if v < 0 else v


def load_state(path: str) -> Map:
    z = np.load(path)
    slam_map = Map()

    for i, kf_id in enumerate(z["kf_ids"]):
        feats = {
            key: z[f"kf{i}_f_{key}"] for key in _FEAT_KEYS
            if f"kf{i}_f_{key}" in z
        }
        kf = KeyFrame.__new__(KeyFrame)
        kf.id = int(kf_id)
        kf.frame_id = int(z[f"kf{i}_frame_id"]) if f"kf{i}_frame_id" in z else -1
        kf.seq_idx = -1
        kf.timestamp = float(z[f"kf{i}_ts"])
        kf.feats = feats
        kf.n = len(feats["xy"])
        kf.depth = z[f"kf{i}_depth"] if f"kf{i}_depth" in z else None
        kf.u_right = z[f"kf{i}_uright"] if f"kf{i}_uright" in z else None
        kf.T_cw = z[f"kf{i}_T_cw"]
        kf.map_point_ids = z[f"kf{i}_mpids"]
        kf.covis = {int(k): int(v) for k, v in z[f"kf{i}_covis"]}
        parent = int(z[f"kf{i}_parent"])
        kf.parent = parent if parent >= 0 else None
        kf.children = set()
        kf.loop_edges = set(int(v) for v in z[f"kf{i}_loops"])
        kf.bad = False
        kf.not_erase = False
        kf.to_be_erased = False
        kf.bow = None
        kf.detections = []
        kf.object_associations = {}
        kf.T_cw_before_gba = None
        slam_map.add_keyframe(kf)
    for kf in slam_map.keyframes.values():
        if kf.parent is not None and kf.parent in slam_map.keyframes:
            slam_map.keyframes[kf.parent].children.add(kf.id)

    pt_ids = z["pt_ids"]
    for i, p_id in enumerate(pt_ids):
        p = MapPoint.__new__(MapPoint)
        p.id = int(p_id)
        p.position = z["pt_pos"][i]
        p.descriptor = z["pt_desc"][i]
        p.ref_kf_id = int(z["pt_ref"][i])
        p.level = 0
        p.dist_create = 1.0
        p.observations = {}
        p.normal = np.zeros(3, np.float32)
        p.min_distance, p.max_distance = 0.0, np.inf
        p.n_visible = p.n_found = 1
        p.bad = False
        p.replaced_by = None
        p.in_any_object = bool(z["pt_obj"][i, 0])
        p.object_id = int(z["pt_obj"][i, 1])
        p.keyframe_id_added_to_object = -1
        p.outlier_in_object = False
        slam_map.points[p.id] = p
    for pi, kf_id, kp in z["pt_obs"]:
        p = slam_map.points[int(pt_ids[pi])]
        p.observations[int(kf_id)] = int(kp)

    for i, o_id in enumerate(z["obj_ids"]):
        obj = MapObject.__new__(MapObject)
        obj.id = int(o_id)
        obj.code = z[f"obj{i}_code"]
        obj.ref_kf_id = int(z[f"obj{i}_ref"])
        obj.observations = {int(k): int(v) for k, v in z[f"obj{i}_obs"]}
        obj.bad = False
        obj.dynamic = bool(z[f"obj{i}_dyn"])
        obj.velocity = z[f"obj{i}_vel"]
        obj.vertices = z[f"obj{i}_verts"] if f"obj{i}_verts" in z else None
        obj.faces = z[f"obj{i}_faces"] if f"obj{i}_faces" in z else None
        obj.point_ids = set()
        obj.replaced_by = None
        obj.n_observed = 1
        if f"obj{i}_n_refine" in z:
            obj.last_measured_kf_id = _optional_id(z, f"obj{i}_last_measured_kf_id")
            obj.last_measured_frame_id = _optional_id(z, f"obj{i}_last_measured_frame_id")
            obj.n_shape_refinements = int(z[f"obj{i}_n_refine"])
        else:
            # a checkpoint without them: as created at its reference keyframe
            ref = slam_map.keyframes.get(obj.ref_kf_id)
            obj.last_measured_kf_id = obj.ref_kf_id
            obj.last_measured_frame_id = None if ref is None else ref.frame_id
            obj.n_shape_refinements = 0
        obj.set_pose_sim3(z[f"obj{i}_Two"])
        slam_map.objects[obj.id] = obj
    for p in slam_map.points.values():
        if p.in_any_object and p.object_id in slam_map.objects:
            slam_map.objects[p.object_id].point_ids.add(p.id)

    # fast-forward the class-level id generators past the loaded ids, or a
    # continued session would mint entities starting at 0 that silently
    # overwrite loaded map entries; frame ids too, so that prediction
    # horizons measured from a loaded keyframe's frame id stay positive
    frame_ids = [kf.frame_id for kf in slam_map.keyframes.values()] + [
        o.last_measured_frame_id for o in slam_map.objects.values()
        if o.last_measured_frame_id is not None]
    for cls, ids in (
        (KeyFrame, slam_map.keyframes),
        (MapPoint, slam_map.points),
        (MapObject, slam_map.objects),
        (Frame, frame_ids),
    ):
        current = next(cls._ids)          # peek (consumes one id; harmless)
        floor = max(ids, default=-1) + 1
        cls._ids = itertools.count(max(current, floor))
    return slam_map
