"""Dataset and artifact IO: KITTI calibration, velodyne scans, PLY meshes.

Covers the reference's host IO (utils.py:58-79 calib/velodyne,
utils.py:143-163 PLY export, kitti_sequence.py:240-254 projection
plumbing) without plyfile/OpenCV dependencies: the binary little-endian
PLY writer is self-contained.
"""

from __future__ import annotations

import numpy as np


def read_kitti_calib(path: str) -> dict:
    """Parse a KITTI calib.txt into {key: float array}."""
    data = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            try:
                data[key.strip()] = np.array([float(v) for v in value.split()])
            except ValueError:
                pass
    return data


def kitti_cam2_calibration(calib: dict):
    """(K_cam2 (3,3), T_cam2_velo (4,4)) from a KITTI odometry calib dict.

    cam2's x-offset relative to cam0 is P2[0,3]/fx; the velodyne extrinsic
    chains T_cam2_cam0 @ T_cam0_velo (reference kitti_sequence.py:240-254).
    """
    P2 = calib["P2"].reshape(3, 4)
    K = P2[:3, :3].astype(np.float32)
    T_cam0_velo = np.eye(4)
    T_cam0_velo[:3, :] = calib["Tr"].reshape(3, 4)
    T_cam2_cam0 = np.eye(4)
    T_cam2_cam0[0, 3] = P2[0, 3] / P2[0, 0]
    return K, (T_cam2_cam0 @ T_cam0_velo).astype(np.float32)


def load_velodyne(path: str) -> np.ndarray:
    """(N, 4) float32 [x, y, z, reflectance]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def write_mesh_ply(vertices: np.ndarray, faces: np.ndarray, path: str):
    """Binary little-endian PLY triangle mesh writer (no plyfile dep)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        face_rec = np.empty(
            len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))]
        )
        face_rec["n"] = 3
        face_rec["idx"] = faces
        f.write(face_rec.tobytes())


def read_mesh_ply(path: str):
    """Read back meshes written by `write_mesh_ply` (tests/round-trips)."""
    with open(path, "rb") as f:
        n_verts = n_faces = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
            elif line.startswith("element face"):
                n_faces = int(line.split()[-1])
            elif line == "end_header":
                break
        verts = np.frombuffer(f.read(n_verts * 12), dtype="<f4").reshape(-1, 3)
        face_rec = np.frombuffer(
            f.read(n_faces * 13), dtype=[("n", "u1"), ("idx", "<i4", (3,))]
        )
        return verts.copy(), face_rec["idx"].copy()


def load_image_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))
