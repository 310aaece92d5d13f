"""Headless software renderer for object meshes and map snapshots.

Port of dspslam_tpu/viz/renderer.py (host numpy). A functional replacement
for the reference's OpenGL stack (ObjectRenderer, Renderer.hpp's pinhole
shaders, the Pangolin viewer): a z-buffered barycentric rasterizer giving
per-pixel depth, instance-id masks and flat-shaded intensity (the outputs of
the reference's mask-id fragment shader), and a top-down map snapshot
writer. No GL context is needed; matplotlib is imported only inside
`save_map_snapshot`.
"""

from __future__ import annotations

import numpy as np


def rasterize_mesh(
    vertices: np.ndarray,     # (V, 3) object/world frame
    faces: np.ndarray,        # (F, 3)
    K: np.ndarray,            # (3, 3)
    T_cam: np.ndarray,        # (4, 4) frame -> camera
    image_hw: tuple[int, int],
    instance_id: int = 1,
    depth: np.ndarray | None = None,
    id_map: np.ndarray | None = None,
    shade: np.ndarray | None = None,
    light_dir=(0.3, -0.5, -0.8),
):
    """Render one mesh into (depth, id_map, shade) buffers; returns them.

    Pass existing buffers to composite multiple objects (nearest wins).
    """
    h, w = image_hw
    if depth is None:
        depth = np.full((h, w), np.inf, np.float32)
    if id_map is None:
        id_map = np.zeros((h, w), np.int32)
    if shade is None:
        shade = np.zeros((h, w), np.float32)
    if len(vertices) == 0 or len(faces) == 0:
        return depth, id_map, shade

    vc = vertices @ T_cam[:3, :3].T + T_cam[:3, 3]
    z = vc[:, 2]
    uvh = vc @ K.T
    uv = uvh[:, :2] / np.maximum(uvh[:, 2:3], 1e-9)

    light = np.asarray(light_dir)
    light = light / np.linalg.norm(light)

    tri_uv = uv[faces]                    # (F, 3, 2)
    tri_z = z[faces]                      # (F, 3)
    tri_vc = vc[faces]
    normals = np.cross(
        tri_vc[:, 1] - tri_vc[:, 0], tri_vc[:, 2] - tri_vc[:, 0]
    )
    nn = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(nn, 1e-12)
    intensity = np.clip(-(normals @ light), 0.15, 1.0)

    front = (tri_z > 0.05).all(axis=-1)
    for f in np.nonzero(front)[0]:
        p = tri_uv[f]
        x0 = max(int(np.floor(p[:, 0].min())), 0)
        x1 = min(int(np.ceil(p[:, 0].max())) + 1, w)
        y0 = max(int(np.floor(p[:, 1].min())), 0)
        y1 = min(int(np.ceil(p[:, 1].max())) + 1, h)
        if x0 >= x1 or y0 >= y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        # barycentric coordinates
        v0 = p[1] - p[0]
        v1 = p[2] - p[0]
        den = v0[0] * v1[1] - v1[0] * v0[1]
        if abs(den) < 1e-9:
            continue
        px = xs + 0.5 - p[0, 0]
        py = ys + 0.5 - p[0, 1]
        b1 = (px * v1[1] - py * v1[0]) / den
        b2 = (py * v0[0] - px * v0[1]) / den
        b0 = 1.0 - b1 - b2
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth via 1/z interpolation
        inv_z = b0 / tri_z[f, 0] + b1 / tri_z[f, 1] + b2 / tri_z[f, 2]
        zi = 1.0 / np.maximum(inv_z, 1e-9)
        patch_d = depth[y0:y1, x0:x1]
        closer = inside & (zi < patch_d)
        patch_d[closer] = zi[closer]
        id_map[y0:y1, x0:x1][closer] = instance_id
        shade[y0:y1, x0:x1][closer] = intensity[f]
    return depth, id_map, shade


def render_map_objects(slam_map, K, T_cw, image_hw):
    """Composite all map objects into one (depth, id_map, shade) render —
    the ObjectDrawer/ObjectRenderer loop (ObjectDrawer.cc:64-89)."""
    depth = id_map = shade = None
    for obj in slam_map.objects.values():
        if obj.bad or obj.vertices is None:
            continue
        T_co = T_cw @ obj.T_wo       # Sim(3): scales vertices into world
        depth, id_map, shade = rasterize_mesh(
            obj.vertices, obj.faces, K, T_co, image_hw, obj.id + 1,
            depth, id_map, shade,
        )
    if depth is None:
        h, w = image_hw
        depth = np.full((h, w), np.inf, np.float32)
        id_map = np.zeros((h, w), np.int32)
        shade = np.zeros((h, w), np.float32)
    return depth, id_map, shade


def save_map_snapshot(slam_map, path: str, elev_deg: float = 40.0,
                      frustum_scale: float = 0.4,
                      draw_covisibility: bool = True,
                      min_covis_weight: int = 30):
    """Top-down scatter of map points + keyframe frusta + covisibility
    graph + spanning tree + object markers -> PNG (headless stand-in for
    the Pangolin 3D view; frusta/graph/tree match MapDrawer::
    DrawKeyFrames / DrawCurrentCamera, src/MapDrawer.cc)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    if slam_map.points:
        pos = np.stack([p.position for p in slam_map.points.values()])
        ax.scatter(pos[:, 0], pos[:, 2], s=1, c="gray", alpha=0.4)
    centers = {}
    for kf in slam_map.keyframes.values():
        if kf.bad:
            continue
        c = kf.camera_center()
        centers[kf.id] = c
        # wire frustum in the x-z plane: apex + two image-edge rays
        R_wc = kf.T_cw[:3, :3].T
        s = frustum_scale
        for dx in (-0.5, 0.5):
            corner = c + R_wc @ (s * np.array([dx, 0.0, 1.0]))
            ax.plot([c[0], corner[0]], [c[2], corner[2]],
                    "b-", linewidth=0.6, alpha=0.8)
        l = c + R_wc @ (s * np.array([-0.5, 0.0, 1.0]))
        r = c + R_wc @ (s * np.array([0.5, 0.0, 1.0]))
        ax.plot([l[0], r[0]], [l[2], r[2]], "b-", linewidth=0.6, alpha=0.8)
    if draw_covisibility:
        drawn = set()
        for kf in slam_map.keyframes.values():
            if kf.bad or kf.id not in centers:
                continue
            a = centers[kf.id]
            # covisibility graph (strong edges)
            for other_id, w in kf.covis.items():
                if w < min_covis_weight or other_id not in centers:
                    continue
                key = (min(kf.id, other_id), max(kf.id, other_id))
                if key in drawn:
                    continue
                drawn.add(key)
                b = centers[other_id]
                ax.plot([a[0], b[0]], [a[2], b[2]],
                        "g-", linewidth=0.4, alpha=0.5)
            # spanning tree + loop edges (MapDrawer draws both)
            if kf.parent is not None and kf.parent in centers:
                b = centers[kf.parent]
                ax.plot([a[0], b[0]], [a[2], b[2]],
                        "c-", linewidth=0.7, alpha=0.8)
            for loop_id in kf.loop_edges:
                if loop_id in centers and kf.id < loop_id:
                    b = centers[loop_id]
                    ax.plot([a[0], b[0]], [a[2], b[2]],
                            "m-", linewidth=1.0, alpha=0.9)
    for obj in slam_map.objects.values():
        if obj.bad:
            continue
        t = obj.T_wo[:3, 3]
        ax.plot(t[0], t[2], "ro", markersize=8)
        ax.annotate(str(obj.id), (t[0], t[2]))
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
