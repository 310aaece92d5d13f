"""Joint map visualization (the reference's visualize_map.py), headless,
with a live follow mode over per-frame map dumps.

Port of dspslam_tpu/apps/visualize_map.py (host code). Static mode loads a
saved map directory (MapPoints.txt, Cameras.txt, extracted meshes), trims
points by distance percentile (visualize_map.py:46-97's outlier trim), and
writes (a) a combined world-frame PLY with every object mesh placed by its
Sim(3) pose and (b) a top-down PNG (when matplotlib is installed).

Follow mode (`--follow`) watches a directory of frame-numbered
subdirectories as written by `SLAMSystem.save_map_current_frame`
(System_util.cc:23-107's per-frame dumps) and animates the growing map:
interactively with a display (the replay counterpart of the reference's
Pangolin Viewer / MapDrawer, Viewer.cc:59-176), or as a PNG series.

    python -m dspslam_tpu_torch.apps.visualize_map --map_dir out/map
    python -m dspslam_tpu_torch.apps.visualize_map --follow out/frames/ --output out/png [--once]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..utils import io as io_mod
from .extract_map_objects import load_map_objects


def _load_snapshot(map_dir: str, percentile: float = 98.0):
    """(points (N,3), cams (M,3,4), object world-frame vertex arrays)."""
    pts_path = os.path.join(map_dir, "MapPoints.txt")
    pts = (
        np.loadtxt(pts_path).reshape(-1, 3)
        if os.path.exists(pts_path) and os.path.getsize(pts_path)
        else np.zeros((0, 3))
    )
    if len(pts):
        center = np.median(pts, axis=0)
        d = np.linalg.norm(pts - center, axis=-1)
        pts = pts[d <= np.percentile(d, percentile)]
    cams = np.zeros((0, 3, 4))
    cams_path = os.path.join(map_dir, "Cameras.txt")
    if os.path.exists(cams_path) and os.path.getsize(cams_path):
        cams = np.loadtxt(cams_path).reshape(-1, 3, 4)
    all_v = []
    mesh_dir = os.path.join(map_dir, "meshes")
    obj_path = os.path.join(map_dir, "MapObjects.txt")
    if os.path.isdir(mesh_dir) and os.path.exists(obj_path):
        for obj_id, Two, _code in load_map_objects(obj_path):
            ply = os.path.join(mesh_dir, f"{obj_id}.ply")
            if not os.path.exists(ply):
                continue
            v, _f = io_mod.read_mesh_ply(ply)
            all_v.append(v @ Two[:3, :3].T + Two[:3, 3])
    return pts, cams, all_v


def _draw_topdown(ax, pts, cams, obj_verts, title=""):
    ax.clear()
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="gray", alpha=0.4)
    for v in obj_verts:
        ax.scatter(v[::7, 0], v[::7, 2], s=2, c="red", alpha=0.6)
    if len(cams):
        ax.plot(cams[:, 0, 3], cams[:, 2, 3], "b-", linewidth=1)
        ax.plot(cams[-1, 0, 3], cams[-1, 2, 3], "bo", markersize=4)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)


def follow(
    frames_dir: str,
    interval: float = 0.5,
    out_dir: str | None = None,
    idle_timeout: float = 15.0,
    once: bool = False,
    percentile: float = 98.0,
):
    """Animate a growing map from frame-numbered dump directories.

    Renders every NEW subdirectory (named as digits, e.g. 000042/) as a
    top-down frame. Interactive when a GUI backend is available;
    otherwise writes <out_dir>/<frame>.png. Stops after `idle_timeout`
    seconds without new frames (or after one scan with `once`).
    Returns the number of frames rendered.
    """
    import matplotlib

    interactive = bool(os.environ.get("DISPLAY")) and not out_dir
    if not interactive:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 8))
    if interactive:
        plt.ion()
        plt.show()
    seen: set[str] = set()
    rendered = 0
    last_new = time.monotonic()
    while True:
        names = sorted(
            d for d in os.listdir(frames_dir)
            if d.isdigit() and os.path.isdir(os.path.join(frames_dir, d))
        )
        for name in names:
            if name in seen:
                continue
            seen.add(name)
            last_new = time.monotonic()
            pts, cams, objs = _load_snapshot(
                os.path.join(frames_dir, name), percentile
            )
            _draw_topdown(ax, pts, cams, objs, title=f"frame {name}")
            if interactive:
                fig.canvas.draw_idle()
                plt.pause(0.001)
            if out_dir:
                fig.savefig(
                    os.path.join(out_dir, f"{name}.png"),
                    dpi=100, bbox_inches="tight",
                )
            rendered += 1
        if once or (time.monotonic() - last_new) > idle_timeout:
            break
        if interactive:
            plt.pause(interval)
        else:
            time.sleep(interval)
    plt.close(fig)
    return rendered


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--map_dir")
    p.add_argument("--follow", metavar="FRAMES_DIR",
                   help="watch per-frame dump dirs and animate the map")
    p.add_argument("--percentile", type=float, default=98.0)
    p.add_argument("--output", default=None)
    p.add_argument("--interval", type=float, default=0.5)
    p.add_argument("--idle_timeout", type=float, default=15.0)
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)

    if args.follow:
        n = follow(
            args.follow, interval=args.interval, out_dir=args.output,
            idle_timeout=args.idle_timeout, once=args.once,
            percentile=args.percentile,
        )
        print(f"rendered {n} frames")
        return n
    if not args.map_dir:
        p.error("--map_dir or --follow required")

    pts, cams, all_v = _load_snapshot(args.map_dir, args.percentile)
    # meshes again, with faces, for the combined PLY
    mesh_dir = os.path.join(args.map_dir, "meshes")
    obj_path = os.path.join(args.map_dir, "MapObjects.txt")
    all_f, offset = [], 0
    if os.path.isdir(mesh_dir) and os.path.exists(obj_path):
        for obj_id, Two, _code in load_map_objects(obj_path):
            ply = os.path.join(mesh_dir, f"{obj_id}.ply")
            if not os.path.exists(ply):
                continue
            _v, f = io_mod.read_mesh_ply(ply)
            all_f.append(f + offset)
            offset += len(_v)

    out = args.output or os.path.join(args.map_dir, "joint_map.ply")
    verts = np.concatenate([pts.astype(np.float32)] + all_v) if (len(pts) or all_v) \
        else np.zeros((0, 3), np.float32)
    faces = np.zeros((0, 3), np.int32)
    if all_f:
        faces = np.concatenate(all_f) + len(pts)
    io_mod.write_mesh_ply(verts, faces, out)
    print(f"wrote {out}: {len(verts)} vertices, {len(faces)} faces")

    png = os.path.splitext(out)[0] + ".png"
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 8))
        _draw_topdown(ax, pts, cams, all_v)
        fig.savefig(png, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {png}")
    except ImportError as e:  # matplotlib is optional
        print(f"snapshot skipped: {e}")


if __name__ == "__main__":
    main()
