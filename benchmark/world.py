"""The benchmark's synthetic layered worlds and trajectories.

A frozen copy of dspslam_tpu_torch/datasets/synthetic.py at commit d92c068
(host numpy; the pure-x dolly renderer, `depth_map_pose`,
`kitti_turn_sequence`, `render_stereo_u8` and `blob_images` left out). The benchmark renders its own frames with it, so a later change
to the port's copy cannot change the traffic.

A `LayeredWorld` is a textured ground plane plus a stack of
fronto-parallel textured planes at different depths, rendered under
pure-x camera translation by per-layer parallax shift (planes shift by
fx * cam_x / z; ground rows shift by cam_x * (v - cy) / h). Layers are
composited per pixel by depth, so occlusion is geometrically
consistent. The same render with `baseline` added to cam_x is the
right-eye view — pixel-exact stereo at negligible cost.

Design notes (born out of tracking-stability forensics):
  * Fronto-parallel planes alone are degenerate for SLAM: camera y/z
    are only constrained by NEAR structure, and without it the pose
    estimate random-walks under the constant-velocity model until the
    chi2 gates starve tracking (error roughly doubles per frame once
    the motion model extrapolates an uncorrected component). Real
    street scenes anchor y/z with the ground plane — so this world has
    one too.
  * Texture must be locally UNIQUE: repeated identical squares alias
    under BRIEF descriptors and mint wrong matches. Blobs here get
    per-blob random intensity on a noise base, so every corner
    neighbourhood is distinct.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np


class LayeredWorld:
    """Ground plane + multi-depth planes, rendered by parallax shift.

    Args:
      width/height: rendered image size (px).
      fx: focal length (px); cx, cy: principal point (defaults center).
      depths: plane depths, far to near (m). The farthest plane is
        fully opaque; nearer planes are sparse patch layers.
      coverage: fraction of each nearer layer covered by patches.
      ground_height: camera height above the ground plane (m); set to
        None to disable the ground.
      max_ground_depth: ground rendered for rows with depth below this.
      x_range: camera x travel (m) the canvases must support.
      seed: texture RNG seed.
    """

    def __init__(
        self,
        width: int,
        height: int,
        fx: float,
        cx: float | None = None,
        cy: float | None = None,
        depths: tuple = (25.0, 12.0, 7.0),
        coverage: tuple = (1.0, 0.30, 0.18),
        ground_height: float | None = 1.5,
        max_ground_depth: float = 30.0,
        x_range: tuple = (-1.0, 12.0),
        seed: int = 0,
        yaw_max: float = 0.0,
        z_range: tuple = (0.0, 0.0),
    ):
        """yaw_max (radians) and z_range (camera z travel, meters) widen
        the canvases so `render_pose` can view the planes from a yawed /
        forward-translated camera without falling off the texture. Both
        default to 0 (the classic pure-x dolly world, zero overhead)."""
        self.width, self.height, self.fx = width, height, fx
        self.cx = width / 2.0 if cx is None else cx
        self.cy = height / 2.0 if cy is None else cy
        self.depths = tuple(depths)
        self.ground_height = ground_height
        self.yaw_max = float(yaw_max)
        self.z_range = tuple(z_range)
        rng = np.random.default_rng(seed)

        # half-FoV of the pinhole; a camera yawed by yaw_max sees out to
        # tan(yaw_max + hfov) laterally (per unit depth)
        hfov_l = np.arctan2(self.cx, fx)
        hfov_r = np.arctan2(width - self.cx, fx)
        # extra lateral world extent (px at the layer) a yawed camera
        # needs beyond the straight-ahead frustum, per side
        def _yaw_pad(hfov):
            if yaw_max <= 0.0:
                return 0
            ang = min(yaw_max + hfov, np.radians(82.0))
            return int(np.ceil(fx * (np.tan(ang) - np.tan(hfov)))) + 4

        pad_l, pad_r = _yaw_pad(hfov_l), _yaw_pad(hfov_r)

        self.layers = []           # (z, shift_min, texture)
        for z, cover in zip(depths, coverage):
            shift_min = int(np.floor(fx * x_range[0] / z)) - 4 - pad_l
            shift_max = int(np.ceil(fx * x_range[1] / z)) + 4 + pad_r
            canvas_w = width + (shift_max - shift_min)
            if cover >= 1.0:
                tex = self._texture(rng, height, canvas_w)
            else:
                tex = np.full((height, canvas_w), np.nan, np.float32)
                # grid placement guarantees coverage everywhere along x
                pitch = max(24, int(56 / max(cover, 1e-3) * 0.35))
                for gx in range(4, canvas_w - 60, pitch):
                    for _ in range(2):
                        s = int(rng.integers(22, 46))
                        y0 = int(rng.integers(4, max(5, height - s - 4)))
                        tex[y0 : y0 + s, gx : gx + s] = self._texture(
                            rng, s, s
                        )
            self.layers.append((float(z), shift_min, tex))

        if ground_height is not None:
            # ground occupies rows v with depth fx*h/(v-cy) <= max depth;
            # with camera z travel the deepest *world* z visible grows to
            # z_range[1] + max_ground_depth
            zmax_world = max_ground_depth + max(0.0, self.z_range[1])
            v0 = int(np.ceil(self.cy + fx * ground_height / zmax_world))
            self.ground_v0 = max(v0, int(self.cy) + 2)
            rows = np.arange(self.ground_v0, height)
            self.ground_z = fx * ground_height / (rows - self.cy)
            # per-row shift = cam_x * (v - cy) / h; canvas must span it,
            # plus the yawed frustum's lateral reach (col - cx is
            # fx*X_x/X_z, bounded by tan(yaw_max + hfov) + x_reach/z_min)
            smax = (
                int(np.ceil(max(abs(x_range[0]), abs(x_range[1]))
                            * (height - self.cy) / ground_height)) + 4
                + max(pad_l, pad_r)
            )
            self.ground_smin = -smax
            self.ground_tex = self._texture(
                rng, len(rows), width + 2 * smax
            )

    @staticmethod
    def _texture(rng, h, w):
        """Noise base + distinct-intensity blobs: corner-rich and
        locally unique (no two blobs look alike to a descriptor).

        The result is band-limited with a small separable blur: real
        images are low-pass filtered by the lens/sensor PSF, and
        un-band-limited per-pixel noise breaks every subpixel method
        built on local smoothness (SAD parabola fits land on cusps,
        and a 1 px misalignment fully decorrelates patches — which is
        what made ground stereo matching collapse on this fixture)."""
        img = rng.normal(95.0, 20.0, (h, w)).astype(np.float32)
        n_blobs = max(1, (h * w) // 260)
        ys = rng.integers(0, max(1, h - 10), n_blobs)
        xs = rng.integers(0, max(1, w - 10), n_blobs)
        for y, x in zip(ys, xs):
            s = int(rng.integers(3, 9))
            img[y : y + s, x : x + s] = rng.uniform(25.0, 235.0)
        k = np.array([0.25, 0.5, 0.25], np.float32)
        for axis in (0, 1):
            img = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), axis, img
            )
        return np.clip(img, 0.0, 255.0)

    # ---- full-pose rendering (yaw / forward translation) -------------

    BACKGROUND = 88.0              # featureless fill for sky / off-canvas
    FAR_DEPTH = 1e4

    @staticmethod
    def _bilinear(tex, row, col):
        """NaN-aware bilinear sample; out-of-canvas -> NaN (transparent).

        NaN texels (the holes of sparse patch layers) poison their 2x2
        neighbourhood, matching the transparent-edge behaviour of the
        dolly path's lerp crop."""
        h, w = tex.shape
        row = np.nan_to_num(row, nan=-1e9)
        col = np.nan_to_num(col, nan=-1e9)
        # snap near-integer coordinates: float jitter of 1e-7 across an
        # integer boundary would blend a NaN neighbour into an opaque
        # texel and flip it transparent
        row = np.where(np.abs(row - np.round(row)) < 1e-4,
                       np.round(row), row)
        col = np.where(np.abs(col - np.round(col)) < 1e-4,
                       np.round(col), col)
        inb = (row >= 0) & (row <= h - 1) & (col >= 0) & (col <= w - 1)
        r0 = np.clip(np.floor(row), 0, h - 2).astype(np.int64)
        c0 = np.clip(np.floor(col), 0, w - 2).astype(np.int64)
        fr = np.clip((row - r0), 0.0, 1.0).astype(np.float32)
        fc = np.clip((col - c0), 0.0, 1.0).astype(np.float32)

        def lerp(a, b, f):
            # guarded at both ends: weight-0 neighbours must not be
            # read (a NaN there would poison an opaque texel)
            mid = a * (1 - f) + b * f
            return np.where(f <= 0, a, np.where(f >= 1, b, mid))

        a = tex[r0, c0]
        b = tex[r0, c0 + 1]
        c_ = tex[r0 + 1, c0]
        d = tex[r0 + 1, c0 + 1]
        out = lerp(lerp(a, b, fc), lerp(c_, d, fc), fr)
        return np.where(inb, out, np.nan)

    def _compose_pose(self, T_wc: np.ndarray):
        """Render from an arbitrary camera-to-world pose T_wc by exact
        ray/plane intersection (camera frame: x right, y down, z
        forward; world planes are z = const, ground is y = h).

        Requires |yaw| <= the `yaw_max` given at construction and camera
        z within `z_range` (canvas coverage); planes behind the camera
        are skipped per pixel."""
        T = np.asarray(T_wc, np.float64)
        R, C = T[:3, :3], T[:3, 3]
        us = np.arange(self.width, dtype=np.float64)
        vs = np.arange(self.height, dtype=np.float64)
        uu, vv = np.meshgrid(us, vs)
        dir_c = np.stack(
            [(uu - self.cx) / self.fx, (vv - self.cy) / self.fx,
             np.ones_like(uu)], axis=-1,
        )
        dir_w = dir_c @ R.T                     # (H, W, 3)
        img = np.full((self.height, self.width), self.BACKGROUND,
                      np.float32)
        dep = np.full((self.height, self.width), self.FAR_DEPTH,
                      np.float32)
        for z, shift_min, tex in self.layers:
            dz = dir_w[..., 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (z - C[2]) / dz
            ok = (dz > 1e-9) & (t > 0.25)
            t = np.where(ok, t, np.nan)
            Xx = C[0] + t * dir_w[..., 0]
            Xy = C[1] + t * dir_w[..., 1]
            col = self.fx * Xx / z + self.cx - shift_min
            row = self.fx * Xy / z + self.cy
            sample = self._bilinear(tex, row, col)
            # depth in the camera frame is t (dir_c has unit z)
            hit = ok & ~np.isnan(sample) & (t < dep)
            img[hit] = sample[hit]
            dep[hit] = t[hit].astype(np.float32)
        if self.ground_height is not None:
            h = self.ground_height
            dy = dir_w[..., 1]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (h - C[1]) / dy
            ok = (dy > 1e-9) & (t > 0.25)
            t = np.where(ok, t, np.nan)
            Xx = C[0] + t * dir_w[..., 0]
            Xz = C[2] + t * dir_w[..., 2]
            ok = ok & (Xz > 1e-3)
            with np.errstate(divide="ignore", invalid="ignore"):
                col = self.fx * Xx / Xz + self.cx - self.ground_smin
                row = self.fx * h / Xz + self.cy - self.ground_v0
            sample = self._bilinear(self.ground_tex, row, col)
            hit = ok & ~np.isnan(sample) & (t < dep)
            img[hit] = sample[hit]
            dep[hit] = t[hit].astype(np.float32)
        return np.clip(img, 0.0, 255.0), dep

    def render_pose(
        self, T_wc: np.ndarray, baseline: float = 0.0
    ) -> np.ndarray:
        """Left (baseline=0) or right view from a full SE(3) pose; the
        right camera sits at +baseline along the camera x-axis."""
        if baseline:
            T = np.array(T_wc, np.float64)
            T[:3, 3] = T[:3, 3] + T[:3, :3] @ [baseline, 0.0, 0.0]
            return self._compose_pose(T)[0]
        return self._compose_pose(T_wc)[0]


def pose_yaw(x: float, z: float, yaw: float, y: float = 0.0) -> np.ndarray:
    """Camera-to-world SE(3) at position (x, y, z) yawed about the world
    y-axis (camera convention: x right, y down, z forward; yaw > 0 turns
    the view toward +x)."""
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[:3, 3] = [x, y, z]
    return T


def forward_turn_trajectory(
    n_frames: int,
    step: float = 0.3,
    turn_start: int = 8,
    turn_frames: int = 16,
    total_yaw: float = np.radians(35.0),
    x0: float = 0.0,
    z0: float = 0.0,
) -> np.ndarray:
    """Car-like trajectory: drive straight along +z, then arc through
    `total_yaw` over `turn_frames`, then straight again — the synthetic
    analogue of a KITTI street turn (the reference's standard operating
    regime, dsp_slam.cc:62-99). View direction = heading. Returns
    (n_frames, 4, 4) camera-to-world poses."""
    poses = np.empty((n_frames, 4, 4))
    x, z, yaw = float(x0), float(z0), 0.0
    rate = total_yaw / max(turn_frames, 1)
    for k in range(n_frames):
        poses[k] = pose_yaw(x, z, yaw)
        if turn_start <= k < turn_start + turn_frames:
            yaw += rate
        x += step * np.sin(yaw)
        z += step * np.cos(yaw)
    return poses


def strafe_yaw_trajectory(
    n_frames: int,
    step: float = 0.3,
    yaw_start: int = 8,
    yaw_frames: int = 16,
    total_yaw: float = np.radians(25.0),
) -> np.ndarray:
    """Lateral dolly along +x (the classic mono fixture — parallax-rich,
    so monocular initialization works) whose VIEW yaw ramps through
    `total_yaw` mid-run. Exercises the rotational tracking path without
    the forward-motion degeneracy of mono initialization. Returns
    (n_frames, 4, 4) camera-to-world poses."""
    poses = np.empty((n_frames, 4, 4))
    yaw = 0.0
    rate = total_yaw / max(yaw_frames, 1)
    for k in range(n_frames):
        poses[k] = pose_yaw(k * step, 0.0, yaw)
        if yaw_start <= k < yaw_start + yaw_frames:
            yaw += rate
    return poses


# the renderer's array work releases the GIL, so poses render in threads
RENDER_THREADS = 4


def render_poses(fn, poses) -> list:
    """[fn(T) for T in poses], computed over RENDER_THREADS threads."""
    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        return list(pool.map(fn, poses))
