"""ORB feature extraction as dense tensor programs.

Port of dspslam_tpu/frontend/orb.py (the reference's ORBextractor:
pyramid -> FAST -> grid NMS -> intensity-centroid orientation -> Gaussian
blur -> steered BRIEF) with fixed shapes and validity masks:

* the pyramid resizes the level-0 image with the antialiased triangle
  weights `jax.image.resize(..., "bilinear")` uses, built on the host once
  per level shape and applied as two f32 matrix products;
* FAST runs either as kernel K2 (`kernels/fast_score.py`: zero padding,
  sum |d| response, two tiers in one pass, every level of both pyramids of
  a stereo pair in one launch, `extract_stereo`) or as the arc-min "V"
  response with wraparound (`fast_score_map`); `ORBParams.fast_backend`
  picks;
* non-max suppression is a 3x3 local-maximum test, then top-k per grid
  cell and a global top-k, with ties broken toward the lower index as
  `jax.lax.top_k` breaks them (stable descending sorts);
* orientation gathers 31 x 31 patches for the selected keypoints
  (`orient_mode="patch"`) or reads dense moment maps of one 2-channel
  31 x 31 cross-correlation (`"conv"`); BRIEF samples the blurred level in
  one global gather (`brief_mode="auto"` / `"global"`) or from per-keypoint
  39 x 39 patches (`"patch"`); descriptors are (N, 8) int32, the bit view of
  the JAX package's uint32 words.

Every constant a level needs (resize weights, border mask, BRIEF
pattern, moment weights) is cached on its device after the first call, so
a steady-state extraction makes no host-device transfer.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels import fast_score

HALF_PATCH = 15
PATCH = 31
EDGE_MARGIN = 19  # no keypoints closer than this to a level border
BOOST = 1e4       # high-tier score offset of the two-tier selection

# Bresenham circle of radius 3 (FAST-16 offsets, clockwise from top), (dx, dy)
_CIRCLE = np.array(fast_score.CIRCLE, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class ORBParams:
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    fast_threshold: float = 20.0
    min_threshold: float = 7.0
    cell_size: int = 16          # top-k bin size in pixels
    per_cell: int = 4            # candidates kept per cell
    seed: int = 1234             # BRIEF pattern seed (pattern="seeded")
    # BRIEF test-pair table: "seeded" draws the classic Gaussian pattern;
    # "reference" uses OpenCV's learned 512-point table (orb_pattern.py)
    pattern: str = "seeded"
    # FAST detector: "pallas" is K2's response (the CUDA kernel on a CUDA
    # tensor, its plain version on a CPU tensor), "xla" the arc-min path,
    # "auto" K2 on the card and the arc-min path on the CPU
    fast_backend: str = "auto"
    # "patch" gathers 31x31 patches; "conv" reads dense moment maps
    orient_mode: str = "patch"
    # "auto" and "global": one global sample gather; "patch": per-keypoint
    # patches. "onehot" (a TPU gather workaround) is not carried over
    brief_mode: str = "auto"

    def features_per_level(self) -> list[int]:
        """Geometric budget per level (ORBextractor.cc:436-447)."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f**self.n_levels)
        out, total = [], 0
        for _ in range(self.n_levels - 1):
            out.append(int(round(n0)))
            total += out[-1]
            n0 *= f
        out.append(max(self.n_features - total, 0))
        return out

    def level_scales(self) -> list[float]:
        return [self.scale_factor**i for i in range(self.n_levels)]


def brief_pattern(seed: int = 1234, n_pairs: int = 256) -> np.ndarray:
    """(n_pairs, 2, 2) int32 test-pair offsets in patch coordinates:
    both endpoints ~ N(0, (patch/5)^2), clipped to the patch."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(n_pairs, 2, 2))
    pts = np.clip(np.round(pts), -(HALF_PATCH - 2), HALF_PATCH - 2)
    return pts.astype(np.int32)


def pattern_for(params: ORBParams) -> np.ndarray:
    """Resolve the test-pair table for an ORBParams (see .pattern)."""
    if params.pattern == "reference":
        from .orb_pattern import reference_pattern

        return reference_pattern()
    return brief_pattern(params.seed)


# ---------------------------------------------------------------------------
# Device-resident constants

_DEVICE_CONSTS: dict = {}


def _on_device(key, device: torch.device, make) -> torch.Tensor:
    """`make()` (a numpy array) as a tensor on `device`, built once."""
    k = (key, str(device))
    hit = _DEVICE_CONSTS.get(k)
    if hit is None:
        hit = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        _DEVICE_CONSTS[k] = hit
    return hit


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 antialiased triangle weights, as
    jax/_src/image/scale.py::compute_weight_mat builds them for
    `jax.image.resize(..., "bilinear")`: kernel scale max(in/out, 1),
    columns normalised, samples outside the input zeroed. Computed in f32
    like the JAX original."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)), f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W) f32 -> (h, w): Wy^T @ img @ Wx with the antialiased weights."""
    H, W = img.shape
    wy = _on_device(("resize", H, h), img.device, lambda: resize_weights(H, h))
    wx = _on_device(("resize", W, w), img.device, lambda: resize_weights(W, w))
    return (wy.t() @ img) @ wx


# ---------------------------------------------------------------------------
# Dense FAST score map (arc-min "V" response)


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 corner response for every pixel of a (H, W) float image:
    over all contiguous 9-arcs uniformly brighter (or darker) than
    center +/- threshold, the maximum of the arc's minimum absolute
    difference; 0 at non-corners. Neighbours wrap around the edges."""
    d = torch.stack(
        [torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(0, 1)) - img for dx, dy in _CIRCLE]
    )                                                     # (16, H, W)
    bright = d > threshold
    dark = d < -threshold
    score = torch.zeros_like(img)
    for k in range(16):
        idx = [(k + j) % 16 for j in range(9)]
        arc_b = bright[idx[0]]
        arc_d = dark[idx[0]]
        vmin_b = d[idx[0]]
        vmin_d = -d[idx[0]]
        for j in idx[1:]:
            arc_b = arc_b & bright[j]
            arc_d = arc_d & dark[j]
            vmin_b = torch.minimum(vmin_b, d[j])
            vmin_d = torch.minimum(vmin_d, -d[j])
        score = torch.maximum(score, torch.where(arc_b, vmin_b, 0.0))
        score = torch.maximum(score, torch.where(arc_d, vmin_d, 0.0))
    return score


def _local_maxima(score: torch.Tensor) -> torch.Tensor:
    """Keep scores that are >= all 8 neighbours (3x3 NMS, wraparound)."""
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = torch.maximum(neigh, torch.roll(score, (dy, dx), (0, 1)))
    return torch.where(score >= neigh, score, 0.0)


def _border_mask(H: int, W: int) -> np.ndarray:
    """1 at least EDGE_MARGIN pixels from every border, else 0."""
    mask = np.zeros((H, W), np.float32)
    mask[EDGE_MARGIN:H - EDGE_MARGIN, EDGE_MARGIN:W - EDGE_MARGIN] = 1.0
    return mask


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last dim: largest first, equal values in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, k: int, cell: int = 16, per_cell: int = 4):
    """Spatially spread top-k selection from a dense score map: the top
    `per_cell` local maxima of every grid cell feed a global top-k.
    Returns (xy (k, 2) f32 [x, y], response (k,), valid (k,))."""
    H, W = score.shape
    border = _on_device(("border", H, W), score.device, lambda: _border_mask(H, W))
    score = _local_maxima(score) * border

    Hc, Wc = H // cell, W // cell
    cells = score[: Hc * cell, : Wc * cell].reshape(Hc, cell, Wc, cell)
    cells = cells.permute(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)
    top_val, top_idx = _top_k(cells, per_cell)            # (Hc*Wc, per_cell)

    cell_ids = torch.arange(Hc * Wc, device=score.device)
    ys = ((cell_ids // Wc) * cell)[:, None] + top_idx // cell
    xs = ((cell_ids % Wc) * cell)[:, None] + top_idx % cell

    flat_val = top_val.reshape(-1)
    flat_ys = ys.reshape(-1)
    flat_xs = xs.reshape(-1)
    if flat_val.shape[0] < k:
        # small levels can hold fewer candidates than the budget: pad
        # slots score 0 -> valid 0
        pad = k - flat_val.shape[0]
        flat_val = torch.nn.functional.pad(flat_val, (0, pad))
        flat_ys = torch.nn.functional.pad(flat_ys, (0, pad))
        flat_xs = torch.nn.functional.pad(flat_xs, (0, pad))
    val, idx = _top_k(flat_val, k)
    xy = torch.stack([flat_xs[idx], flat_ys[idx]], dim=-1).to(torch.float32)
    valid = (val > 0).to(torch.float32)
    return xy * valid[:, None], val * valid, valid


# ---------------------------------------------------------------------------
# Orientation + descriptors


def _moment_weights() -> np.ndarray:
    yy, xx = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    inside = (xx**2 + yy**2) <= HALF_PATCH**2
    return np.stack([xx * inside, yy * inside]).astype(np.float32)   # (2, 31, 31)


def gather_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(K, 31, 31) image patches centered on integer keypoints (clamped)."""
    H, W = img.shape
    ar = torch.arange(PATCH, device=img.device)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - HALF_PATCH, 0, H - PATCH)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - HALF_PATCH, 0, W - PATCH)
    return img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]


def orientations(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per keypoint (IC_Angle, ORBextractor.cc:78-106)."""
    patches = gather_patches(img, xy)                     # (K, 31, 31)
    uv = _on_device("moments", img.device, _moment_weights).to(img.dtype)
    m10 = torch.sum(patches * uv[0], dim=(1, 2))
    m01 = torch.sum(patches * uv[1], dim=(1, 2))
    return torch.atan2(m01, m10)                          # (K,) radians


def orientations_conv(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angles from dense moment maps: one 2-channel
    31x31 cross-correlation (zero padding) gives m10 / m01 at every pixel,
    and each keypoint reads its two. The same angles as `orientations` for
    keypoints >= HALF_PATCH from the border (every valid one)."""
    k = _on_device("moments", img.device, _moment_weights).to(img.dtype)
    maps = torch.nn.functional.conv2d(img[None, None], k[:, None], padding=HALF_PATCH)[0]
    xi = xy[:, 0].to(torch.int64)
    yi = xy[:, 1].to(torch.int64)
    return torch.atan2(maps[1, yi, xi], maps[0, yi, xi])


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian as shifted adds (wraparound), in the JAX
    package's order of operations."""
    x = np.arange(-3, 4)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = (g / g.sum()).astype(np.float32)
    out_r = torch.zeros_like(img)
    for k, w in enumerate(g):
        out_r = out_r + float(w) * torch.roll(img, 3 - k, dims=1)
    out = torch.zeros_like(img)
    for k, w in enumerate(g):
        out = out + float(w) * torch.roll(out_r, 3 - k, dims=0)
    return out


def _pack_brief_bits(vals: torch.Tensor) -> torch.Tensor:
    """(K, 256, 2) sampled pair values -> (K, 8) int32, the bit view of the
    packed uint32 words (bit i of word j is test 32 j + i)."""
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, device=vals.device)
    packed = torch.sum(bits << shifts, dim=-1)            # [0, 2^32)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def _rotated_offsets(xy, angles, pattern):
    """Per-keypoint rotated pattern positions (image coords, float)."""
    cos, sin = torch.cos(angles), torch.sin(angles)      # (K,)
    px, py = pattern[..., 0], pattern[..., 1]             # (256, 2)
    rx = cos[:, None, None] * px - sin[:, None, None] * py   # (K, 256, 2)
    ry = sin[:, None, None] * px + cos[:, None, None] * py
    return xy[:, None, None, 0] + rx, xy[:, None, None, 1] + ry


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor,
                      pattern: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 -> (K, 8) int32 packed descriptors: pattern
    offsets (f32, (256, 2, 2)) rotated by each keypoint's angle, sampled
    with nearest rounding (computeOrbDescriptor, ORBextractor.cc:109-143)
    in one global (K, 256, 2) gather."""
    H, W = img_blur.shape
    fx, fy = _rotated_offsets(xy, angles, pattern)
    gx = torch.clamp(torch.round(fx), 0, W - 1).to(torch.int64)
    gy = torch.clamp(torch.round(fy), 0, H - 1).to(torch.int64)
    return _pack_brief_bits(img_blur[gy, gx])


R_BRIEF = 19  # patch radius covering any rotated offset (13 * sqrt(2) < 19)


def brief_descriptors_patch(img_blur: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor,
                            pattern: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF from per-keypoint 39x39 blurred patches and
    patch-local sample indices; bit-identical to `brief_descriptors` for
    keypoints >= EDGE_MARGIN from the border (every valid one), whose
    rotated offsets never leave the patch."""
    H, W = img_blur.shape
    S = 2 * R_BRIEF + 1
    ar = torch.arange(S, device=img_blur.device)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - R_BRIEF, 0, H - S)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - R_BRIEF, 0, W - S)
    patches = img_blur[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]
    fx, fy = _rotated_offsets(xy, angles, pattern)
    gx = torch.clamp(torch.round(fx), 0, W - 1).to(torch.int64)
    gy = torch.clamp(torch.round(fy), 0, H - 1).to(torch.int64)
    lx = torch.clamp(gx - x0[:, None, None], 0, S - 1)
    ly = torch.clamp(gy - y0[:, None, None], 0, S - 1)
    li = (ly * S + lx).reshape(xy.shape[0], -1)            # (K, 512)
    vals = torch.take_along_dim(patches.reshape(xy.shape[0], S * S), li, dim=1)
    return _pack_brief_bits(vals.reshape(xy.shape[0], -1, 2))


# ---------------------------------------------------------------------------
# Full extraction


def _use_k2(backend: str, device: torch.device) -> bool:
    if backend == "pallas":
        return True
    if backend == "xla":
        return False
    if backend == "auto":
        return device.type == "cuda"
    raise ValueError(f"unknown fast_backend {backend!r}")


_ORIENT = {"patch": orientations, "conv": orientations_conv}
_BRIEF = {"auto": brief_descriptors, "global": brief_descriptors,
          "patch": brief_descriptors_patch}


def _check_modes(params: ORBParams):
    if params.orient_mode not in _ORIENT:
        raise NotImplementedError(f"orient_mode={params.orient_mode!r} is not ported")
    if params.brief_mode not in _BRIEF:
        raise NotImplementedError(f"brief_mode={params.brief_mode!r} is not ported")


def level_shapes(params: ORBParams, H0: int, W0: int) -> list[tuple[int, int]]:
    scales = params.level_scales()
    return [(int(round(H0 / s)), int(round(W0 / s))) for s in scales]


def brief_pattern_tensor(params: ORBParams, device: torch.device) -> torch.Tensor:
    """(256, 2, 2) f32 test-pair table on `device`, cached."""
    return _on_device(
        ("pattern", params.pattern, params.seed), device,
        lambda: pattern_for(params).astype(np.float32),
    )


def two_tier_scores(level_imgs: list[torch.Tensor], params: ORBParams) -> list[torch.Tensor]:
    """Two-tier score maps of f32 (h, w) level images: K2 (one launch for
    up to 16 maps, BOOST added at t_hi corners) or the arc-min path, whose
    score V satisfies "corner at t iff V > t", so its high tier is
    {V > fast_threshold}, boosted by a constant."""
    if _use_k2(params.fast_backend, level_imgs[0].device):
        return fast_score.fast_score_maps(
            [img.contiguous() for img in level_imgs], params.min_threshold,
            params.fast_threshold, BOOST,
        )
    out = []
    for img in level_imgs:
        score = fast_score_map(img, params.min_threshold)
        out.append(torch.where(score > params.fast_threshold, score + BOOST, score))
    return out


def extract_level(level_img: torch.Tensor, level: int, params: ORBParams,
                  pattern: torch.Tensor, score: torch.Tensor) -> dict:
    """Detection, orientation and BRIEF on one pyramid level (f32 (h, w))
    from its two-tier score map. Coordinates come back in level-0 pixels."""
    budget = params.features_per_level()[level]
    scale = params.level_scales()[level]
    xy, resp, valid = select_keypoints(score, budget, params.cell_size, params.per_cell)
    ang = _ORIENT[params.orient_mode](level_img, xy)
    desc = _BRIEF[params.brief_mode](gaussian_blur7(level_img), xy, ang, pattern)
    return {
        "xy": xy * scale,
        "response": resp,
        "angle": ang,
        "level": torch.full((budget,), level, dtype=torch.int32, device=xy.device),
        "sigma2": torch.full((budget,), scale**2, dtype=torch.float32, device=xy.device),
        "desc": desc,
        "valid": valid,
    }


def _extract_pyramids(images: list[torch.Tensor], params: ORBParams) -> list[dict]:
    """Features of equally shaped images: every image's pyramid is built
    first (each level resized from level 0), then K2 scores all levels of
    all images in one launch (levels in order, the images of a level
    adjacent), then each level is detected and described."""
    _check_modes(params)
    imgs = [img.to(torch.float32) for img in images]
    pattern = brief_pattern_tensor(params, imgs[0].device)
    shapes = level_shapes(params, *imgs[0].shape)
    pyramids = [
        [img if level == 0 else resize(img, h, w) for level, (h, w) in enumerate(shapes)]
        for img in imgs
    ]
    flat = two_tier_scores([pyr[level] for level in range(len(shapes)) for pyr in pyramids], params)
    scores = [flat[i::len(imgs)] for i in range(len(imgs))]
    feats = []
    for pyr, score in zip(pyramids, scores):
        outs = [extract_level(pyr[level], level, params, pattern, score[level])
                for level in range(len(shapes))]
        feats.append({k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]})
    return feats


def extract(img: torch.Tensor, params: ORBParams = ORBParams()) -> dict:
    """Multi-scale ORB extraction on a (H, W) image in [0, 255] (uint8 or
    float). Returns a dict of padded tensors over N = sum of the level
    budgets: xy (N, 2) level-0 pixels, response (N,), angle (N,),
    level (N,) int32, sigma2 (N,), desc (N, 8) int32, valid (N,)."""
    return _extract_pyramids([img], params)[0]


def extract_stereo(img_l: torch.Tensor, img_r: torch.Tensor,
                   params: ORBParams = ORBParams()) -> tuple[dict, dict]:
    """`extract` of both images of a stereo pair (same shape), with one K2
    launch for the two pyramids; returns what two `extract` calls return."""
    if img_l.shape != img_r.shape:
        raise ValueError(f"stereo images differ in shape: {tuple(img_l.shape)} {tuple(img_r.shape)}")
    feats_l, feats_r = _extract_pyramids([img_l, img_r], params)
    return feats_l, feats_r
