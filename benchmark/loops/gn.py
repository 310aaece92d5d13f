"""The batched object-reconstruction cell: back-to-back calls of
`dspslam_tpu_torch.shape.gn.batched_reconstruct` on the configuration's
decoder (kernel K1 on the card), each call's result fetched to the host
before the next call starts.

Each call's B objects come from a pool made in set-up from the seed, with
bench_gn's geometry (apps/bench.py::bench_gn_inputs at commit d92c068):
spheres about 8 m ahead seen through R rays and P surface points, the
initial Sim(3) at scale 2. Here each object's centre, radius and initial
pose and scale are jittered, the rays' depths are their true hits on the
sphere, and the surface points cover the sphere. `correct` re-solves a
sample of the window's calls with the plain reference (reference/gn.py) from
the same inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import checks, faults, gncheck
from ..common import SetupLog, synchronize
from ..fit import cached_fit
from ..reference import gn as gn_ref
from ..scene import UPRIGHT
from .slam import Sampler


def make_call(rng: np.random.Generator, B: int, P: int, R: int, code_len: int, g: dict) -> list[np.ndarray]:
    """One call's inputs: t_cam_obj, pts, pts_mask, rays, ray_mask, depth,
    fg_mask, code_init (numpy, float32)."""
    centers = np.stack([rng.uniform(-g["x_half"], g["x_half"], B), rng.uniform(-g["y_half"], g["y_half"], B),
                        rng.uniform(*g["z_range"], B)], -1)
    radius = rng.uniform(*g["radius_range"], B)
    t = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    # the object's +y axis up (camera -y), as a detector's boxes give it
    # (objects/detections.py), so the rotation prior (k4) starts satisfied
    t[:, :3, :3] = np.diag(UPRIGHT) * rng.uniform(*g["init_scale_range"], B)[:, None, None]
    t[:, :3, 3] = centers + rng.normal(0.0, g["init_pos_sigma"], (B, 3))
    dirs = rng.normal(size=(B, P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = centers[:, None, :] + radius[:, None, None] * dirs
    rays = (centers / centers[:, 2:3])[:, None, :] + np.concatenate(
        [rng.normal(0.0, g["ray_sigma"], (B, R, 2)), np.zeros((B, R, 1))], -1)
    # the near hit of each ray on its sphere (the ray's z component is 1)
    a = np.sum(rays * rays, -1)
    b = -2.0 * np.sum(rays * centers[:, None, :], -1)
    c = np.sum(centers * centers, -1)[:, None] - radius[:, None] ** 2
    disc = b * b - 4.0 * a * c
    hit = disc > 0
    depth = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a), 0.0)
    f32 = np.float32
    return [t, pts.astype(f32), np.ones((B, P), f32), rays.astype(f32), np.ones((B, R), f32),
            depth.astype(f32), hit.astype(f32), np.zeros((B, code_len), f32)]


class GnCell:
    def __init__(self, config: dict, mix: dict, seed: int, device, spans, log: SetupLog):
        self.config, self.mix, self.seed, self.device, self.spans, self.log = config, mix, seed, device, spans, log
        self.checked: dict[str, int] = {}
        self.calls = 0
        self.kept: list = []
        self.batch = mix["batch"]
        self.variant = None           # a planted fault or the control (faults.py); None in a benchmark run

    def setup(self):
        log, dev = self.log, self.device
        with log.stage("imports"):
            from dspslam_tpu_torch.models import deepsdf
            from dspslam_tpu_torch.shape import gn
        if dev.type == "cuda":
            with log.stage("kernels"):
                from dspslam_tpu_torch.kernels import decoder_fused

                decoder_fused.build()
        rng = np.random.default_rng(self.seed)
        with log.stage("decoder_fit"):
            ws, bs, loss, hit = cached_fit(self.config["decoder"], dev, steps=self.mix["decoder_fit_steps"])
            log.notes.update(decoder_fit_l1=loss, decoder_fit_cache_hit=hit)
        self.decoder_weights = (ws, bs)
        d = self.config["decoder"]
        precision = "default" if self.variant == "tf32" else d["matmul_precision"]
        dcfg = deepsdf.DecoderConfig(code_len=d["code_len"], hidden=tuple(d["hidden"]), latent_in=tuple(d["latent_in"]),
                                     matmul_precision=precision)
        self.decoder = deepsdf.DeepSDFDecoder(dcfg, ws, bs)
        det, opt = self.config["detection"], self.config["optimizer"]
        self.gcfg = gn.GNConfig(**opt)
        with log.stage("inputs"):
            self.pool = []
            for _ in range(self.mix["pool_size"]):
                arrays = make_call(rng, self.batch, det["max_surface_points"], det["max_rays"], opt["code_len"],
                                   self.mix["geometry"])
                self.pool.append([torch.from_numpy(a).to(dev) for a in arrays])
        self.order = rng.permutation(len(self.pool))
        self.capture_rng = np.random.default_rng(rng.integers(2 ** 63))
        if self.variant == "tf32":
            faults.control_decoder(self.decoder, ws, bs, d["latent_in"])
        self.run = faults.wrap_gn(gn.batched_reconstruct(self.decoder, self.gcfg), self.variant)
        self.tap = gncheck.DecoderTap(self.decoder, self.mix["check"]["grid_rows"],
                                      np.random.default_rng(rng.integers(2 ** 63)))
        with log.stage("warmup_calls"):
            for i in range(self.mix["warmup_calls"]):
                self._call(self.pool[self.order[i % len(self.pool)]])
            synchronize(dev)

    def _call(self, args):
        out = self.run(*args)
        return {k: v.cpu() for k, v in out.items()}

    def window(self, seconds: float, trace=None) -> float:
        chk = self.mix["check"]
        sampler = Sampler(self.capture_rng, chk["gn_spacing"], chk["sample_cap"])
        trace_s = self.mix.get("trace_seconds", seconds)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        if trace is not None:
            trace.start()
        while time.perf_counter() < deadline:
            idx = self.order[self.calls % len(self.pool)]
            keep = sampler.take()
            self.tap.record = [] if keep else None
            with self.spans.span("gn_call"):
                out = self._call(self.pool[idx])
            self.calls += 1
            if keep:
                self.kept.append((idx, out, self.tap.record))
            self.tap.record = None
            if trace is not None and trace.prof is not None and time.perf_counter() - t_start >= trace_s:
                trace.stop()
        if trace is not None and trace.prof is not None:
            trace.stop()
        return time.perf_counter() - t_start

    def attempted_failed(self) -> tuple[int, int]:
        return self.calls * self.batch, 0

    @property
    def objects(self) -> int:
        return self.calls * self.batch

    def k1_rows_per_call(self) -> list[int]:
        """Rows of each K1 launch of one call, in launch order: per iteration
        the B P surface rows, then the B K render-Jacobian rows."""
        det, opt = self.config["detection"], self.config["optimizer"]
        return [self.batch * det["max_surface_points"], self.batch * opt["max_grad_points"]] * opt["num_iterations"]

    def release(self):
        self.tap.remove()
        self.run = self.decoder = self.tap = None

    def check(self) -> dict:
        """The sampled calls followed step by step (gncheck.py)."""
        dec, dec64 = gncheck.plain_decoders(*self.decoder_weights, self.config["decoder"]["latent_in"])
        params = gn_ref.GNParams.from_config(self.config["optimizer"])
        readings, self.grid_rows, self.grad_rows = [], [], []
        for idx, out, record in self.kept:
            gaps = gncheck.gn_call_gaps(self.pool[idx], {k: v.to(self.device) for k, v in out.items()}, record, dec,
                                        dec64, params)
            rows = gaps.pop("rows")
            if rows is not None:
                self.grid_rows.append(rows[0])
                self.grad_rows.append(rows[1])
            readings.append(gaps)
        if not readings:
            raise RuntimeError("no GN call was sampled in the window")
        self.checked["gn_calls"] = len(readings)
        return checks.worst(readings)

Cell = GnCell
