"""The plain reference of the batched object Gauss-Newton (pose + shape).

Plain PyTorch: the DeepSDF decoder as a loop of `linear` layers with its
input gradient taken by autograd, and the residual blocks and the normal
equations of dspslam_tpu_torch/shape/{gn,losses}.py and ops/robust.py as
they stood at commit d92c068, copied. It takes the decoder's weights as the
benchmark made them (never the port's module) and imports nothing of the
port. `tf32` runs the decoder's products in TF32 (a control, never the
reference itself); geometry stays float32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from . import lie

POSE_DIM = 7


@dataclasses.dataclass(frozen=True)
class GNParams:
    """The configuration's optimizer group (config_kitti.json's names)."""

    code_len: int = 64
    num_depth_samples: int = 50
    cut_off: float = 0.01
    k1: float = 1.0
    k2: float = 100.0
    k3: float = 0.25
    k4: float = 1e7
    b1: float = 0.20
    b2: float = 0.025
    learning_rate: float = 1.0
    scale_damping: float = 1.0
    pose_damping: float = 1.0
    num_iterations: int = 10
    max_grad_points: int = 1024
    min_render_points: int = 10
    max_scale_step: float = 0.1

    @classmethod
    def from_config(cls, optimizer: dict) -> "GNParams":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in optimizer.items() if k in names})


@contextlib.contextmanager
def _tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class PlainDecoder:
    """DeepSDF's auto-decoder MLP: ReLU layers, the input re-joined before
    the layers in `latent_in`, a final tanh. weights[i] is (out, in)."""

    def __init__(self, weights, biases, latent_in=(4,), tf32: bool = False):
        self.weights, self.biases = list(weights), list(biases)
        self.latent_in = tuple(latent_in)
        self.tf32 = tf32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with _tf32(self.tf32):
            inp, h = x, x
            last = len(self.weights) - 1
            for i, (w, b) in enumerate(zip(self.weights, self.biases)):
                if i in self.latent_in:
                    h = torch.cat([h, inp], dim=-1)
                h = torch.nn.functional.linear(h, w, b)
                if i < last:
                    h = torch.relu(h)
            return torch.tanh(h[..., 0])

    def sdf_and_input_grad(self, x: torch.Tensor):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            sdf = self(x)
            with _tf32(self.tf32):
                (g,) = torch.autograd.grad(sdf.sum(), x)
        return sdf.detach(), g


def _huber_weights(r, b):
    r = torch.abs(r)
    rho = torch.where(r <= b, r ** 2, 2.0 * b * r - b * b)
    zero = r == 0.0
    safe = torch.where(zero, torch.ones_like(r), r)
    return torch.where(zero, torch.ones_like(r), torch.sqrt(torch.clamp(rho, min=0.0)) / safe)


def _robust(res, b, mask):
    w = _huber_weights(res, b) * mask
    robust = w * res
    return robust, torch.sum(robust ** 2, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)


def _with_code(code, pts):
    B, N, _ = pts.shape
    L = code.shape[-1]
    return torch.cat([code[:, None, :].expand(B, N, L), pts], dim=-1).reshape(B * N, L + 3)


def _sdf_surface(dec, pts_cam, pts_mask, t_obj_cam, code):
    B, P, _ = pts_cam.shape
    L = code.shape[-1]
    pts_obj = lie.transform_points(t_obj_cam, pts_cam)
    sdf, g = dec.sdf_and_input_grad(_with_code(code, pts_obj))
    sdf, g = sdf.reshape(B, P), g.reshape(B, P, L + 3)
    j_pose = (g[..., None, L:] @ lie.points_to_pose_jacobian_sim3(pts_obj))[..., 0, :]
    J = torch.cat([j_pose, g[..., :L]], dim=-1)
    return J * pts_mask[..., None], sdf * pts_mask, pts_mask


def _render(dec, rays, ray_mask, depth_obs, fg_mask, t_obj_cam, code, S, cut_off, K,
            res_clamp=0.30, min_grad=1e-2):
    B, R, _ = rays.shape
    L = code.shape[-1]
    dev, dt = rays.device, rays.dtype
    t_cam_obj = lie.inverse_sim3(t_obj_cam)
    scale = lie.split_sim3(t_cam_obj)[0]
    d_min, d_max = t_cam_obj[:, 2, 3] - scale, t_cam_obj[:, 2, 3] + scale
    depths = torch.linspace(0.0, 1.0, S, device=dev, dtype=dt) * (d_max - d_min)[:, None] + d_min[:, None]
    delta_d = (d_max - d_min) / (S - 1)
    target = torch.where(fg_mask > 0, depth_obs, 1.1 * d_max[:, None])
    pts_obj = lie.transform_points(t_obj_cam, (rays[:, :, None, :] * depths[:, None, :, None]).reshape(B, R * S, 3))
    valid = (torch.linalg.vector_norm(pts_obj + 1e-12, dim=-1) < 1.0).reshape(B, R, S) & (ray_mask[..., None] > 0)
    sdf = dec(_with_code(code, pts_obj)).reshape(B, R, S)
    occ = torch.where(valid, 0.5 - torch.clamp(sdf, -cut_off, cut_off) / (2.0 * cut_off), torch.zeros_like(sdf))
    acc = torch.cumprod(1.0 - occ, dim=-1)
    ones = torch.ones((B, R, 1), device=dev, dtype=dt)
    term = torch.cat([occ, ones], dim=-1) * torch.cat([ones, acc], dim=-1)
    d_u = torch.sum(torch.cat([depths, 1.1 * d_max[:, None]], dim=-1)[:, None, :] * term, dim=-1)
    de_do = torch.flip(torch.cumsum(torch.flip(acc, [-1]), dim=-1), [-1]) / torch.clamp(1.0 - occ, min=1e-6)
    with_grad = valid & (torch.abs(sdf) < cut_off) & (de_do > min_grad)
    res_ray = torch.clamp(target - d_u, -res_clamp, res_clamp)
    score = with_grad.reshape(B, R * S).to(dt)
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :K]
    k_mask = torch.gather(score, 1, idx)
    pts_k = torch.gather(pts_obj, 1, idx[..., None].expand(-1, -1, 3))
    de_ds = torch.gather(de_do.reshape(B, R * S), 1, idx) * delta_d[:, None] * (-1.0 / (2.0 * cut_off))
    res_k = torch.gather(res_ray, 1, idx // S) * k_mask
    _, g = dec.sdf_and_input_grad(_with_code(code, pts_k))
    de_din = de_ds[..., None] * g.reshape(B, -1, L + 3)
    j_pose = (de_din[..., None, L:] @ lie.points_to_pose_jacobian_sim3(pts_k))[..., 0, :]
    J = torch.cat([j_pose, de_din[..., :L]], dim=-1) * k_mask[..., None]
    return J, res_k, k_mask, torch.sum(valid.reshape(B, -1), dim=-1)


def _rotation_prior(t_obj_cam):
    _, r_co, _ = lie.split_sim3(lie.inverse_sim3(t_obj_cam))
    dev, dt = t_obj_cam.device, t_obj_cam.dtype
    ey = torch.tensor([0.0, 1.0, 0.0], device=dev, dtype=dt)
    ng = torch.tensor([0.0, -1.0, 0.0], device=dev, dtype=dt)
    res = 1.0 - (r_co @ ey) @ ng
    r_oc_ng = r_co.transpose(-1, -2) @ ng
    J = torch.zeros(t_obj_cam.shape[:-2] + (7,), device=dev, dtype=dt)
    J[..., 3:6] = torch.linalg.cross(ey.expand_as(r_oc_ng), r_oc_ng, dim=-1)
    live = (res >= 1e-7).to(dt)
    return J * live[..., None], res * live


def _normal_eqs(J, r, mask):
    n = torch.clamp(torch.sum(mask, dim=-1), min=1.0)[:, None]
    Jt = J.transpose(-1, -2)
    return (Jt @ J) / n[..., None], -(Jt @ r[..., None])[..., 0] / n


def step(dec: PlainDecoder, p: GNParams, t_obj_cam, code, pts, pts_mask, rays, ray_mask, depth, fg_mask):
    """One GN iteration of B objects from the state (t_obj_cam, code).
    Returns (t_obj_cam, code) after it (an object whose iteration is not
    healthy keeps its state), healthy (B,), loss (B,) at the state given,
    and the counts n_valid (grid samples inside the unit ball) and n_grad
    (live surface and render-Jacobian rows)."""
    B, L = t_obj_cam.shape[0], p.code_len
    dev, dt = t_obj_cam.device, t_obj_cam.dtype
    J_s, r_s, m_s = _sdf_surface(dec, pts, pts_mask, t_obj_cam, code)
    rr_s, l_s = _robust(r_s, p.b2, m_s)
    J_r, r_r, m_r, n_q = _render(dec, rays, ray_mask, depth, fg_mask, t_obj_cam, code,
                                 p.num_depth_samples, p.cut_off, p.max_grad_points)
    rr_r, l_r = _robust(r_r, p.b1, m_r)
    J_rot, r_rot = _rotation_prior(t_obj_cam)
    H_s, b_s = _normal_eqs(J_s, rr_s, m_s)
    H_r, b_r = _normal_eqs(J_r, rr_r, m_r)
    H = p.k1 * H_r + p.k2 * H_s
    b = p.k1 * b_r + p.k2 * b_s
    H[:, POSE_DIM:, POSE_DIM:] += p.k3 * torch.eye(L, device=dev, dtype=dt)
    b[:, POSE_DIM:] -= p.k3 * code
    H[:, :POSE_DIM, :POSE_DIM] += p.k4 * (J_rot[:, :, None] * J_rot[:, None, :])
    b[:, :POSE_DIM] -= p.k4 * J_rot * r_rot[:, None]
    H[:, :POSE_DIM, :POSE_DIM] += p.pose_damping * torch.eye(POSE_DIM, device=dev, dtype=dt)
    H[:, POSE_DIM - 1, POSE_DIM - 1] += p.scale_damping
    dx, info = torch.linalg.solve_ex(H, b)
    dx[:, POSE_DIM - 1] = torch.clamp(dx[:, POSE_DIM - 1], -p.max_scale_step, p.max_scale_step)
    t_new = lie.exp_sim3(p.learning_rate * dx[:, :POSE_DIM]) @ t_obj_cam
    code_new = code + p.learning_rate * dx[:, POSE_DIM:]
    loss = p.k1 * l_r + p.k2 * l_s
    render_required = torch.sum(fg_mask, dim=-1) > 0
    healthy = (torch.isfinite(loss) & torch.all(torch.isfinite(dx), dim=-1) & (info == 0)
               & ((n_q >= p.min_render_points) | ~render_required))
    return (torch.where(healthy[:, None, None], t_new, t_obj_cam), torch.where(healthy[:, None], code_new, code),
            healthy, loss, n_q.sum().double(), (m_s.sum() + m_r.sum()).double())


def reconstruct(dec: PlainDecoder, p: GNParams, t_cam_obj, pts, pts_mask, rays, ray_mask, depth, fg_mask,
                code_init):
    """The joint GN of B objects from the inputs the port was given: the
    configuration's iterations of `step`. Returns dict(t_cam_obj, code,
    is_good, loss, n_valid, n_grad), the counts summed over iterations."""
    B = t_cam_obj.shape[0]
    code = code_init[:, :p.code_len].to(t_cam_obj.dtype)
    t_obj_cam = lie.inverse_sim3(t_cam_obj)
    is_good = torch.ones((B,), device=t_cam_obj.device, dtype=torch.bool)
    loss = torch.zeros((B,), device=t_cam_obj.device, dtype=t_cam_obj.dtype)
    n_valid = n_grad = 0.0
    for _ in range(p.num_iterations):
        t_obj_cam, code, healthy, loss, nv, ng = step(dec, p, t_obj_cam, code, pts, pts_mask, rays, ray_mask,
                                                       depth, fg_mask)
        is_good = is_good & healthy
        n_valid, n_grad = n_valid + nv, n_grad + ng
    return {"t_cam_obj": lie.inverse_sim3(t_obj_cam), "code": code, "is_good": is_good, "loss": loss,
            "n_valid": n_valid, "n_grad": n_grad}
