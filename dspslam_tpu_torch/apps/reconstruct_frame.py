"""Single-frame object reconstruction: the minimum end-to-end slice.

Port of dspslam_tpu/apps/reconstruct_frame.py: offline detections ->
LiDAR crop / mask association -> batched Gauss-Newton pose + shape ->
meshes, with every object of the frame optimized in one batched pass.

Usage:
    python -m dspslam_tpu_torch.apps.reconstruct_frame \\
        --sequence_dir <kitti_seq_dir> --frame_id 200 \\
        --config configs/config_kitti.json --output_dir out/

Works against reference-format sequences (image_2/, velodyne/, calib.txt
+ .lbl or .npz label dirs). With --synthetic it runs on the built-in
analytic scene, and on the analytic sphere decoder unless the config
names a DeepSDF experiment directory. `--device` defaults to cuda; asking
for cuda without a card is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from .. import config as cfg_mod
from ..detect import offline, synthetic
from ..models import deepsdf
from ..objects import detections as det_mod
from ..shape import gn, mesh
from ..utils import io as io_mod
from ..utils.timing import StageTimer


def resolve_device(name: str) -> torch.device:
    """torch.device for `name`; cuda without a usable card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} was asked for but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU"
        )
    return device


def get_decoder(system_cfg, device):
    """The DeepSDF decoder of the configured experiment dir, or the
    analytic sphere decoder when no weights are configured."""
    if system_cfg.deepsdf_dir and os.path.isdir(system_cfg.deepsdf_dir):
        return deepsdf.load_torch_checkpoint(system_cfg.deepsdf_dir, device=device)[1]
    params = deepsdf.make_sphere_params(
        code_len=system_cfg.optimizer.code_len, device=device
    )
    return deepsdf.SphereDecoder(params)


def reconstruct_frame_batch(decoder, system_cfg, dets, device):
    """List of Detections -> batched GN results (numpy) + the padded batch."""
    d = system_cfg.detection
    batch = det_mod.pad_detections(
        dets, d.max_detections, d.max_surface_points, d.max_rays
    )

    def dev(key):
        return torch.as_tensor(batch[key], device=device)

    run = gn.batched_reconstruct(decoder, system_cfg.optimizer)
    out = run(
        dev("t_cam_obj"), dev("pts"), dev("pts_mask"), dev("rays"),
        dev("ray_mask"), dev("depth"), dev("fg_mask"),
        torch.zeros((d.max_detections, system_cfg.optimizer.code_len), device=device),
    )
    return batch, {k: v.cpu().numpy() for k, v in out.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sequence_dir")
    p.add_argument("--frame_id", type=int, default=0)
    p.add_argument("--config")
    p.add_argument("--output_dir", default="out")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--voxels_dim", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    # geometry runs in full f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)

    system_cfg = (
        cfg_mod.SystemConfig.load(args.config)
        if args.config
        else cfg_mod.SystemConfig()
    )
    if args.voxels_dim:
        system_cfg = dataclasses.replace(system_cfg, voxels_dim=args.voxels_dim)

    timer = StageTimer()
    decoder = get_decoder(system_cfg, device)

    with timer.stage("load_frame"):
        if args.synthetic:
            scene = synthetic.make_sphere_scene()
            velo, K, invK = scene.velo_pts, scene.K, scene.invK
            T_cam_velo, image_hw = scene.T_cam_velo, scene.image_hw
            boxes_3d, boxes_2d, masks_2d = (
                scene.boxes_3d, scene.boxes_2d, scene.masks_2d,
            )
        else:
            calib = io_mod.read_kitti_calib(
                os.path.join(args.sequence_dir, "calib.txt")
            )
            K, T_cam_velo = io_mod.kitti_cam2_calibration(calib)
            invK = np.linalg.inv(K).astype(np.float32)
            velo = io_mod.load_velodyne(
                os.path.join(
                    args.sequence_dir, "velodyne", f"{args.frame_id:06d}.bin"
                )
            )
            img = io_mod.load_image_rgb(
                os.path.join(
                    args.sequence_dir, "image_2", f"{args.frame_id:06d}.png"
                )
            )
            image_hw = img.shape[:2]
            boxes_3d = offline.load_labels_3d(
                system_cfg.detection.path_label_3d, args.frame_id
            )
            boxes_2d, masks_2d = offline.load_labels_2d(
                system_cfg.detection.path_label_2d, args.frame_id
            )

    with timer.stage("build_detections"):
        dets = det_mod.build_frame_detections(
            boxes_3d, masks_2d, boxes_2d, velo, K, invK, T_cam_velo, image_hw,
            max_lidar_points=system_cfg.detection.num_lidar_max,
            min_mask_area=system_cfg.detection.min_mask_area,
            bg_stride=system_cfg.detection.downsample_ratio,
            max_bg_rays=system_cfg.detection.max_bg_rays,
        )
        dets = [
            d for d in dets
            if d.num_surface_points >= system_cfg.detection.num_lidar_min
        ]

    with timer.stage("gauss_newton"):
        batch, results = reconstruct_frame_batch(decoder, system_cfg, dets, device)

    os.makedirs(args.output_dir, exist_ok=True)
    extractor = mesh.MeshExtractor(
        decoder, system_cfg.optimizer.code_len, system_cfg.voxels_dim, device
    )
    summary = []
    for i in range(len(dets)):
        good = bool(results["is_good"][i]) and bool(batch["valid"][i] > 0)
        rec = {
            "index": i,
            "is_good": good,
            "loss": float(results["loss"][i]),
            "t_cam_obj": results["t_cam_obj"][i].tolist(),
            "code": results["code"][i].tolist(),
        }
        if good:
            with timer.stage("mesh"):
                m = extractor.extract_mesh_from_code(results["code"][i])
            ply = os.path.join(args.output_dir, f"object_{i}.ply")
            io_mod.write_mesh_ply(m["vertices"], m["faces"], ply)
            rec["mesh"] = ply
        summary.append(rec)

    with open(os.path.join(args.output_dir, "frame_recon.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(timer)
    print(
        f"reconstructed {sum(r['is_good'] for r in summary)}/{len(summary)} objects "
        f"on {device} -> {args.output_dir}"
    )
    return summary


if __name__ == "__main__":
    main()
