"""Train a BoW vocabulary from sequence images.

Port of dspslam_tpu/apps/train_vocabulary.py. The reference ships a
pretrained DBoW2 ORBvoc for OpenCV's BRIEF pattern; this framework's pattern
differs (frontend.orb_pattern), so vocabularies are trained per deployment
(the reference's ORBvoc loads with Vocabulary.load_any and extraction with
ORBParams(pattern="reference")). Each image goes through the port's ORB on
`--device` (on the card, one FAST score-map launch of kernel K2 per image),
then `Vocabulary.train` runs the host k-medians.

Default K = 10, L = 5 (10^5 words): at 2100-keyframe scale this widens the
true-revisit / novel-place score margin 1.66x -> 2.56x and speeds up
database queries against 10^4 words (docs/vocab_scale.md). The corpus
should hold at least ~3 descriptors per word; the CLI warns when it is
thinner (use --levels 4 for short indoor sequences).

    python -m dspslam_tpu_torch.apps.train_vocabulary --image_dir <dir of pngs> \\
        --output voc.npz [--stride 10] [--branching 10] [--levels 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..frontend import orb
from ..place.vocabulary import Vocabulary
from ..slam.map import entry_device
from ..utils import io as io_mod

GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def image_descriptors(path: str, params: orb.ORBParams, device) -> np.ndarray:
    """The valid ORB descriptors (n, 8) uint32 of one image file."""
    img = io_mod.load_image_rgb(path).astype(np.float32) @ GRAY
    feats = orb.extract(torch.from_numpy(np.ascontiguousarray(img)).to(device), params)
    valid = feats["valid"].cpu().numpy() > 0
    return feats["desc"].cpu().numpy().view(np.uint32)[valid]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", required=True)
    p.add_argument("--output", default="voc.npz")
    p.add_argument("--stride", type=int, default=10)
    p.add_argument("--branching", type=int, default=10)
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--max_images", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = entry_device(args.device, "train_vocabulary")

    files = sorted(f for f in os.listdir(args.image_dir) if f.endswith((".png", ".jpg")))
    files = files[:: args.stride][: args.max_images]
    params = orb.ORBParams()
    descs = []
    for f in files:
        descs.append(image_descriptors(os.path.join(args.image_dir, f), params, device))
        print(f"{f}: {len(descs[-1])} descriptors")
    all_descs = np.concatenate(descs)
    n_words = args.branching ** args.levels
    if len(all_descs) < 3 * n_words:
        print(f"warning: corpus has {len(all_descs)} descriptors for {n_words} words (<3/word): word cells "
              "will be underfit; add images (--stride / --max_images) or drop --levels")
    voc = Vocabulary.train(all_descs, args.branching, args.levels, device=device)
    voc.save(args.output)
    print(f"trained {voc.n_words}-word vocabulary from {len(all_descs)} descriptors -> {args.output}")
    return voc


if __name__ == "__main__":
    main()
