"""A/B timing of the PyTorch port's kernel K1 (the fused DeepSDF value +
input gradient, dspslam_tpu_torch/csrc/decoder_fused.cu) against other
versions of it, in one process on one CUDA card.

    python tools/compare_k1.py OTHER [OTHER ...]

Each OTHER is a directory holding another version's
`dspslam_tpu_torch/kernels` and `dspslam_tpu_torch/csrc`, for example a
parent commit's (`git archive <commit> dspslam_tpu_torch/kernels
dspslam_tpu_torch/csrc | tar -x -C OTHER`) or a copy with one constant
changed, in a directory .gitignore lists. Its kernels package is imported
under another name and timed through its own wrapper, which builds its own
K1 there. The turns run forward and then backward (this tree, the others,
the others reversed, this tree); each prints the mean of 20 launches by
CUDA events at N = 2048 and 8192, the reconstruction GN's two sizes, and
the sdf error against the plain version. Every version gets its own copy of
the weights, since each wrapper caches its packed operands on them.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dspslam_tpu_torch.kernels import decoder_fused  # noqa: E402
from dspslam_tpu_torch.models import deepsdf  # noqa: E402


def _other_wrapper(root: str, alias: str):
    kernels = os.path.join(os.path.abspath(root), "dspslam_tpu_torch", "kernels")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(kernels, "__init__.py"), submodule_search_locations=[kernels])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.decoder_fused").sdf_and_input_grad


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if not args:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("compare_k1: needs a CUDA card")
    versions = {"this": decoder_fused.sdf_and_input_grad}
    for i, root in enumerate(args):
        versions[root] = _other_wrapper(root, f"other_kernels_{i}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    dims = deepsdf.DecoderConfig().layer_dims()
    params = {
        "w": [(rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(np.float32) for i, o in dims],
        "b": [(rng.normal(size=(o,)) * 0.05).astype(np.float32) for _, o in dims],
    }
    decs = {name: deepsdf.params_from_jax(params, device="cuda") for name in versions}
    for n in (2048, 8192):
        x = torch.from_numpy((rng.normal(size=(n, 67)) * 0.3).astype(np.float32)).cuda()
        dec = decs["this"]
        sdf_ref, _ = decoder_fused.sdf_and_input_grad_plain(list(dec.weights), list(dec.biases), x)
        times = {name: [] for name in versions}
        for name in list(versions) + list(versions)[::-1]:
            w, b = list(decs[name].weights), list(decs[name].biases)
            times[name].append(_ms(lambda: versions[name](w, b, x)))
        for name, fn in versions.items():
            w, b = list(decs[name].weights), list(decs[name].biases)
            err = float((fn(w, b, x)[0] - sdf_ref).abs().max())
            print(f"K1 N={n} {name}: {np.mean(times[name]):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times[name])}), sdf err {err:.2e}")


if __name__ == "__main__":
    main()
