"""Pieces the cell drivers share: the set-up log, the render cache, weights
drawn on the device, and the device's facts for the result line."""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(HERE, ".cache")


class SetupLog:
    """Seconds of each set-up stage, in order, for the run's earlier output
    line (`setup_breakdown`)."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self.notes: dict[str, object] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the caches: benchmark/.cache/<kind>/<hash of what the entry depends on><ext>


def cache_path(key: dict, kind: str = "renders", ext: str = ".npz") -> str:
    digest = hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:20]
    return os.path.join(CACHE_DIR, kind, f"{digest}{ext}")


def load_or_render(drive) -> bool:
    """Fill drive.frames from the cache, or render them and store them.
    Returns True on a cache hit."""
    path = cache_path(drive.cache_key())
    if os.path.exists(path):
        with np.load(path) as z:
            drive.frames = [tuple(f) for f in z["frames"]]
        return True
    drive.render()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {"frames": np.stack([np.stack(f) for f in drive.frames])}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return False


# ---------------------------------------------------------------------------
# device facts for the result line


def device_facts(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def nvidia_smi() -> str | None:
    """The card's name, power limit, clocks and draw, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
