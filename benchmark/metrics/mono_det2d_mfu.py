"""Mask R-CNN's share of the card's peak while a mono keyframe's online
detection runs, in %: the operations of one call at the configuration's
camera (benchmark/detflops.py; 768 x 1344 padded at Freiburg's 540 x 960)
times the `detect_mono` spans of the window's untraced part, over those
spans' time, against 989 TFLOP/s (dense BF16)."""

from benchmark import detflops


def read(run):
    spans = run.untraced("detect_mono")
    det = run.config.get("detection", {})
    if run.device.type != "cuda" or not spans or "detector_2d" not in det:
        return None
    cam = run.config["camera"]
    per_call = detflops.maskrcnn_flops(det["detector_2d"], (cam["height"], cam["width"]))
    return 100.0 * per_call * len(spans) / sum(spans) / detflops.PEAK_BF16_FLOPS
