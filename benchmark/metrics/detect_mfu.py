"""Both detectors' share of the card's peak while a keyframe's detection
runs, in %: the operations of one Mask R-CNN and one PointPillars call
(counted from the configuration's shapes, benchmark/detflops.py) times the
`detect` spans of the window's untraced part, over those spans' time,
against 989 TFLOP/s (dense BF16, the card's highest rate that either
network's arithmetic could use)."""

from benchmark import detflops


def read(run):
    spans = run.untraced("detect")
    det = run.config.get("detection", {})
    if run.device.type != "cuda" or not spans or "detector_2d" not in det:
        return None
    cam = run.config["camera"]
    per_call = detflops.keyframe_flops(det["detector_2d"], det["detector_3d"], (cam["height"], cam["width"]))
    return 100.0 * per_call * len(spans) / sum(spans) / detflops.PEAK_BF16_FLOPS
