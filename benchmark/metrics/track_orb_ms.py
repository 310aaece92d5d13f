"""Host time of the tracker's ORB extraction per frame: the `track_orb`
spans (both images' pyramids, K2's enqueue, NMS, orientation, descriptors)
summed over the untraced part of the window, over its frames (`track`
spans), in ms; absent where `track_orb` never opened there."""


def read(run):
    spans, frames = run.untraced("track_orb"), run.untraced("track")
    return 1e3 * sum(spans) / len(frames) if spans and frames else None
