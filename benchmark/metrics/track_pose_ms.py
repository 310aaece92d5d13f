"""Host time of the tracker's motion-only pose optimisations per frame: the
`pose_opt` spans (slam/pose_opt.py, two per fused frame) summed over the
untraced part of the window, over its frames (`track` spans), in ms;
absent where `pose_opt` never opened there."""


def read(run):
    spans, frames = run.untraced("pose_opt"), run.untraced("track")
    return 1e3 * sum(spans) / len(frames) if spans and frames else None
