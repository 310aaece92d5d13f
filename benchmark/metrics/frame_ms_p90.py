"""The 90th percentile of every frame's time in the window (its track
call, a drive's final flush timed into its last frame), in ms."""

from benchmark.metrics._common import percentile


def read(run):
    frames = getattr(run.cell, "frames_s", None)
    return 1e3 * percentile(frames, 90.0) if frames else None
