"""Frames tracked per second: every frame of the window over the whole
window, each drive's system construction and final flush included."""


def read(run):
    frames = getattr(run.cell, "frames_s", None)
    if not frames or run.window_s <= 0:
        return None
    return len(frames) / run.window_s
