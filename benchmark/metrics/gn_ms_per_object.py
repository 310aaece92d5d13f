"""The window's time over the objects reconstructed (each batched call
ends when its result is on the host), in ms."""


def read(run):
    objects = getattr(run.cell, "objects", 0)
    if not isinstance(objects, int) or objects <= 0:
        return None
    return 1e3 * run.window_s / objects
