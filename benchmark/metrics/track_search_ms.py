"""Host time of the tracker's matching per frame: the `track_stereo` span
(stereo matching) and the two `track_search` spans (projection search and
conflict resolution) summed over the untraced part of the window, over its
frames (`track` spans), in ms; absent where neither opened there."""


def read(run):
    spans = run.untraced("track_stereo") + run.untraced("track_search")
    frames = run.untraced("track")
    return 1e3 * sum(spans) / len(frames) if spans and frames else None
