"""Host bookkeeping of the tracker per frame: the `track_pack` spans (the
last frame's and the local map's point packs and their upload) and the
`track_apply` spans (pose acceptance, stats, the keyframe decision and
creation) summed over the untraced part of the window, over its frames
(`track` spans), in ms; absent where neither opened there."""


def read(run):
    spans = run.untraced("track_pack") + run.untraced("track_apply")
    frames = run.untraced("track")
    return 1e3 * sum(spans) / len(frames) if spans and frames else None
