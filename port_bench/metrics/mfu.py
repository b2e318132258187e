"""The whole keyframe step's share of the card's published peaks, in %: the
least time of one keyframe's stages plus a fifth of a map
(``roofline.keyframe_stages`` and ``roofline.map_stages``) over the wall
time per keyframe of the traced section, run without the profiler."""


def read(data):
    if "step" not in data.least_s or not data.keyframes or data.wall_s <= 0:
        return None
    return 100.0 * data.least_s["step"] / (data.wall_s / data.keyframes)
