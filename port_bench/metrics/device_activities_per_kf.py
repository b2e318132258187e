"""Device activities (kernels, copies, sets) in the traced window per
keyframe that finished in it: what the host issues for one keyframe."""


def read(data):
    if not data.real.device or not data.keyframes:
        return None
    return len(data.real.device) / data.keyframes
