"""Kernel A's share of its roofline, in %: its least time per launch
(``roofline.patches_bound_s`` on the reference's depth grids of the traced
keyframes) over its mean device time per launch in the traced window."""


def read(data):
    launches, seconds = data.real.count("patches_kernel")
    if not launches or "patches" not in data.least_s:
        return None
    return 100.0 * data.least_s["patches"] * launches / seconds
