"""Kernel B's share of its roofline, in %: the least time of a batch's
descent and histogram sum (``roofline.descent_bound_s`` on what the
reference's descent of the traced batches reads) over its mean device time
per launch in the traced window."""


def read(data):
    launches, seconds = data.real.count("forest_descent_kernel")
    if not launches or "descent" not in data.least_s:
        return None
    return 100.0 * data.least_s["descent"] * launches / seconds
