"""Share of the traced section in which no activity ran on the device, in %:
1 - (union of the device activities' intervals under ``torch.profiler``) /
(the same section's wall on the host's clock, run just before without the
profiler)."""


def read(data):
    idle = data.idle_share()
    return None if idle is None else 100.0 * idle
