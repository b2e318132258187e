"""Device ms per local map of the map path (fusion, lattice build, mean
field, labels): the activities that start inside the harness's span around
``LocalMapPipeline.run_device`` in the one-thread replay of the traced
batches."""

from port_bench.drivers.stream import MAP_SPAN


def read(data):
    spans = data.replay.span_totals() if data.replay else {}
    if MAP_SPAN not in spans or not data.maps:
        return None
    return 1000.0 * spans[MAP_SPAN][0] / data.maps
