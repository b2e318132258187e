"""Device ms per keyframe of the frame path: the activities that start inside
the harness's span around ``SingleFramePipeline.run_batch_stacked`` in the
one-thread replay of the traced batches."""

from port_bench.drivers.stream import FRAME_SPAN


def read(data):
    spans = data.replay.span_totals() if data.replay else {}
    if FRAME_SPAN not in spans or not data.keyframes:
        return None
    return 1000.0 * spans[FRAME_SPAN][0] / data.keyframes
