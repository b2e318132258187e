"""The 95th percentile, over every map due in the untraced window that a
traced run makes first, of the time from the map's due time to its labels
served, in ms, on the host's clock."""


def read(data):
    return data.window.get("metrics", {}).get("map_latency_p95_ms")
