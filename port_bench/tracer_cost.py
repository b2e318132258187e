"""What the port's tracer costs the host when it is on: windows of one cell
alternated in one process, tracing off and on.

    python3 -m port_bench.tracer_cost [--workload stream_crf10_b10] \
        [--pairs 6] [--seconds 10] [--seed 1] [--out cost.jsonl]

One process, on the card: the cell's set-up, then ``--pairs`` pairs of
windows of ``--seconds``, off and on in the order off, on, on, off, off, on,
... (the port's ``utils.profiling.tracing`` switches the tracer, and
``take`` hands its spans over after each window), since the host's speed
swings between processes and drifts within one. One JSON line per window:
keyframes per second, host us per keyframe (the window's wall over its
keyframes: the stream cell is bound by the host's issue) and spans per
keyframe. Then a
summary: the medians off and on, the median of the pairs' differences, and
the cost of one span alone (ns, a tight loop, tracing on and off). Not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

from rovinasemanticsegmentation_tpu_torch.utils.profiling import span, take, tracing

from port_bench import harness


def span_ns(on: bool, n: int = 200000) -> float:
    """ns per ``with span(...)`` in a tight loop, tracing on or off."""
    with tracing(on):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("cost"):
                pass
        t1 = time.perf_counter_ns()
    take()
    return (t1 - t0) / n


def measure(spec, seed: int, seconds: float, pairs: int, device: str, emit=print) -> dict:
    driver = harness.load_module("drivers", spec.traffic["driver"])
    cell = driver.Cell(spec, seed, device)
    rows = {False: [], True: []}
    try:
        order = [k % 4 in (1, 2) for k in range(2 * pairs)]  # off on on off ...
        for on in order:
            take()
            with tracing(on):
                window = cell.window(seconds)
            spans = take()
            info = window["info"]
            kf = window["keyframes"]
            row = {"tracing": on, "keyframes": kf, "seconds": info["seconds"],
                   "keyframes_per_s": kf / info["seconds"],
                   "host_us_per_kf": 1e6 * info["seconds"] / kf,
                   "spans_per_kf": len(spans) / kf}
            rows[on].append(row)
            emit(json.dumps({"window": row}))
    finally:
        cell.release()

    def med(on, key):
        return statistics.median(r[key] for r in rows[on])

    diffs = [b["host_us_per_kf"] - a["host_us_per_kf"] for a, b in zip(rows[False], rows[True])]
    return {"workload": spec.cell["name"], "pairs": pairs, "seconds": seconds,
            "keyframes_per_s": {"off": med(False, "keyframes_per_s"),
                                "on": med(True, "keyframes_per_s")},
            "host_us_per_kf": {"off": med(False, "host_us_per_kf"),
                               "on": med(True, "host_us_per_kf")},
            "host_us_per_kf_on_less_off": {"median": statistics.median(diffs), "pairs": diffs},
            "spans_per_kf": med(True, "spans_per_kf"),
            "span_ns": {"off": span_ns(False), "on": span_ns(True)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="stream_crf10_b10")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    lines = []

    def emit(text):
        print(text, flush=True)
        lines.append(text)

    summary = measure(harness.load_spec(args.workload), args.seed, args.seconds,
                      args.pairs, "cuda", emit)
    emit(json.dumps({"tracer_cost": summary}))
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
