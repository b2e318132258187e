"""Find the online cell's knee: the highest node rate at which the maps'
latency does not grow through the window.

    python3 -m port_bench.sweep --workload online_nocrf --rates 40,60,80 \
        [--seconds 10] [--seed 1] [--out sweep.jsonl]

One process, on the card: per rate a fresh node (the cell's driver with the
rate given), one window of ``--seconds``, and a JSON line with the window's
latencies (p50, p95, max), the generator's lateness, the maps not served,
and ``growth``: the median latency of the window's last third of maps over
that of its first third. A queue that grows through the window reads well
above 1. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import statistics

from port_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="online_nocrf")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.load_spec(args.workload)
    driver = harness.load_module("drivers", spec.traffic["driver"])
    for rate in (float(r) for r in args.rates.split(",")):
        cell = driver.Cell(spec, args.seed, "cuda", rate=rate)
        try:
            info = cell.window(args.seconds)["info"]
            lat = cell.last["latencies"]
            third = max(1, len(lat) // 3)
            info["growth"] = (statistics.median(lat[-third:])
                              / statistics.median(lat[:third]))
            info["latencies_ms"] = [1000 * x for x in lat]
        finally:
            cell.release()
        line = json.dumps({"sweep": args.workload, **info})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
