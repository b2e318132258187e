"""Read the numbers that decide ``correct`` over many seeds, for the program
and for the control, to set the limits in ``limits/<cell>.json``.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--control-seeds 1,2,3] [--out calibrate.jsonl]

One process, on the card. Per seed of ``--seeds``: the cell's set-up and a
short window at its own load, then ``check()``: the program against the
plain reference. Per seed of ``--control-seeds`` (a subset): the control,
the reference computed in bfloat16 in the program's place on the same
sampled inputs (``check(control=True)``). One JSON line per reading. The
benchmark's own runs never run the control. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import time

from port_bench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.load_spec(args.workload)
    driver = harness.load_module("drivers", spec.traffic["driver"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = driver.Cell(spec, seed, "cuda")
        info = cell.window(args.seconds)["info"]
        cell.release()
        line = {"calibrate": args.workload, "seed": seed, "window": info,
                "program": cell.check()}
        if seed in controls:
            line["control"] = cell.check(control=True)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
