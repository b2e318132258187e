"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for (without them: an error and exit code 3, no result). The run
makes its inputs from ``--seed``, builds and warms up the port for the
cell's own shapes (``setup_s``, from the start of this process), then:

- ``--trace 0``: measures for ``--seconds``, with the card's activities
  recorded over the whole window, and reports the cell's end-to-end
  metrics;
- ``--trace 1``: measures an untraced window on the host's clock, then
  drives a short traced section under ``torch.profiler``, and reports the
  cell's per-layer metrics, with ``busy_s``, ``window_s`` and a breakdown.

Then it reads the peak device memory, frees the port's state, and holds what
the timed path produced against the plain reference (``reference/``); each
number compared is printed beside its limit, as the last lines on standard
error and under ``checks``, the last key of the result. The last line of
standard output is the result. A run in which ``jax``, ``jaxlib``, ``flax``
or the JAX package was imported exits with code 4 and prints no result.
"""

import time

T_START = time.perf_counter()  # noqa: E402 - set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from port_bench import harness  # noqa: E402


def card_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"not read ({err})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs()
    import torch

    spec = harness.load_spec(args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} NVIDIA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    card = card_power_limit()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": card}), flush=True)
    result, checks = harness.measure(spec, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were imported: {found}",
              file=sys.stderr)
        return 4
    result["device"]["power_limit"] = card
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # No interpreter teardown after the result: the port's finalizers may log
    # to standard error, whose last lines are the checks.
    os._exit(code)
