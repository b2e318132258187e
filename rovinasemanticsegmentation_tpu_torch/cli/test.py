"""Single-label evaluation CLI (parity with semantic_segmentation_test).

Usage: python -m rovinasemanticsegmentation_tpu_torch.cli.test \
           --conf <config file> [--device cuda|cpu] [--key value ...]
(src/test.cpp:35-231 of the C++ system)
"""

import sys

from .evaluate import config_and_device, run_evaluation


def main(argv=None):
    """Run the evaluation; returns the per-layer confusion accumulators."""
    conf, device = config_and_device(sys.argv[1:] if argv is None else argv)
    return run_evaluation(conf, multi=False, device=device)


if __name__ == "__main__":
    main()
