"""Multi-label evaluation CLI (parity with semantic_segmentation_test_multi).

Usage: python -m rovinasemanticsegmentation_tpu_torch.cli.test_multi \
           --conf <config file> [--device cuda|cpu] [--key value ...]
(src/test_multi.cpp:35-270 of the C++ system)
"""

import sys

from .evaluate import config_and_device, run_evaluation


def main(argv=None):
    """Run the evaluation; returns the per-layer confusion accumulators."""
    conf, device = config_and_device(sys.argv[1:] if argv is None else argv)
    return run_evaluation(conf, multi=True, device=device)


if __name__ == "__main__":
    main()
