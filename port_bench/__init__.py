"""The benchmark of the PyTorch and CUDA port (``rovinasemanticsegmentation_tpu_torch``).

One run of one cell, from the root of a checkout on a machine with an
NVIDIA card::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cells; everything that belongs to one
configuration, traffic mix, driver or per-layer metric is a file of its own
here, found by its name:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix, naming its driver;
- ``drivers/<driver>.py``: what drives the port under that traffic;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``metrics/<metric>.py``: the reader of one per-layer metric, or where there
  is none, ``metrics/<quantity>.py``, the reader of the part of its name
  before the first dot (``device_idle_share.stream`` and
  ``device_idle_share.online`` share ``device_idle_share.py``).

The yardstick stays here, where the port cannot move it: the generators
(``gen.py``), the roofline and step arithmetic (``roofline.py``), the
reduction of profiler traces (``trace.py``) and the plain reference
(``reference/``), which imports nothing of the port.
"""
