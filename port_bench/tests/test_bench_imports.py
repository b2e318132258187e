"""What the harness loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package's (compared whole: the port's name
begins with it), and from ``reference/`` nothing of the port either."""

import os
import subprocess
import sys

from port_bench import harness

RUN_A_CELL = """
import json, sys, time
from port_bench import harness
from port_bench.tests.tiny import tiny_spec, SEED
for name in ("stream_crf10_b10", "online_nocrf"):
    harness.measure(tiny_spec(name), SEED, 0.5, False, "cpu", time.perf_counter())
for name in ("stream_crf10_b10", "online_nocrf"):
    for m in harness.reported(tiny_spec(name), True):
        harness.reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCE = """
import json, sys
import port_bench.reference.frame, port_bench.reference.fusion, port_bench.reference.lattice
import port_bench.gen, port_bench.roofline, port_bench.trace
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


def tops(modules):
    return {m.split(".")[0] for m in modules}


def test_a_run_loads_no_jax():
    modules = loaded(RUN_A_CELL)
    assert not tops(modules) & set(harness.FORBIDDEN)
    assert "rovinasemanticsegmentation_tpu_torch" in tops(modules)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "rovinasemanticsegmentation_tpu_torch_x",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rovinasemanticsegmentation_tpu.utils",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert harness.forbidden_modules() == ["jaxlib", "rovinasemanticsegmentation_tpu.utils"]


def test_reference_loads_nothing_of_the_port():
    found = tops(loaded(LOAD_REFERENCE))
    assert not found & {"rovinasemanticsegmentation_tpu_torch", *harness.FORBIDDEN}
