"""Fixtures of the harness's tests (helpers in ``tiny.py``)."""

from port_bench.tests.tiny import card  # noqa: F401
