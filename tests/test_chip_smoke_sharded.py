"""chip_smoke.py's --cards phase on 4 virtual CPU devices (its own file, so
that the parallel test run schedules it beside the other phases)."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def test_sharded_phase_tiny(tmp_path):
    """The --cards path on 4 virtual CPU devices: sharded driver vs the
    single-device driver, the sharded RHS, and a short profiler trace."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    checks = cs.Checks()
    cs.phase_sharded(checks, 8, 4, 4, days=0.25, interval=180,
                     outdir=str(tmp_path), trace_windows=1)
    assert checks.failed == []
