"""chip_smoke.py's phases at a tiny size on the CPU.

The script insists on a GPU only in ``main()``; its phases take their sizes
as arguments, so the device gate, the basin runs, the plain-path timing
helpers, the correctness checks and the sharded comparison are rehearsed
here with the CPU standing in for the card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def test_device_gate_rejects_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.require_gpu(jax.devices("cpu"))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.require_gpu([])


def test_hbm_peak_unknown_kind_is_an_error():
    with pytest.raises(KeyError):
        cs.hbm_peak("cpu")
    peak, source = cs.hbm_peak("NVIDIA H100 80GB HBM3")
    assert peak == 3.35e12 and source


@pytest.mark.gpu
def test_device_gate_accepts_the_card(gpu_device):
    kind = cs.require_gpu([gpu_device])
    assert cs.hbm_peak(kind)[0] > 0


def test_seeded_basin_is_unstructured(tmp_path):
    from shud_tpu.core.mesh import build_mesh

    inp = cs.seeded_basin(24, 24, with_lake=True, interval=360,
                          outdir=str(tmp_path))
    md = build_mesh(inp)
    assert md.num_ele == 1152 and md.num_lake == 1
    assert md.roll_offsets is None  # P1 runs the generic gather
    assert inp.paths.outpath == str(tmp_path)
    cs_ = inp.control
    assert all(getattr(cs_, k) == 360 for k in vars(cs_)
               if k.startswith("dt_"))


def test_streamed_bytes():
    def f(a, b, c):
        return jnp.sin(a) * 2.0  # b and c unused

    a = jnp.ones(10, jnp.float32)
    b = jnp.ones(100, jnp.float64)
    assert cs.streamed_bytes(f, a, b, b) == 40 + 40
    y, jvp = jax.linearize(lambda x: jnp.sin(x) * x, jnp.ones(5))
    # residuals of the tangent program + v + J·v, all [5] f64
    n = cs.streamed_bytes(jvp, jnp.ones(5))
    assert n % 40 == 0 and n >= 3 * 40


def test_p1_and_p4_tiny(tmp_path):
    """P1's f64/f32 runs through run_project_fast and every P4 check, with
    the CPU standing in for the card."""
    cpu = jax.devices("cpu")[0]
    out = str(tmp_path)
    res = cs.phase_basins(6, 4, True, 2.0, 720, "T", outdir=out)
    for tag in ("f64", "f32"):
        r = res[tag]
        assert r["days"] == 2.0 and np.isfinite(r["y"]).all()
        assert r["nfe"] > 0 and r["warm_s_per_day"] > 0
        assert len(r["residual_relative"]) == 4
        assert os.path.exists(os.path.join(out, f"T_{tag}",
                                           "synthetic.eleygw.dat"))
    md = res["f64"]["sim"].md
    checks = cs.Checks()
    cs.check_f32(checks, "T", md, res["f64"]["y"], res["f32"]["y"],
                 report_only={"riv": "reported only"})
    tight = cs.tight_pair(lambda: cs.seeded_basin(6, 4, with_lake=True,
                                                  end_day=0.5, outdir=out),
                          1e-6, days=0.5)
    cs.check_f32(checks, "T tight", md, tight["f64"], tight["f32"])
    cs.check_rhs_jv(checks, cs.seeded_basin(6, 4, with_lake=True,
                                            outdir=out),
                    res["f64"]["y"], "T", cpu, cpu)
    same = cs.check_trajectory(
        checks, lambda: cs.seeded_basin(6, 4, with_lake=True, end_day=1.0,
                                        outdir=out), cpu, cpu)
    assert same
    assert checks.failed == []
    cs.checksums("T", md, res["f64"]["y"])


def test_checks_collect_failures(capsys):
    checks = cs.Checks()
    checks.check("inside", 1e-10, 1e-9)
    checks.check("outside", 1e-3, 1e-9)
    assert checks.failed == ["outside"]
    assert "[FAIL] outside" in capsys.readouterr().out


def test_plain_timing_tiny(tmp_path):
    inp = cs.seeded_basin(6, 4, with_lake=True, outdir=str(tmp_path))
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.driver.init import initial_state

    y = initial_state(inp, build_mesh(inp))
    for fd in (jnp.float64, jnp.float32):
        r = cs.phase_plain_timing(inp, y, "T", fd, peak=1e11)
        bpc = r["bytes_per_cell_per_eval"]
        # at least the state in and dY out, in the run's precision
        item = jnp.dtype(fd).itemsize
        assert bpc["rhs"] >= 2 * 3 * item and bpc["jv"] >= 2 * 3 * item
        assert r["rhs_s"] > 0 and r["jv_s"] > 0 and r["rhs_share"] > 0
