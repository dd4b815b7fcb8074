"""Driver-level tests: fused vs per-window equivalence, outputs, restart,
water balance, synthetic end-to-end, operator-split agreement."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shud_tpu.diag.waterbalance import WaterBalance
from shud_tpu.driver.fused import FusedSimulation
from shud_tpu.driver.simulate import Simulation
from shud_tpu.io.output import PrintCtrl, read_dat, write_restart
from shud_tpu.utils.synthetic import make_synthetic_project


def test_fused_matches_unfused_ccw():
    """One day of ccw: the fused lax.scan driver must land on the same
    state as the per-window dispatch driver (identical graphs modulo
    re-association)."""
    s1 = Simulation.create("ccw", base="/root/reference")
    s1.run(t_end=1440.0)
    s2 = FusedSimulation.create("ccw", base="/root/reference")
    s2.advance_interval(1440.0)
    d = np.abs(np.asarray(s1.bdf.y) - np.asarray(s2.bdf.y))
    assert d.max() < 1e-8, d.max()
    assert int(s1.bdf.nfe) == int(s2.bdf.nfe)


def test_print_ctrl_roundtrip(tmp_path):
    pc = PrintCtrl(str(tmp_path / "x.eleysurf"), 20000101, interval=60,
                   is_flux=True, num_all=4)
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    for k in range(1, 13):
        pc.push(k * 10.0, vals * k)
    pc.close()
    start, cols, t, data = read_dat(str(tmp_path / "x.eleysurf.dat"))
    assert start == 20000101
    assert list(cols) == [1, 2, 3, 4]
    # left-endpoint timestamps at each hour boundary
    assert list(t) == [0.0, 60.0]
    # interval mean x tau(1440): windows 1..6 -> mean k = 3.5
    assert np.allclose(data[0], vals * 3.5 * 1440.0)
    assert np.allclose(data[1], vals * 9.5 * 1440.0)


def test_restart_roundtrip(tmp_path, ccw):
    inp, md, dm = ccw
    ne, nr = md.num_ele, md.num_riv
    rng = np.random.default_rng(0)
    arrs = [rng.uniform(0, 1, ne) for _ in range(5)] + [rng.uniform(0, 2, nr)]
    path = str(tmp_path / "prj.cfg.ic.update")
    write_restart(path, 1440.0, *arrs[:5], arrs[5])
    from shud_tpu.io.tables import read_tables

    tabs = read_tables(path, 2)
    ele = tabs[0][0]
    riv = tabs[1][0]
    # text format carries 6 decimals (reference parity, %lf)
    for col, ref in zip(range(1, 6), arrs[:5]):
        assert np.abs(ele[:, col] - ref).max() < 1e-6
    assert np.abs(riv[:, 1] - arrs[5]).max() < 1e-6


def test_resume_continues(tmp_path):
    """Write a restart, reload it as .cfg.ic, and verify the state is
    carried (INIT_MODE=3 read path)."""
    import shutil

    src = "/root/reference/input/ccw"
    proj = tmp_path / "input" / "ccw"
    proj.mkdir(parents=True)
    for f in os.listdir(src):
        p = os.path.join(src, f)
        if os.path.isfile(p):
            os.symlink(p, proj / f)
    sim = Simulation.create("ccw", base="/root/reference")
    sim.run(t_end=20.0)
    y = np.asarray(sim.bdf.y)
    ne, nr = sim.md.num_ele, sim.md.num_riv
    (proj / "ccw.cfg.ic").unlink()
    write_restart(
        str(proj / "ccw.cfg.ic"), 20.0,
        np.asarray(sim.buckets.ic_stg), np.asarray(sim.buckets.snow),
        y[:ne], y[ne : 2 * ne], y[2 * ne : 3 * ne], y[3 * ne :],
    )
    sim2 = Simulation.create("ccw", base=str(tmp_path))
    y2 = np.asarray(sim2.bdf.y)
    assert np.abs(y2 - y).max() < 1e-6  # %f text precision


def test_synthetic_end_to_end_mass_balance():
    """The synthetic watershed runs end-to-end and closes the basin water
    balance to a small relative residual."""
    from shud_tpu.core.device import to_device
    from shud_tpu.core.mesh import build_mesh

    inp = make_synthetic_project(12, 6, end_day=2.0)
    md = build_mesh(inp)
    sim = FusedSimulation.create.__func__  # not file-based; build manually
    from shud_tpu.driver.fused import ChunkTables, run_interval
    from shud_tpu.driver.forcing import build_forcing
    from shud_tpu.driver.init import initial_buckets, initial_state
    from shud_tpu.core.landsurface import BucketState
    from shud_tpu.solver.bdf import SolverConfig, bdf_init

    dm = to_device(md)
    fr = build_forcing(inp, md)
    cs = inp.control
    cfg = SolverConfig(rtol=cs.reltol, atol=cs.abstol, h_init=cs.init_step,
                       h_max=cs.max_step)
    tables = ChunkTables(
        fvals=jnp.asarray(fr.fvals), station_z=jnp.asarray(fr.station_z),
        lai_vals=jnp.asarray(fr.lai_vals), mf_vals=jnp.asarray(fr.mf_vals),
        tsr_sx=jnp.asarray(fr.tsr_sx), tsr_sy=jnp.asarray(fr.tsr_sy),
        tsr_sz=jnp.asarray(fr.tsr_sz), tsr_wdt=jnp.asarray(fr.tsr_wdt),
        tsr_den=jnp.asarray(fr.tsr_den),
    )
    y0 = initial_state(inp, md)
    ic0, snow0 = initial_buckets(inp, md)
    bk = BucketState(ic_stg=jnp.asarray(ic0), snow=jnp.asarray(snow0))
    st = bdf_init(0.0, jnp.asarray(y0), cfg)

    wb = WaterBalance(md)
    t = 0.0
    for day in range(2):
        ts = t + np.arange(144) * 10.0
        fi = np.searchsorted(fr.t_axis, ts + 1e-9, "right") - 1
        li = np.zeros(144, np.int32)
        mi = np.zeros(144, np.int32)
        y_before = np.asarray(st.y)
        bk_before = (np.asarray(bk.ic_stg), np.asarray(bk.snow))
        st, bk, _, mean_e, mean_r, _ml, stages, qd = run_interval(
            dm, tables, st, bk, fr.cal, t,
            jnp.asarray(fi, jnp.int32), jnp.asarray(li), jnp.asarray(mi),
            fr.rad_factor_cap, fr.rad_cosz_min, cfg, 144, 10.0,
        )
        mean_e = {k: np.asarray(v) for k, v in mean_e.items()}
        mean_r = {k: np.asarray(v) for k, v in mean_r.items()}
        row = wb.interval(
            t, t + 1440.0, y_before, np.asarray(st.y), mean_e, mean_r,
            buckets0=bk_before,
            buckets1=(np.asarray(bk.ic_stg), np.asarray(bk.snow)),
        )
        t += 1440.0
    # Newton retries happen under the storm pulse (CVODE's ncfn equivalent);
    # what matters is completion and conservation
    assert float(st.t) == 2880.0
    # rain pulse day: budget closes within a few % (flux sampling at window
    # ends vs continuous integral)
    assert abs(row.residual_relative) < 0.05, row


def test_project_file_roundtrip(tmp_path):
    """-p manifest: save_project_file -> read_project_file resolves the
    same input paths (FileIn::saveProject/readProject, IO.cpp:3-292)."""
    from shud_tpu.io.project import FilePaths, read_project_file

    fp = FilePaths.from_project("ccw", base="/root/reference",
                                outpath=str(tmp_path))
    fn = fp.save_project_file()
    fp2 = read_project_file(fn)
    assert fp2.project == "ccw"
    assert fp2.inpath == fp.inpath
    assert fp2.outpath == str(tmp_path)
    for sfx in ("sp.mesh", "cfg.para", "tsd.forc"):
        assert fp2.infile(sfx) == fp.infile(sfx)
    # explicit override of a single file wins over the naming convention
    with open(fn, "a") as f:
        f.write("SOIL \t /elsewhere/other.para.soil\n")
    fp3 = read_project_file(fn)
    assert fp3.infile("para.soil") == "/elsewhere/other.para.soil"
    assert fp3.infile("sp.mesh") == fp.infile("sp.mesh")


def test_per_edge_flux_channels(tmp_path):
    """dt_Qe_subx/surfx emit the six per-edge channels
    prj.eleqsub1..3/eleqsurf1..3 (Model_Control.cpp:460-465,
    MD_initialize.cpp:283-296, names IO.cpp:159-166), and their sum plus
    the river-exchange term reproduces the total-flux channels."""
    from shud_tpu.driver.run_fast import run_project_fast
    from shud_tpu.io.output import read_dat

    inp = make_synthetic_project(8, 4, end_day=1.0)
    inp.control.dt_Qe_subx = 1440
    inp.control.dt_Qe_surfx = 1440
    inp.control.dt_Qe_sub = 1440
    inp.control.dt_Qe_surf = 1440
    inp.control.dt_Qe_rsub = 1440
    inp.control.dt_Qe_rsurf = 1440
    out = str(tmp_path / "syn.out")
    run_project_fast("synthetic", inp=inp, end_day=1.0, verbose=False,
                     outpath=out)
    import os as _os

    per_edge = {}
    for base in ("eleqsub", "eleqsurf"):
        for j in (1, 2, 3):
            path = _os.path.join(out, f"synthetic.{base}{j}.dat")
            assert _os.path.exists(path), path
            _, _, t, data = read_dat(path)
            per_edge[f"{base}{j}"] = data[0]
    _, _, _, tot_sub = read_dat(_os.path.join(out, "synthetic.eleqsub.dat"))
    _, _, _, tot_surf = read_dat(_os.path.join(out, "synthetic.eleqsurf.dat"))
    _, _, _, e2r_sub = read_dat(_os.path.join(out, "synthetic.eleqrsub.dat"))
    _, _, _, e2r_surf = read_dat(
        _os.path.join(out, "synthetic.eleqrsurf.dat"))
    sub_sum = (per_edge["eleqsub1"] + per_edge["eleqsub2"]
               + per_edge["eleqsub3"] + e2r_sub[0])
    surf_sum = (per_edge["eleqsurf1"] + per_edge["eleqsurf2"]
                + per_edge["eleqsurf3"] + e2r_surf[0])
    np.testing.assert_allclose(sub_sum, tot_sub[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(surf_sum, tot_surf[0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", ["env", "checkout", "off"])
def test_compile_cache_wiring(tmp_path, monkeypatch, mode):
    """--compile-cache wires jax's persistent compilation cache:
    $JAX_COMPILATION_CACHE_DIR wins when set (and a compiled program lands
    there), the default is the fixed <checkout>/.jax_cache, and 'off'
    disables the cache."""
    from shud_tpu import cli

    old_dir = jax.config.jax_compilation_cache_dir
    old_on = jax.config.jax_enable_compilation_cache
    cc = str(tmp_path / "cc")
    try:
        if mode == "env":
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cc)
            # the environment wins over an explicit directory
            got = cli.setup_compile_cache(str(tmp_path / "other"),
                                          min_compile_secs=0.0)
            assert got == cc and jax.config.jax_compilation_cache_dir == cc
            jax.jit(lambda x: jnp.sin(x * 3).sum())(
                jnp.arange(4096.0)).block_until_ready()
            assert os.listdir(cc), "no cache entry written"
            assert not os.path.exists(tmp_path / "other")
        elif mode == "checkout":
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            expect = os.path.join(repo, ".jax_cache")
            assert cli.CHECKOUT_CACHE == expect
            got = cli.setup_compile_cache()
            assert got == expect
            assert jax.config.jax_compilation_cache_dir == expect
            assert jax.config.jax_enable_compilation_cache
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", cc)
            assert cli.setup_compile_cache("off") is None
            assert not jax.config.jax_enable_compilation_cache
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_enable_compilation_cache", old_on)


def test_cli_dummy_with_shards(tmp_path):
    """-0 is an IO smoke test in EVERY mode (CommandIn.cpp:195-197): under
    --shards it must still run the dummy pipeline, not a full solve."""
    from shud_tpu.cli import main

    out = str(tmp_path / "d.out")
    main(["-0", "--shards", "2", "-e", "1", "-o", out,
          "-b", "/root/reference", "-q", "ccw"])
    files = os.listdir(out)
    assert "ccw.cfg.ic.bak" in files and "ccw.time.csv" in files
    # no solving happened: no restart snapshot beyond the t=0 backup
    assert "ccw.cfg.ic.update" not in files


def test_cli_split_with_shards_errors():
    """-g --shards must fail loudly (no sharded sub-solver set), not run
    a silently different mode."""
    from shud_tpu.cli import main

    with pytest.raises(SystemExit) as ei:
        main(["-g", "--shards", "2", "-b", "/root/reference", "ccw"])
    assert ei.value.code == 2
    with pytest.raises(SystemExit) as ei2:
        main(["--per-window", "--shards", "2", "-b", "/root/reference",
              "ccw"])
    assert ei2.value.code == 2


@pytest.mark.slow
def test_split_driver_output_parity(tmp_path):
    """A -g run produces the SAME file set as the implicit production
    driver (reference: the -g loop runs the full ExportResults +
    FloodWarning + PrintInit stack every step, shud.cpp:316-323), and its
    state channels agree with the implicit driver's at splitting error."""
    import dataclasses

    from shud_tpu.driver.run_fast import run_project_fast
    from shud_tpu.driver.uncoupled import run_project_split

    def twin():
        inp = make_synthetic_project(12, 6, end_day=0.25, with_lake=True)
        cs = inp.control
        for f in dataclasses.fields(cs):
            if f.name.startswith("dt_") and getattr(cs, f.name):
                setattr(cs, f.name, 360)
        cs.dt_ye_surf = cs.dt_ye_unsat = cs.dt_ye_gw = 360
        cs.dt_Qr_down = cs.dt_yr_stage = cs.dt_lake = 360
        cs.update_ic_step = 360
        return inp

    g_dir = str(tmp_path / "g")
    f_dir = str(tmp_path / "f")
    run_project_split("synthetic", inp=twin(), outpath=g_dir, verbose=False)
    run_project_fast("synthetic", inp=twin(), outpath=f_dir, verbose=False)
    g_files = sorted(os.listdir(g_dir))
    f_files = sorted(os.listdir(f_dir))
    assert g_files == f_files, (
        f"-g file set differs from implicit:\n split={g_files}\n"
        f" implicit={f_files}"
    )
    # state channels agree at splitting error.  Element/river states hold
    # the 5e-3 m split-vs-implicit bound; the lake stage integrates 36
    # windows of frozen-inflow Gauss-Seidel error under the storm pulse
    # (~2.5 cm here, verified superlinear in the window length), so its
    # bound is looser.
    tol = {"eleysurf": 5e-3, "eleygw": 5e-3, "rivystage": 5e-3,
           "lakystage": 5e-2}
    for name, bound in tol.items():
        _, _, tg, dg = read_dat(os.path.join(g_dir, f"synthetic.{name}.dat"))
        _, _, tf, df = read_dat(os.path.join(f_dir, f"synthetic.{name}.dat"))
        assert (tg == tf).all(), name
        assert np.abs(dg - df).max() < bound, (
            name, np.abs(dg - df).max())
    # the -g budget's FLUX columns agree with the implicit driver's; its
    # residual is NOT expected to close — Gauss-Seidel sub-solves see
    # frozen coupling fluxes, so the budget residual IS the splitting
    # non-conservation (here dominated by the lake-stage splitting error:
    # ~2.5 cm x the lake area).  The reference's -g shares this property
    # (and worse: its lake DY is never assembled, MD_f_uncouple.cpp:107).
    rows_g = np.atleast_1d(np.genfromtxt(
        os.path.join(g_dir, "synthetic.wb.basin.csv"), delimiter=",",
        names=True))
    rows_f = np.atleast_1d(np.genfromtxt(
        os.path.join(f_dir, "synthetic.wb.basin.csv"), delimiter=",",
        names=True))
    for col in ("P_m3", "ET_m3", "Qout_m3", "QBC_m3", "QSS_m3"):
        scale = max(10.0, np.abs(rows_f[col]).max())
        assert np.abs(rows_g[col] - rows_f[col]).max() / scale < 0.05, col
    # splitting non-conservation stays bounded by the lake-stage error
    lake_area_m3_per_cm = 240.0  # ~24,000 m2 lake x 1 cm
    assert np.abs(rows_g["residual_m3"]).max() < 5.0 * lake_area_m3_per_cm


@pytest.mark.slow
def test_split_driver_resume(tmp_path):
    """-g runs can be resumed from their binary checkpoint."""
    from shud_tpu.driver.uncoupled import run_project_split

    inp0 = make_synthetic_project(8, 4, end_day=0.5)
    inp0.control.update_ic_step = 360
    full = run_project_split("synthetic", inp=inp0,
                             outpath=str(tmp_path / "full"), verbose=False)
    inp1 = make_synthetic_project(8, 4, end_day=0.5)
    inp1.control.update_ic_step = 360
    run_project_split("synthetic", inp=inp1, end_day=0.25,
                      outpath=str(tmp_path / "half"), verbose=False)
    inp2 = make_synthetic_project(8, 4, end_day=0.5)
    inp2.control.update_ic_step = 360
    res = run_project_split(
        "synthetic", inp=inp2, outpath=str(tmp_path / "res"), verbose=False,
        resume=os.path.join(str(tmp_path / "half"), "synthetic.ckpt.npz"))
    for a, b in ((full.surf, res.surf), (full.gw, res.gw),
                 (full.riv, res.riv)):
        assert np.abs(np.asarray(a.y) - np.asarray(b.y)).max() < 1e-12


@pytest.mark.parametrize(
    "project", ["ccw", pytest.param("qhh", marks=pytest.mark.slow)]
)
def test_split_vs_implicit(project):
    """Operator-split (-g) agrees with the global-implicit driver at
    splitting error over short windows (second-oracle check, SURVEY §3.3).
    On qhh this exercises the real lake sub-solve (the 5th sub-system,
    reference mem5/f_lake at shud.cpp:171-357 — whose f_loop5 is empty in
    the reference; see driver/uncoupled.py module docstring)."""
    from shud_tpu.driver.uncoupled import (
        advance_window_uncoupled,
        init_uncoupled,
    )

    sim = Simulation.create(project, base="/root/reference")
    ne, nr, nl = sim.md.num_ele, sim.md.num_riv, sim.md.num_lake
    t0 = sim.inp.control.start_time
    t_end = t0 + 60.0
    # qhh has one stiff unsat/gw cell whose splitting error at 10-min
    # windows is ~2 cm (halving the window cuts it 7.6x — verified
    # superlinear, i.e. genuine splitting error, not a defect)
    win = 10.0 if project == "ccw" else 5.0
    un = init_uncoupled(np.asarray(sim.bdf.y), ne, nr, t0, sim.cfg, nl=nl)
    t = t0
    while t < t_end - 1e-9:
        fs, _ = sim.forcing_slice(t + win)
        un = advance_window_uncoupled(sim.dm, fs, un, t, t + win, sim.cfg)
        t += win

    s2 = Simulation.create(project, base="/root/reference")
    s2.run(t_end=t_end)
    y_imp = np.asarray(s2.bdf.y)
    parts = [np.asarray(un.surf.y), np.asarray(un.unsat.y),
             np.asarray(un.gw.y), np.asarray(un.riv.y)]
    if nl > 0:
        parts.append(np.asarray(un.lake.y))
    y_spl = np.concatenate(parts)
    assert y_imp.shape == y_spl.shape
    d = np.abs(y_imp - y_spl)
    blocks = dict(surf=d[:ne].max(), unsat=d[ne:2*ne].max(),
                  gw=d[2*ne:3*ne].max(), riv=d[3*ne:3*ne+nr].max())
    if nl > 0:
        blocks["lake"] = d[3*ne+nr:].max()
    assert max(blocks.values()) < 5e-3, blocks
