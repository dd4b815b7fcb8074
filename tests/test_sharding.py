"""Sharded (8 virtual devices) vs single-device equivalence.

The replacement for a race detector (SURVEY §5.2): determinism by
construction, checked by comparing the domain-decomposed RHS against the
single-device RHS to reduction-order round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shud_tpu.core.rhs import rhs
from shud_tpu.core.state import ForcingSlice
from shud_tpu.parallel.partition import (
    build_sharded_mesh,
    riv_blocks,
    shard_state,
    unshard_state,
)
from shud_tpu.parallel.sharded import make_sharded_rhs


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def _random_fs(rng, ne, nr):
    return dict(
        net_prcp=rng.uniform(0, 2e-5, ne), prcp=rng.uniform(0, 2e-5, ne),
        pot_evap=rng.uniform(0, 3e-6, ne), pot_tran=rng.uniform(0, 3e-6, ne),
        e_ic=rng.uniform(0, 2e-6, ne), lai=rng.uniform(0, 4, ne),
        fu_surf=np.ones(ne), fu_sub=np.ones(ne),
        ele_ybc=np.zeros(ne), ele_qbc=np.zeros(ne), ele_qss=np.zeros(ne),
        riv_ybc=np.zeros(nr), riv_qbc=np.zeros(nr),
    )


def test_sharded_rhs_equivalence(ccw, eight_devices):
    inp, md, dm = ccw
    ne, nr = md.num_ele, md.num_riv
    rng = np.random.default_rng(3)
    sf = rng.uniform(-0.001, 0.02, ne)
    us = rng.uniform(0, 0.5, ne) * md.aq_depth
    gw = rng.uniform(0, 1.2, ne) * md.aq_depth
    rv = rng.uniform(0, 2.0, nr)
    y = np.concatenate([sf, us, gw, rv])
    fsargs = _random_fs(rng, ne, nr)
    fs = ForcingSlice(**{k: jnp.asarray(v) for k, v in fsargs.items()})
    dy_ref = np.asarray(rhs(dm, fs, 0.0, jnp.asarray(y)))

    sm = build_sharded_mesh(md, 8)
    mesh, rhs_fn, params = make_sharded_rhs(sm)
    ys = {k: jnp.asarray(v) for k, v in shard_state(sm, y).items()}

    def blocks(v):
        buf = np.zeros((sm.p, sm.np_cells))
        buf[sm.old_to_shard, sm.old_to_slot] = v
        return jnp.asarray(buf)

    fs_cell = {k: blocks(fsargs[k]) for k in (
        "net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic", "lai",
        "fu_surf", "fu_sub", "ele_ybc", "ele_qbc", "ele_qss",
    )}
    fs_riv = {"riv_ybc": jnp.asarray(riv_blocks(sm, np.zeros(nr))),
              "riv_qbc": jnp.asarray(riv_blocks(sm, np.zeros(nr)))}
    dy_sh = rhs_fn(0.0, ys, params + (fs_cell, fs_riv))
    flat = unshard_state(sm, {k: np.asarray(v) for k, v in dy_sh.items()})
    assert np.abs(flat - dy_ref).max() < 1e-12


def test_dryrun_multichip(eight_devices):
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_sharded_rhs_equivalence_lakes(qhh, eight_devices):
    """Lake watershed (qhh): the domain-decomposed RHS (lake cells sharded,
    lake stage replicated, per-lake reductions psum'd) matches the
    single-device RHS."""
    inp, md, dm = qhh
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    rng = np.random.default_rng(7)
    sf = rng.uniform(-0.001, 0.02, ne)
    us = rng.uniform(0, 0.5, ne) * md.aq_depth
    gw = rng.uniform(0, 1.2, ne) * md.aq_depth
    rv = rng.uniform(0, 2.0, nr)
    lk = rng.uniform(0, 5.0, nl)
    y = np.concatenate([sf, us, gw, rv, lk])
    fsargs = _random_fs(rng, ne, nr)
    fs = ForcingSlice(**{k: jnp.asarray(v) for k, v in fsargs.items()})
    dy_ref = np.asarray(rhs(dm, fs, 0.0, jnp.asarray(y)))

    sm = build_sharded_mesh(md, 8)
    mesh, rhs_fn, params = make_sharded_rhs(sm)
    ys = {k: jnp.asarray(v) for k, v in shard_state(sm, y).items()}

    def blocks(v):
        buf = np.zeros((sm.p, sm.np_cells))
        buf[sm.old_to_shard, sm.old_to_slot] = v
        return jnp.asarray(buf)

    fs_cell = {k: blocks(fsargs[k]) for k in (
        "net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic", "lai",
        "fu_surf", "fu_sub", "ele_ybc", "ele_qbc", "ele_qss",
    )}
    fs_riv = {"riv_ybc": jnp.asarray(riv_blocks(sm, np.zeros(nr))),
              "riv_qbc": jnp.asarray(riv_blocks(sm, np.zeros(nr)))}
    dy_sh = rhs_fn(0.0, ys, params + (fs_cell, fs_riv))
    flat = unshard_state(sm, {k: np.asarray(v) for k, v in dy_sh.items()})
    assert np.abs(flat - dy_ref).max() < 1e-10


@pytest.mark.slow
def test_sharded_multiwindow_trajectory():
    """ShardedSimulation (multi-window, persistent BDF state over 4 shards)
    vs the single-device driver over the same 6 windows."""
    import jax.numpy as jnp

    from shud_tpu.driver.simulate import Simulation
    from shud_tpu.parallel.runtime import ShardedSimulation
    from shud_tpu.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(16, 8, end_day=1.0)
    from shud_tpu.core.mesh import build_mesh

    md = build_mesh(inp)
    ssim = ShardedSimulation(inp, md, p=4)

    # single-device twin built from an identical in-memory project
    inp2 = make_synthetic_project(16, 8, end_day=1.0)
    from shud_tpu.core.device import to_device
    from shud_tpu.core.landsurface import BucketState
    from shud_tpu.driver.forcing import build_forcing
    from shud_tpu.driver.init import initial_buckets, initial_state
    from shud_tpu.solver.bdf import SolverConfig, bdf_init

    md2 = build_mesh(inp2)
    cs = inp2.control
    cfg = SolverConfig(rtol=cs.reltol, atol=cs.abstol,
                       h_init=cs.init_step, h_max=cs.max_step)
    ic0, snow0 = initial_buckets(inp2, md2)
    s1 = Simulation(inp=inp2, md=md2, dm=to_device(md2),
                    fr=build_forcing(inp2, md2), cfg=cfg,
                    bdf=bdf_init(cs.start_time,
                                 jnp.asarray(initial_state(inp2, md2)), cfg),
                    buckets=BucketState(ic_stg=jnp.asarray(ic0),
                                        snow=jnp.asarray(snow0)),
                    t=cs.start_time)

    for w in range(6):
        tout = (w + 1) * 10.0
        ssim.advance_window(tout)
        s1.advance_window(tout)

    y_sh = ssim.y_full()
    y_sd = np.asarray(s1.bdf.y)
    d = np.abs(y_sh - y_sd).max()
    assert d < 1e-5, f"sharded vs single-device trajectory diverged: {d}"


def test_undersized_device_mesh_fails_fast(ccw, monkeypatch):
    """A partition with more shards than visible devices must fail with an
    actionable error at build time, not an opaque ppermute error at solve
    time (a 1-device mesh asked to run a 4-way exchange schedule)."""
    import shud_tpu.parallel.sharded as shmod

    _inp, md, _dm = ccw
    sm = build_sharded_mesh(md, 4)
    one = jax.devices()[:1]
    monkeypatch.setattr(shmod.jax, "devices", lambda *a, **k: one)
    with pytest.raises(ValueError, match="4 shards but only 1"):
        make_sharded_rhs(sm)


def _bc_cryo_project():
    """Synthetic watershed with every BC/SS class active and cryosphere on
    (the configuration the sharded runtime used to silently ignore —
    VERDICT r3 'What's missing' 1-2; reference semantics
    MD_update.cpp:102-189 + MD_ET.cpp:301-311)."""
    from shud_tpu.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(16, 8, end_day=1.0)
    # cold forcing: partial surface freezing under the default calib ramp
    # (surf_max=-1, surf_min=-5 -> fu_surf = 0.5 at -3 C)
    inp.forc.data[0][:, 1] = -3.0
    inp.att[10, 6] = 1    # element head (Dirichlet) BC, series column 1
    inp.att[40, 6] = -1   # element flux (Neumann) BC, column 1
    inp.att[70, 7] = 1    # element source/sink series, column 1
    inp.riv[2, 5] = 1     # river stage BC
    inp.riv[5, 5] = -1    # river flux BC
    bt = np.array([0.0, 720.0])
    inp.bc = {
        "ele_y": (bt, np.array([[6.0], [6.5]])),
        "ele_q": (bt, np.array([[0.05], [0.02]])),
        "ele_ss": (bt, np.array([[0.03], [0.06]])),
        "riv_y": (bt, np.array([[0.8], [0.6]])),
        "riv_q": (bt, np.array([[0.2], [0.1]])),
    }
    inp.control.cryosphere = 1
    return inp


def test_sharded_bc_cryo_trajectory(eight_devices):
    """Physics parity of the multi-chip path: ShardedSimulation over 4
    shards vs the single-chip fused driver on a project WITH BC/SS time
    series and cryosphere enabled — the configurations the sharded runtime
    previously hardcoded to zeros/ones."""
    from shud_tpu.core.mesh import build_mesh
    from shud_tpu.driver.fused import FusedSimulation
    from shud_tpu.parallel.runtime import ShardedSimulation

    inp = _bc_cryo_project()
    md = build_mesh(inp)
    ssim = ShardedSimulation(inp, md, p=4)
    assert ssim.cryo is not None

    fsim = FusedSimulation.create("syn", inp=_bc_cryo_project())
    for w in range(6):
        ssim.advance_window((w + 1) * 10.0)
    fsim.advance_interval(60.0)

    y_sh = ssim.y_full()
    y_sd = np.asarray(fsim.bdf.y)
    d = np.abs(y_sh - y_sd).max()
    assert d < 1e-5, f"sharded vs fused BC+cryo trajectory diverged: {d}"

    # the BC/cryo inputs actually took effect (this must not be a
    # zeros-vs-zeros comparison): an identical run with the BC series
    # zeroed and cryosphere off lands on a materially different state
    inp0 = _bc_cryo_project()
    inp0.control.cryosphere = 0
    inp0.forc.data[0][:, 1] = 15.0
    for k in inp0.bc:
        ts, vals = inp0.bc[k]
        inp0.bc[k] = (ts, np.zeros_like(vals))
    md0 = build_mesh(inp0)
    ssim0 = ShardedSimulation(inp0, md0, p=4)
    for w in range(6):
        ssim0.advance_window((w + 1) * 10.0)
    assert np.abs(y_sh - ssim0.y_full()).max() > 1e-3, \
        "BC series + cryosphere had no effect on the sharded trajectory"

    # head-BC semantics: dgw=0 at the Dirichlet cell (MD_update.cpp), so
    # its state coordinate stays at the IC while the basin drains
    ne = md.num_ele
    from shud_tpu.driver.init import initial_state

    y0 = initial_state(inp, md)
    assert abs(y_sh[2 * ne + 10] - y0[2 * ne + 10]) < 1e-12
    # frozen fractions reached the sharded RHS: fu_surf < 1 after window 1
    fs_cell, _, _, _ = __import__(
        "shud_tpu.parallel.runtime", fromlist=["compute_forcing_blocks"]
    ).compute_forcing_blocks(
        inp, md, ssim.sm, ssim.t, ssim.t + 10.0, buckets=ssim.buckets,
        fr=ssim.fr, dm=ssim.dm, cryo=ssim.cryo,
        cryo_bounds=ssim.cryo_bounds,
    )
    fu = np.asarray(fs_cell["fu_surf"])[np.asarray(ssim.sm.valid)]
    assert fu.max() < 0.999, "cryosphere frozen fraction never materialised"
