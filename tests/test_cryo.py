"""Cryosphere golden tests (reference ``AccTemperature.hpp`` +
``FrozenFraction``, wired through ``MD_ET.cpp:296-311``).

Pins the accumulated-temperature ring-buffer semantics bitwise against a
line-by-line Python oracle of the C++ class — including the -9999
Time_start quirk that flushes the very first sample as a full "day" — and
exercises the frozen-season driver path end-to-end.
"""

import jax.numpy as jnp
import numpy as np

from shud_tpu.core.cryo import (
    acc_temp_init,
    acc_temp_mean,
    acc_temp_push,
    cryo_init,
    cryo_step,
)
from shud_tpu.core.landsurface import frozen_fraction


class _AccTempRef:
    """Direct transliteration of ``_AccTemp`` (AccTemperature.hpp:15-62)
    used as the oracle: std::queue + running ACC, day-mean flush when
    (tnow - Time_start) >= 1440, Time_start initialised to -9999."""

    def __init__(self, maxlen):
        self.maxlen = maxlen
        self.que = []
        self.acc = 0.0
        self.time_start = -9999.0
        self.t_acc_day = 0.0
        self.n_of_day = 0

    def _push(self, x):
        self.que.append(x)
        self.acc += x
        if len(self.que) > self.maxlen:
            self.acc -= self.que.pop(0)

    def push(self, x, tnow):
        self.t_acc_day += x
        self.n_of_day += 1
        if (tnow - self.time_start) >= 1440.0:
            self._push(self.t_acc_day / self.n_of_day)
            self.t_acc_day = 0.0
            self.n_of_day = 0
            self.time_start = tnow

    def get_acc(self):
        return self.acc / len(self.que)


def test_acc_temp_bitwise_vs_reference_queue():
    """Ring buffer == std::queue oracle at every ET step over 40 days of
    hourly samples (covers fill-up, steady-state eviction and the
    first-sample flush), for both the 7- and 28-day windows."""
    rng = np.random.default_rng(42)
    ne = 3
    for maxlen in (7, 28):
        st = acc_temp_init(ne, maxlen)
        oracles = [_AccTempRef(maxlen) for _ in range(ne)]
        t = 0.0
        for step in range(40 * 24):
            temp = rng.uniform(-25.0, 10.0, ne)
            st = acc_temp_push(st, jnp.asarray(temp), t)
            for i, o in enumerate(oracles):
                o.push(temp[i], t)
            got = np.asarray(acc_temp_mean(st))
            want = np.array([o.get_acc() for o in oracles])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12), step
            t += 60.0


def test_first_sample_flush_quirk():
    """Time_start = -9999 means the FIRST sample flushes immediately as a
    one-sample day (AccTemperature.hpp:17,47-57) — the accumulated mean is
    defined from the very first push (no 0/0)."""
    st = acc_temp_init(2, 7)
    st = acc_temp_push(st, jnp.asarray([-10.0, 5.0]), 0.0)
    assert int(st.size) == 1
    np.testing.assert_allclose(np.asarray(acc_temp_mean(st)), [-10.0, 5.0])
    # the second sample within the same day does NOT flush
    st = acc_temp_push(st, jnp.asarray([-20.0, 1.0]), 60.0)
    assert int(st.size) == 1
    np.testing.assert_allclose(np.asarray(acc_temp_mean(st)), [-10.0, 5.0])


def test_frozen_fraction_reference_formula():
    """FrozenFraction (functions.hpp:191-201): 0 above high, 1 below low,
    linear ramp between."""
    t = jnp.asarray([0.0, -1.0, -3.0, -5.0, -10.0])
    ff = np.asarray(frozen_fraction(t, -1.0, -5.0))
    np.testing.assert_allclose(ff, [0.0, 0.0, 0.5, 1.0, 1.0])
    # boundary semantics: T == high -> x = 0 (reference falls through to
    # the ramp branch only for T < high; at equality x=0 either way)
    assert float(frozen_fraction(jnp.asarray(-1.0), -1.0, -5.0)) == 0.0


def test_cryo_step_fu_factors():
    """cryo_step returns fu = 1 - FrozenFraction(mean) for both windows
    (MD_ET.cpp:296-311)."""
    cs = cryo_init(2, 7, 28)
    # a long deep freeze: after 30 days both windows are fully frozen
    t = 0.0
    for _ in range(30 * 24):
        cs, fu_surf, fu_sub = cryo_step(cs, jnp.asarray([-20.0, -20.0]), t)
        t += 60.0
    np.testing.assert_allclose(np.asarray(fu_surf), [0.0, 0.0])
    np.testing.assert_allclose(np.asarray(fu_sub), [0.0, 0.0])
    # thaw: surface (7-day) window recovers before the 28-day one
    for _ in range(10 * 24):
        cs, fu_surf, fu_sub = cryo_step(cs, jnp.asarray([5.0, 5.0]), t)
        t += 60.0
    assert float(fu_surf[0]) > float(fu_sub[0])
    np.testing.assert_allclose(np.asarray(fu_surf), [1.0, 1.0])


def test_frozen_season_driver_e2e():
    """Frozen-season end-to-end: with cryosphere=1 and deep-freeze forcing
    the frozen fraction fu_Sub suppresses subsurface lateral drainage and
    recharge (MD_ET.cpp:301-311), so groundwater barely moves vs the twin
    run with the module off (driver wiring driver/fused.py cryosphere
    branch).  (At -20 C precip falls as snow in both runs, so the
    discriminator is the ongoing gw drainage, not infiltration.)"""
    from shud_tpu.driver.fused import FusedSimulation
    from shud_tpu.utils.synthetic import make_synthetic_project

    def run(cryo):
        inp = make_synthetic_project(8, 4, end_day=2.0)
        inp.forc.data[0][:, 1] = -20.0
        inp.control.cryosphere = int(cryo)
        sim = FusedSimulation.create("synthetic", inp=inp)
        ne = sim.md.num_ele
        y0 = np.asarray(sim.bdf.y)
        sim.advance_interval(1440.0)
        sim.advance_interval(1440.0)
        y = np.asarray(sim.bdf.y)
        dgw = np.abs(y[2 * ne : 3 * ne] - y0[2 * ne : 3 * ne])
        return dgw

    dgw_frozen = run(cryo=True)
    dgw_off = run(cryo=False)
    assert dgw_off.mean() > 0, "warm twin must drain"
    assert dgw_frozen.mean() < dgw_off.mean() * 0.1, (
        dgw_frozen.mean(), dgw_off.mean())
