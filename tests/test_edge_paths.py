"""The XLA edge-stencil strategies of ``rhs.edge_fluxes`` against each other.

On a seeded synthetic watershed that is shuffled and then RCM-renumbered
(the structure of a real unstructured mesh: no roll shortcut, generic
neighbour gathers), the production fast path (one stacked gather,
local-datum head differences) must equal the exact-parity path (the
reference's own operation order, pinned to the C++ oracle by
tests/test_rhs.py) in f64 and, within float32 rounding, in f32 — with and
without a lake.  On a structured mesh the roll-gather must equal the
stacked gather exactly.  Also pins the renumbering tools behind the mesh.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from shud_tpu.core import rhs as R
from shud_tpu.core.device import to_device
from shud_tpu.core.mesh import build_mesh
from shud_tpu.core.state import ForcingSlice
from shud_tpu.utils.reorder import (graph_bandwidth, localize_project,
                                    permute_project, rcm_permutation)
from shud_tpu.utils.synthetic import make_synthetic_project

# bounds relative to max|dY|: f64 differs from the exact path only by
# re-association (~1e-13 measured); f32 by float32 rounding through a few
# dozen operations (eps 1.2e-7; ~3e-7 measured)
REL_BOUND = {"f64": 1e-9, "f32": 1e-5}


def _shuffled_rcm(nx, ny, with_lake, seed=0):
    inp = make_synthetic_project(nx, ny, with_lake=with_lake)
    ne = inp.tri.shape[0]
    inp = permute_project(inp, np.random.default_rng(seed).permutation(ne))
    inp, _ = localize_project(inp)
    return build_mesh(inp)


def _state_and_forcing(md, dtype, seed=5):
    rng = np.random.default_rng(seed)
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    y = np.concatenate([
        rng.uniform(0, 0.05, ne), rng.uniform(0, 1.0, ne),
        rng.uniform(0, 8.0, ne), rng.uniform(0, 1.0, nr),
        rng.uniform(0, 3.0, nl),
    ])
    fs = dict(
        net_prcp=rng.uniform(0, 2e-5, ne), prcp=rng.uniform(0, 2e-5, ne),
        pot_evap=rng.uniform(0, 3e-6, ne), pot_tran=rng.uniform(0, 3e-6, ne),
        e_ic=rng.uniform(0, 2e-6, ne), lai=rng.uniform(0, 4, ne),
        fu_surf=np.ones(ne), fu_sub=np.ones(ne),
        ele_ybc=np.zeros(ne), ele_qbc=np.zeros(ne), ele_qss=np.zeros(ne),
        riv_ybc=np.zeros(nr), riv_qbc=np.zeros(nr),
    )
    return y, {k: np.asarray(v) for k, v in fs.items()}


def _rhs(md, y, fs, dtype, close_boundary, exact_parity=False):
    dm = to_device(md, dtype)
    f = ForcingSlice(**{k: jnp.asarray(v, dtype) for k, v in fs.items()})
    dy, diag = R.rhs_full(dm, f, 0.0, jnp.asarray(y, dtype),
                          close_boundary=close_boundary,
                          exact_parity=exact_parity)
    return (np.asarray(dy, np.float64),
            {k: np.asarray(diag[k], np.float64)
             for k in ("q_esurf", "q_esub")})


@pytest.mark.parametrize("with_lake", [False, True], ids=["nolake", "lake"])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_fast_path_matches_exact_parity(prec, with_lake):
    md = _shuffled_rcm(20, 16, with_lake)
    assert md.roll_offsets is None  # generic gather, as on a real mesh
    assert (md.num_lake > 0) == with_lake
    y, fs = _state_and_forcing(md, None)
    dtype = jnp.float64 if prec == "f64" else jnp.float32
    for cb in (True, False):
        ref, dref = _rhs(md, y, fs, jnp.float64, cb, exact_parity=True)
        got, dgot = _rhs(md, y, fs, dtype, cb)
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= REL_BOUND[prec] * scale
        for k in dref:
            s = np.abs(dref[k]).max()
            assert np.abs(dgot[k] - dref[k]).max() <= REL_BOUND[prec] * s, k


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_roll_gather_matches_stacked_gather(prec):
    md = build_mesh(make_synthetic_project(12, 8))
    assert md.roll_offsets is not None  # structured grid: roll shortcut
    y, fs = _state_and_forcing(md, None)
    dtype = jnp.float64 if prec == "f64" else jnp.float32
    rolled, _ = _rhs(md, y, fs, dtype, True)
    md_g = dataclasses.replace(md, roll_offsets=None, roll_k_idx=None)
    gathered, _ = _rhs(md_g, y, fs, dtype, True)
    np.testing.assert_array_equal(rolled, gathered)


def test_graph_bandwidth():
    nabr = np.array([[1, -1, -1], [0, 3, -1], [-1, -1, -1], [1, -1, -1]])
    assert graph_bandwidth(nabr) == 2
    assert graph_bandwidth(np.full((3, 3), -1)) == 0


def test_rcm_bandwidth_reduction():
    inp = make_synthetic_project(32, 32)
    ne = inp.tri.shape[0]
    rng = np.random.default_rng(0)
    shuffled = permute_project(inp, rng.permutation(ne))
    nabr1 = shuffled.tri[:, 4:7].astype(np.int64)
    nabr = np.where(nabr1 > 0, nabr1 - 1, -1)
    band_before = graph_bandwidth(nabr)
    perm = rcm_permutation(nabr)
    ordered = permute_project(shuffled, perm)
    nabr1 = ordered.tri[:, 4:7].astype(np.int64)
    band_after = graph_bandwidth(np.where(nabr1 > 0, nabr1 - 1, -1))
    assert band_after < band_before / 8
    assert band_after <= 4 * int(np.sqrt(ne))


def test_permute_project_preserves_physics():
    """Permuted project -> same RHS as original, mapped through the perm."""
    inp = make_synthetic_project(16, 12)
    ne = inp.tri.shape[0]
    perm = np.random.default_rng(5).permutation(ne)
    md = build_mesh(inp)
    md_p = build_mesh(permute_project(inp, perm))
    nr = md.num_riv
    y, fs = _state_and_forcing(md, None)
    dy, _ = _rhs(md, y, fs, jnp.float64, True)
    fs_p = {k: (v[perm] if v.shape == (ne,) else v) for k, v in fs.items()}
    y_p = np.concatenate([y[k * ne:(k + 1) * ne][perm] for k in range(3)]
                         + [y[3 * ne:]])
    dy_p, _ = _rhs(md_p, y_p, fs_p, jnp.float64, True)
    for k in range(3):  # sf/us/gw blocks permute; river block identical
        np.testing.assert_allclose(
            dy[k * ne:(k + 1) * ne][perm], dy_p[k * ne:(k + 1) * ne],
            rtol=0, atol=1e-14)
    np.testing.assert_allclose(dy[3 * ne:], dy_p[3 * ne:], rtol=0,
                               atol=1e-14)
    assert nr == md_p.num_riv
