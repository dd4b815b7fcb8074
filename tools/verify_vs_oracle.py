#!/usr/bin/env python3
"""Reference-physics trajectory verification (BASELINE.md's 1000-step target).

The reference's integrator (SUNDIALS/CVODE) is not installable here (zero
egress), and adaptive controllers are not comparable step-for-step across
implementations anyway (docs/VALIDATION.md: the switching physics makes any
two adaptive solvers diverge at their tolerance).  So this tool removes the
integrator as a variable: it integrates the **exact reference C++ physics**
(the compiled oracle — bitwise the reference RHS incl. its forcing and ET
bucket updates, tools/build_oracle.sh) and the shud_tpu physics with the
SAME fixed-step backward-Euler sequence, same window/forcing cadence as the
reference driver (shud.cpp:91-155), and compares the discrete trajectories.

Identical discretization + independent physics implementations -> any
divergence is physics divergence.  1 day at h=0.1 min = 14,400 steps (14x
the 1000-step target).

Oracle side: Newton with a colored finite-difference sparse Jacobian and
sparse LU.  shud_tpu side: solver/fixed.py's backward Euler (Newton-GMRES
with exact JVPs).  Both converge the same nonlinear system per step.

Usage:
  python tools/verify_vs_oracle.py [project] [days] [h_min] [tol_m]
  (defaults: ccw 1 day, h=0.1 min, 1e-4 m)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def jac_sparsity(md):
    """Conservative Jacobian sparsity pattern from the mesh graph."""
    from scipy.sparse import coo_matrix

    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    ny = 3 * ne + nr + nl
    rows, cols = [], []

    def dep(i, j):
        rows.append(i)
        cols.append(j)

    def cell_pair(i, j):
        for a in (i, ne + i, 2 * ne + i):
            for b in (j, ne + j, 2 * ne + j):
                dep(a, b)

    nabr = np.asarray(md.nabr)
    for i in range(ne):
        cell_pair(i, i)
        for j in nabr[i]:
            if j >= 0:
                cell_pair(i, int(j))
    for e, r in zip(np.asarray(md.seg_ele), np.asarray(md.seg_riv)):
        for a in (int(e), ne + int(e), 2 * ne + int(e), 3 * ne + int(r)):
            for b in (int(e), ne + int(e), 2 * ne + int(e), 3 * ne + int(r)):
                dep(a, b)
    down = np.asarray(md.riv_down)
    for r in range(nr):
        dep(3 * ne + r, 3 * ne + r)
        d = int(down[r])
        if d >= 0:
            dep(3 * ne + r, 3 * ne + d)
            dep(3 * ne + d, 3 * ne + r)
    if nl:
        # lake stage couples only to its member cells, bank cells and
        # lake-bound rivers (MD_f.cpp:180-191, MD_Lake.cpp) — keeping the
        # pattern sparse preserves FD column grouping (a dense lake row
        # would force one FD group per column).
        i_lake = np.asarray(md.i_lake)
        lakenabr = np.asarray(md.lakenabr)
        riv_to_lake = np.asarray(md.riv_to_lake)
        for li in range(nl):
            k = 3 * ne + nr + li
            dep(k, k)
            cells = set(np.where(i_lake == li + 1)[0])
            cells |= set(np.where((lakenabr == li).any(axis=1))[0])
            for i in cells:
                for a in (int(i), ne + int(i), 2 * ne + int(i)):
                    dep(k, a)
                    dep(a, k)
            for r in np.where(riv_to_lake == li)[0]:
                dep(k, 3 * ne + int(r))
                dep(3 * ne + int(r), k)
    data = np.ones(len(rows), dtype=np.int8)
    return coo_matrix((data, (rows, cols)), shape=(ny, ny)).tocsc()


class OracleBE:
    """Backward Euler for the oracle RHS: Newton + colored-FD sparse
    Jacobian (refreshed lazily) + sparse LU."""

    def __init__(self, o, S):
        from scipy.optimize._numdiff import group_columns

        self.o = o
        self.S = S.tocsc()
        self.groups = np.asarray(group_columns(self.S))
        self.ng = int(self.groups.max()) + 1
        self.lu = None
        self.h_fact = None
        self.nfe = 0
        # per-column row indices of the pattern
        self.col_rows = np.split(self.S.indices, self.S.indptr[1:-1])

    def fd_jac(self, t, y, f0):
        from scipy.sparse import csc_matrix

        ny = len(y)
        data = np.zeros(self.S.nnz)
        eps0 = np.sqrt(np.finfo(float).eps)
        for g in range(self.ng):
            cols = np.where(self.groups == g)[0]
            eps = eps0 * np.maximum(1.0, np.abs(y[cols]))
            yp = y.copy()
            yp[cols] += eps
            fg = self.o.f(t, yp)
            self.nfe += 1
            for c, e in zip(cols, eps):
                r = self.col_rows[c]
                sl = slice(self.S.indptr[c], self.S.indptr[c + 1])
                data[sl] = (fg[r] - f0[r]) / e
        return csc_matrix((data, self.S.indices, self.S.indptr),
                          shape=self.S.shape)

    def refresh(self, t, y, h):
        from scipy.sparse import identity
        from scipy.sparse.linalg import splu

        fk = self.o.f(t, y)
        self.nfe += 1
        J = self.fd_jac(t, y, fk)
        A = (identity(len(y), format="csc") - h * J).tocsc()
        self.lu = splu(A)
        self.h_fact = h

    def step(self, t, y, h, newton_tol=1e-9, max_newton=5):
        """Chord-Newton backward Euler: the LU of (I - hJ) is reused across
        steps and refreshed at most once per step, only when the iteration
        diverges (CVODE's own Jacobian-reuse policy).  The convergence
        floor is set by branch chatter in the switching physics, the same
        floor the JAX side's fixed Newton-GMRES iteration reaches."""
        t_new = t + h
        f0 = self.o.f(t_new, y)
        self.nfe += 1
        yk = y + h * f0
        if self.lu is None or self.h_fact != h:
            self.refresh(t_new, yk, h)
        refreshed = False
        rn_prev = np.inf
        for it in range(max_newton):
            fk = self.o.f(t_new, yk)
            self.nfe += 1
            res = yk - h * fk - y
            rn = float(np.max(np.abs(res)))
            if rn < newton_tol:
                break
            if rn > rn_prev and not refreshed:
                self.refresh(t_new, yk, h)  # diverging: fresh Jacobian
                refreshed = True
            rn_prev = rn
            yk = yk - self.lu.solve(res)
        return yk


def oracle_project(project: str, days: float) -> str:
    """Oracle-side project name.  heihe needs a patched copy: its cfg END
    (9861 d) exceeds the forcing coverage (9496 d), so the reference's own
    fail-fast validation (MD_readin.cpp:797-937) aborts loadinput.  The
    copy (symlinks + END rewritten) lives under /tmp/oracle/ws, outside the
    repo; all data files remain the untouched reference inputs."""
    if project != "heihe":
        return project
    ws_in = "/tmp/oracle/ws/input"
    if os.path.islink(ws_in):
        os.unlink(ws_in)
        os.makedirs(ws_in)
        for d in os.listdir("/root/reference/input"):
            os.symlink(os.path.join("/root/reference/input", d),
                       os.path.join(ws_in, d))
    name = "heihe_v"
    pdir = os.path.join(ws_in, name)
    if not os.path.isdir(pdir):
        os.makedirs(pdir)
        src = "/root/reference/input/heihe"
        for f in os.listdir(src):
            if not f.startswith("heihe."):
                continue
            suffix = f[len("heihe"):]
            dst = os.path.join(pdir, name + suffix)
            if suffix == ".cfg.para":
                lines = []
                for ln in open(os.path.join(src, f)):
                    if ln.split() and ln.split()[0].upper() == "END":
                        ln = f"END\t{max(days + 1.0, 30.0):g}\n"
                    lines.append(ln)
                with open(dst, "w") as fh:
                    fh.writelines(lines)
            else:
                os.symlink(os.path.join(src, f), dst)
    return name


def main():
    project = sys.argv[1] if len(sys.argv) > 1 else "ccw"
    days = float(sys.argv[2]) if len(sys.argv) > 2 else 1.0
    h = float(sys.argv[3]) if len(sys.argv) > 3 else 0.1
    tol = float(sys.argv[4]) if len(sys.argv) > 4 else 1e-4

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import shud_tpu  # noqa: F401
    from shud_tpu.core.rhs import rhs
    from shud_tpu.driver.simulate import Simulation
    from shud_tpu.solver.fixed import fixed_bdf1
    from tools.oracle import Oracle

    cwd = os.getcwd()
    o = Oracle(oracle_project(project, days))
    os.chdir(cwd)
    # inject-forcing mode: heihe's LAI table has 11 columns but its .att
    # iLC goes to 13 — the reference's own forcing path reads out of bounds
    # (undefined values).  shud_tpu clamps; for a meaningful physics diff
    # the oracle gets OUR forcing-slice fields each window (same synthetic-
    # forcing route the golden fixtures use, tools/gen_golden.py).
    inject = project == "heihe"
    overrides = {"day_end": days + 1.0} if inject else {}
    sim = Simulation.create(project, base="/root/reference", **overrides)
    cs = sim.inp.control
    md = sim.md
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    step = cs.solver_step
    t_end = cs.start_time + days * 1440.0
    n_sub = int(round(step / h))
    print(f"== {project}: {days:g} days from t0={cs.start_time:g} min, "
          f"window {step:g} min, h={h:g} min "
          f"({int(days * 1440.0 / h)} BE steps)"
          f"{' [inject-forcing mode]' if inject else ''} ==", flush=True)

    S = jac_sparsity(md)
    be = OracleBE(o, S)
    print(f"jac sparsity: {S.nnz} nnz, {be.ng} FD groups", flush=True)

    def f(tt, yy, p):
        mesh, slc = p
        return rhs(mesh, slc, tt, yy)

    y_ref = o.y0()
    y_jax = jnp.asarray(np.asarray(sim.bdf.y), jnp.float64)
    t = cs.start_time
    t0 = time.time()
    nwin = 0
    while t < t_end - 1e-9:
        tout = min(t + step, t_end)
        # shud_tpu side forcing first (advances our buckets + sim.t)
        fs, cf = sim.forcing_slice(tout)
        # reference side: C++ forcing + ET buckets — or our slice injected
        if inject:
            for oname, arr in (
                ("qEleNetPrep", fs.net_prcp), ("qElePrep", fs.prcp),
                ("qPotEvap", fs.pot_evap), ("qPotTran", fs.pot_tran),
                ("qEleE_IC", fs.e_ic), ("t_lai", fs.lai),
                ("fu_Surf", fs.fu_surf), ("fu_Sub", fs.fu_sub),
                ("qEleETP", cf.etp),  # only feeds the AET>2*PET warning
            ):
                o.set(oname, np.asarray(arr, dtype=np.float64))
        else:
            o.update_forcing(t)
            o.et(t, tout)
        for k in range(n_sub):
            y_ref = be.step(t + k * h, y_ref, h)
        _, y_jax = fixed_bdf1(f, y_jax, t, (sim.dm, fs), h, n_sub,
                              newton_iters=4)
        t = tout
        nwin += 1
        if nwin in (1, 3) or nwin % 36 == 0:
            d = float(np.max(np.abs(np.asarray(y_jax) - y_ref)))
            print(f"  t={t/1440:.2f} d: max|Δ|={d:.3e} "
                  f"(oracle nfe={be.nfe}, {time.time()-t0:.0f}s)", flush=True)

    y_jax = np.asarray(y_jax)
    names = [("surface ponding", 0, ne), ("unsat storage", ne, 2 * ne),
             ("GW head", 2 * ne, 3 * ne), ("river stage", 3 * ne, 3 * ne + nr)]
    if nl:
        names.append(("lake stage", 3 * ne + nr, 3 * ne + nr + nl))
    ok = True
    for label, a, b in names:
        d = float(np.abs(y_jax[a:b] - y_ref[a:b]).max())
        status = "PASS" if d <= tol else "FAIL"
        ok &= d <= tol
        print(f"  max |Δ {label}|: {d:.3e} m  [{status} @ {tol:g}]")
    print("OVERALL:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
