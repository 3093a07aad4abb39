"""Native C++ oracle kernels vs the pure-Python loops: identical results."""

import numpy as np
import pytest

from fluidsimulation.core.config import SimConfig, SimConfig2D
from fluidsimulation.reference import native


@pytest.mark.skipif(not native.available(), reason="liboracle.so not built")
def test_fs3_sweeps_matches_python():
    cfg = SimConfig(nx=8, ny=8, nz=8, cells_per_meter=8.0)
    rng = np.random.default_rng(3)
    n = 40
    pc = rng.uniform(0.5, 7.5, size=(n, 3)).astype(np.float32)

    # Seed identically for both paths.
    phi0 = np.full((8, 8, 8), np.inf, np.float32)
    cl0 = np.full((8, 8, 8), -1, np.int64)
    cell = np.round(pc).astype(np.int64)
    r = cfg.particle_radius
    for i in range(n):
        x, y, z = cell[i]
        d = float(np.sqrt(((pc[i] - cell[i]) ** 2).sum(dtype=np.float32))) - r
        if cl0[x, y, z] < 0 or d < phi0[x, y, z]:
            cl0[x, y, z] = i
            phi0[x, y, z] = d

    phi_n, cl_n = phi0.copy(), cl0.copy()
    assert native.fs3_sweeps(8, 8, 8, r, pc, phi_n, cl_n)

    # Pure-python replay of the same sweeps.
    phi_p, cl_p = phi0.copy(), cl0.copy()

    def inner(dx, dy, dz, x, y, z):
        o = cl_p[x + dx, y + dy, z + dz]
        if o > 0:
            d = float(np.sqrt(((pc[o] - np.array([x, y, z], np.float32)) ** 2).sum())) - r
            if cl_p[x, y, z] < 0 or d < phi_p[x, y, z]:
                cl_p[x, y, z] = o
                phi_p[x, y, z] = d

    for zdir, ydir, xdir in [
        (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1),
        (-1, 1, 1), (-1, 1, -1), (-1, -1, 1), (-1, -1, -1),
    ]:
        zs = range(8) if zdir == 1 else range(7, -1, -1)
        ys = range(8) if ydir == 1 else range(7, -1, -1)
        xs = range(8) if xdir == 1 else range(7, -1, -1)
        for z in zs:
            for y in ys:
                for x in xs:
                    if xdir == 1 and x != 0:
                        inner(-1, 0, 0, x, y, z)
                    if xdir == -1 and x != 7:
                        inner(1, 0, 0, x, y, z)
                    if ydir == 1 and y != 0:
                        inner(0, -1, 0, x, y, z)
                    if ydir == -1 and y != 7:
                        inner(0, 1, 0, x, y, z)
                    if zdir == 1 and z != 0:
                        inner(0, 0, -1, x, y, z)
                    if zdir == -1 and z != 7:
                        inner(0, 0, 1, x, y, z)

    np.testing.assert_array_equal(cl_n, cl_p)
    np.testing.assert_allclose(phi_n, phi_p, atol=1e-5)


@pytest.mark.skipif(not native.available(), reason="liboracle.so not built")
def test_fs2_sweeps_runs():
    cfg = SimConfig2D(nx=8, ny=8, cells_per_meter=8.0)
    rng = np.random.default_rng(5)
    pc = rng.uniform(0.5, 7.5, size=(20, 2)).astype(np.float32)
    phi = np.full((8, 8), np.inf, np.float32)
    cl = np.full((8, 8), -1, np.int64)
    cell = np.round(pc).astype(np.int64)
    for i in range(20):
        x, y = cell[i]
        d = float(np.hypot(*(pc[i] - cell[i]))) - cfg.particle_radius
        if cl[x, y] < 0 or d < phi[x, y]:
            cl[x, y] = i
            phi[x, y] = d
    assert native.fs2_sweeps(8, 8, cfg.particle_radius, pc, phi, cl)
    # Every cell reachable from a nonzero-index particle got a finite value.
    assert np.isfinite(phi).mean() > 0.9
