// oracle.cpp — native CPU reference kernels for fluidsimulation.
//
// The reference's parity oracle is its C++ CPU solver pair
// (Simulation2D.cpp / Simulation3D.cpp); this library is our equivalent:
// the serial, loop-carried pieces of the NumPy oracle (fast-sweeping level
// set propagation, whose nested triple-sweep dependency cannot be
// vectorized) implemented natively and exposed through a C ABI for ctypes.
// Semantics match reference/solver3d.py::compute_level_set and
// reference/solver2d.py::compute_level_set exactly (including the
// reference's `otherPt > 0` quirk by which particle 0 never propagates —
// Simulation3D.cpp:242, Simulation2D.cpp:192).
//
// Build: make -C native  (produces liboracle.so)

#include <cmath>
#include <cstdint>

extern "C" {

// 3D: 8 octant triple-sweeps (order of Simulation3D.cpp:307-416).
// pc: (n_particles, 3) positions in cell units; phi/closest: (nx*ny*nz)
// arrays indexed [x + nx*(y + ny*z)]... NOTE: we use x-major linearization
// idx = (x*ny + y)*nz + z to match the NumPy [x,y,z] C-contiguous layout.
void fs3_sweeps(int nx, int ny, int nz, float radius,
                const float* pc, int64_t n_particles,
                float* phi, int64_t* closest) {
    (void)n_particles;
    auto idx = [&](int x, int y, int z) -> int64_t {
        return ((int64_t)x * ny + y) * nz + z;
    };
    auto inner = [&](int dx, int dy, int dz, int x, int y, int z) {
        int64_t other = closest[idx(x + dx, y + dy, z + dz)];
        if (other > 0) {
            float px = pc[3 * other + 0];
            float py = pc[3 * other + 1];
            float pz = pc[3 * other + 2];
            float ddx = px - (float)x, ddy = py - (float)y, ddz = pz - (float)z;
            float dist = std::sqrt(ddx * ddx + ddy * ddy + ddz * ddz) - radius;
            int64_t me = idx(x, y, z);
            if (closest[me] < 0 || dist < phi[me]) {
                closest[me] = other;
                phi[me] = dist;
            }
        }
    };

    // Octant sweep directions: (zdir, ydir, xdir), +1 = forward.
    const int dirs[8][3] = {
        {1, 1, 1},  {1, 1, -1},  {1, -1, 1},  {1, -1, -1},
        {-1, 1, 1}, {-1, 1, -1}, {-1, -1, 1}, {-1, -1, -1},
    };
    for (const auto& d : dirs) {
        int zdir = d[0], ydir = d[1], xdir = d[2];
        for (int zi = 0; zi < nz; zi++) {
            int z = (zdir == 1) ? zi : nz - 1 - zi;
            for (int yi = 0; yi < ny; yi++) {
                int y = (ydir == 1) ? yi : ny - 1 - yi;
                for (int xi = 0; xi < nx; xi++) {
                    int x = (xdir == 1) ? xi : nx - 1 - xi;
                    if (xdir == 1 && x != 0) inner(-1, 0, 0, x, y, z);
                    if (xdir == -1 && x != nx - 1) inner(1, 0, 0, x, y, z);
                    if (ydir == 1 && y != 0) inner(0, -1, 0, x, y, z);
                    if (ydir == -1 && y != ny - 1) inner(0, 1, 0, x, y, z);
                    if (zdir == 1 && z != 0) inner(0, 0, -1, x, y, z);
                    if (zdir == -1 && z != nz - 1) inner(0, 0, 1, x, y, z);
                }
            }
        }
    }
}

// 2D: the 4 Zhao-order sweeps (Simulation2D.cpp:280-314), with their
// specific outer/inner loop nesting.
void fs2_sweeps(int nx, int ny, float radius,
                const float* pc, int64_t n_particles,
                float* phi, int64_t* closest) {
    (void)n_particles;
    auto idx = [&](int x, int y) -> int64_t { return (int64_t)x * ny + y; };
    auto inner = [&](int dx, int dy, int x, int y) {
        int64_t other = closest[idx(x + dx, y + dy)];
        if (other > 0) {
            float px = pc[2 * other + 0];
            float py = pc[2 * other + 1];
            float ddx = px - (float)x, ddy = py - (float)y;
            float dist = std::sqrt(ddx * ddx + ddy * ddy) - radius;
            int64_t me = idx(x, y);
            if (closest[me] < 0 || dist < phi[me]) {
                closest[me] = other;
                phi[me] = dist;
            }
        }
    };

    // Sweep 1: y fwd outer, x fwd inner; looks x-, y-.
    for (int y = 0; y < ny; y++)
        for (int x = 0; x < nx; x++) {
            if (x != 0) inner(-1, 0, x, y);
            if (y != 0) inner(0, -1, x, y);
        }
    // Sweep 2: x bwd outer, y fwd inner; looks x+, y-.
    for (int x = nx - 1; x >= 0; x--)
        for (int y = 0; y < ny; y++) {
            if (x != nx - 1) inner(1, 0, x, y);
            if (y != 0) inner(0, -1, x, y);
        }
    // Sweep 3: x bwd outer, y bwd inner; looks x+, y+.
    for (int x = nx - 1; x >= 0; x--)
        for (int y = ny - 1; y >= 0; y--) {
            if (x != nx - 1) inner(1, 0, x, y);
            if (y != ny - 1) inner(0, 1, x, y);
        }
    // Sweep 4: x fwd outer, y bwd inner; looks x-, y+.
    for (int x = 0; x < nx; x++)
        for (int y = ny - 1; y >= 0; y--) {
            if (x != 0) inner(-1, 0, x, y);
            if (y != ny - 1) inner(0, 1, x, y);
        }
}

}  // extern "C"
