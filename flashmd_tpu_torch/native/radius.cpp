// Host-side radius-neighbour engine (cell list, O(A) for open boundaries):
// the port's own copy of flashmd_tpu/native/radius.cpp, with its cells made
// at least rcut wide (build_cells), the counterpart of the reference's
// torch_cluster radius / radius_graph extension.
//
// The simulation's neighbour search runs on the GPU (ops/neighborlist.py);
// this engine serves the host jobs: sizing the static neighbour capacity
// before the first step, and building exact pair lists for term lists and
// analysis, where an O(A^2) numpy sweep would dominate model-load time for
// large systems.
//
// Plain C ABI, loaded with ctypes (native/__init__.py builds it with g++).
// All positions are double [n, 3] row-major.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct CellList {
    int nx, ny, nz;
    double lo[3];
    double inv_w[3];
    std::vector<std::vector<int>> cells;

    int clampi(int v, int n) const { return v < 0 ? 0 : (v >= n ? n - 1 : v); }

    int cell_of(const double* p) const {
        int ix = clampi(static_cast<int>((p[0] - lo[0]) * inv_w[0]), nx);
        int iy = clampi(static_cast<int>((p[1] - lo[1]) * inv_w[1]), ny);
        int iz = clampi(static_cast<int>((p[2] - lo[2]) * inv_w[2]), nz);
        return (ix * ny + iy) * nz + iz;
    }
};

CellList build_cells(const double* pos, int64_t n, double rcut) {
    CellList cl;
    double hi[3];
    for (int k = 0; k < 3; ++k) { cl.lo[k] = pos[k]; hi[k] = pos[k]; }
    for (int64_t i = 1; i < n; ++i)
        for (int k = 0; k < 3; ++k) {
            double v = pos[3 * i + k];
            if (v < cl.lo[k]) cl.lo[k] = v;
            if (v > hi[k]) hi[k] = v;
        }
    double w = rcut > 1e-12 ? rcut : 1e-12;
    int dims[3];
    for (int k = 0; k < 3; ++k) {
        double span = hi[k] - cl.lo[k];
        // Cells at least rcut wide, so that the 27-cell stencil holds every
        // pair within rcut (floor(span / w) + 1 cells, as in the JAX
        // package's copy, can be narrower than rcut and miss pairs).
        int d = static_cast<int>(span / w);
        if (d < 1) d = 1;
        if (d > 256) d = 256;  // bound memory for pathological spans
        dims[k] = d;
        cl.inv_w[k] = span > 1e-12 ? dims[k] / (span * (1 + 1e-12)) : 0.0;
    }
    cl.nx = dims[0]; cl.ny = dims[1]; cl.nz = dims[2];
    cl.cells.assign(static_cast<size_t>(cl.nx) * cl.ny * cl.nz, {});
    for (int64_t i = 0; i < n; ++i)
        cl.cells[cl.cell_of(pos + 3 * i)].push_back(static_cast<int>(i));
    return cl;
}

// Visit every candidate j for atom i (cells within one cell-width).
template <typename F>
void for_candidates(const CellList& cl, const double* pos, int64_t i, F f) {
    const double* p = pos + 3 * i;
    int ix = cl.clampi(static_cast<int>((p[0] - cl.lo[0]) * cl.inv_w[0]), cl.nx);
    int iy = cl.clampi(static_cast<int>((p[1] - cl.lo[1]) * cl.inv_w[1]), cl.ny);
    int iz = cl.clampi(static_cast<int>((p[2] - cl.lo[2]) * cl.inv_w[2]), cl.nz);
    for (int dx = -1; dx <= 1; ++dx) {
        int jx = ix + dx; if (jx < 0 || jx >= cl.nx) continue;
        for (int dy = -1; dy <= 1; ++dy) {
            int jy = iy + dy; if (jy < 0 || jy >= cl.ny) continue;
            for (int dz = -1; dz <= 1; ++dz) {
                int jz = iz + dz; if (jz < 0 || jz >= cl.nz) continue;
                for (int j : cl.cells[(static_cast<size_t>(jx) * cl.ny + jy)
                                      * cl.nz + jz])
                    f(j);
            }
        }
    }
}

inline double dist2(const double* a, const double* b) {
    double d0 = a[0] - b[0], d1 = a[1] - b[1], d2 = a[2] - b[2];
    return d0 * d0 + d1 * d1 + d2 * d2;
}

// 3x3 inverse (adjugate / det) for fractional coordinates.
bool inv3(const double* m, double* out) {
    double a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5],
           g = m[6], h = m[7], i = m[8];
    double co[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                    f * g - d * i, a * i - c * g, c * d - a * f,
                    d * h - e * g, b * g - a * h, a * e - b * d};
    double det = a * co[0] + b * co[3] + c * co[6];
    if (std::fabs(det) < 1e-30) return false;
    for (int k = 0; k < 9; ++k) out[k] = co[k] / det;
    return true;
}

inline double min_image_d2(const double* a, const double* b,
                           const double* cell, const double* inv) {
    double dr[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    double fr[3];
    for (int k = 0; k < 3; ++k) {
        // rows of `cell` are lattice vectors; dr_frac = dr @ inv
        fr[k] = dr[0] * inv[0 + k] + dr[1] * inv[3 + k] + dr[2] * inv[6 + k];
        fr[k] -= std::nearbyint(fr[k]);
    }
    double w[3];
    for (int k = 0; k < 3; ++k)
        w[k] = fr[0] * cell[0 + k] + fr[1] * cell[3 + k] + fr[2] * cell[6 + k];
    return w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
}

}  // namespace

extern "C" {

// counts[i] = number of j != i with d(i, j) < rcut. Open boundaries,
// cell-list accelerated. Returns the max count.
int64_t flashmd_neighbor_counts(const double* pos, int64_t n, double rcut,
                                int64_t* counts) {
    CellList cl = build_cells(pos, n, rcut);
    double r2 = rcut * rcut;
    int64_t max_c = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t c = 0;
        for_candidates(cl, pos, i, [&](int j) {
            if (j != i && dist2(pos + 3 * i, pos + 3 * j) < r2) ++c;
        });
        counts[i] = c;
        if (c > max_c) max_c = c;
    }
    return max_c;
}

// Periodic variant (general triclinic cell, rows = lattice vectors),
// minimum-image convention; O(A^2) — host-side sizing only. Returns the
// max count, or -1 for a singular cell.
int64_t flashmd_neighbor_counts_pbc(const double* pos, int64_t n,
                                    double rcut, const double* cell,
                                    int64_t* counts) {
    double inv[9];
    if (!inv3(cell, inv)) return -1;
    double r2 = rcut * rcut;
    for (int64_t i = 0; i < n; ++i) counts[i] = 0;
    int64_t max_c = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = i + 1; j < n; ++j) {
            if (min_image_d2(pos + 3 * i, pos + 3 * j, cell, inv) < r2) {
                ++counts[i];
                ++counts[j];
            }
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (counts[i] > max_c) max_c = counts[i];
    return max_c;
}

// Enumerate directed pairs (i -> j, i != j, d < rcut) into src/dst
// (each of size cap). Returns the number of pairs found (may exceed cap,
// in which case only the first cap were written).
int64_t flashmd_radius_pairs(const double* pos, int64_t n, double rcut,
                             int64_t cap, int64_t* src, int64_t* dst) {
    CellList cl = build_cells(pos, n, rcut);
    double r2 = rcut * rcut;
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        for_candidates(cl, pos, i, [&](int j) {
            if (j != i && dist2(pos + 3 * i, pos + 3 * j) < r2) {
                if (m < cap) { src[m] = i; dst[m] = j; }
                ++m;
            }
        });
    }
    return m;
}

}  // extern "C"
