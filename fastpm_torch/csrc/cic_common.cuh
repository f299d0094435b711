// Device code shared by the CIC kernels: the base cell, fraction and the
// 8 corner indices and weights of one particle, for the paints (K1 and
// K3 through cic_deposit.cuh, K5) and the readout (K2, K4, K6,
// csrc/cic_readout.cu). The homed
// paint counts a particle as beyond its slab exactly where the homed
// readout reads it as zero, because both take cell() below.
//
// For each particle g = x * InvCellSize in float32, base = floor(g),
// frac = g - base; the base cell and its +1 neighbour wrap periodically;
// the 8 corner weights are the products ((wx * wy) * wz) of
// (1 - frac, frac) per axis, dx-major (fastpm_tpu/ops/paint_pallas.py:
// 273-295 base_cell_frac / w8_from_frac). __fmul_rn / __fsub_rn keep
// nvcc from contracting x * inv - floor into a fused multiply-add, so the
// fraction is rounded exactly as the float32 reference computes it.
// Flat indices are int32: the wrappers (ops/cic.py) bound every mesh
// below 2^31 cells.
//
// The x axis is periodic over the canvas's nx planes, or open: the
// homed slab force paints into and reads from its rank's x-slab widened
// by H halo planes, a canvas of nx = nloc + 2H + 1 planes. There the
// global base plane bx = remainder(floor(g), n0) sits at
// relx = remainder(bx + shift, n0) with shift = H - r0, r0 the slab's
// first plane (fastpm_tpu/parallel/psolver.py:178-190 _cic_rel); only
// relx < nx - 1 lies inside, and its +1 corner is relx + 1, unwrapped.
// y and z stay periodic.

#pragma once

#include <cuda_runtime.h>

namespace fastpm_cic {

// The x axis of a canvas: n0 == 0 periodic, else open over a global mesh
// of n0 planes with the slab shift H - r0.
struct XAxis {
    int n0;
    int shift;
};

__device__ __forceinline__ int wrap_cell(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

// The periodic wrap of a base cell: compare-and-add over [-n, 2n), which
// holds every position the solver keeps; the exact remainder beyond.
__device__ __forceinline__ int wrap(int b, int n) {
    const int r = b < 0 ? b + n : (b >= n ? b - n : b);
    return (unsigned)r < (unsigned)n ? r : wrap_cell(b, n);
}

// Base cell lo, +1 neighbour hi, fraction f and 1 - f per axis of the
// particle at p (3 float32). Returns false for a particle beyond an
// open x-slab (lo, hi, f and t are then not set).
__device__ __forceinline__ bool cell(const float* p, int nx, int ny, int nz,
                                     float icx, float icy, float icz,
                                     XAxis ax, int lo[3], int hi[3],
                                     float f[3], float t[3]) {
    const float g[3] = {__fmul_rn(p[0], icx), __fmul_rn(p[1], icy),
                        __fmul_rn(p[2], icz)};
    const float b[3] = {floorf(g[0]), floorf(g[1]), floorf(g[2])};
    if (ax.n0 > 0) {
        const int rel = wrap(wrap((int)b[0], ax.n0) + ax.shift, ax.n0);
        if (rel >= nx - 1) return false;
        lo[0] = rel;
        hi[0] = rel + 1;
    } else {
        lo[0] = wrap((int)b[0], nx);
        hi[0] = lo[0] + 1 == nx ? 0 : lo[0] + 1;
    }
    const int nm[3] = {nx, ny, nz};
    for (int d = 1; d < 3; ++d) {
        lo[d] = wrap((int)b[d], nm[d]);
        hi[d] = lo[d] + 1 == nm[d] ? 0 : lo[d] + 1;
    }
    for (int d = 0; d < 3; ++d) {
        f[d] = __fsub_rn(g[d], b[d]);
        t[d] = __fsub_rn(1.0f, f[d]);
    }
    return true;
}

// Flat indices into an (nx, ny, nz) canvas and weights of the 4 corners
// of x plane dx (0: the base plane, 1: its +1 neighbour), dy-major.
__device__ __forceinline__ void plane_corners(int dx, const int lo[3],
                                              const int hi[3],
                                              const float f[3],
                                              const float t[3], int ny,
                                              int nz, int idx[4],
                                              float w[4]) {
    const int ix = (dx ? hi[0] : lo[0]) * ny;
    const float wx = dx ? f[0] : t[0];
    int c = 0;
    for (int dy = 0; dy < 2; ++dy) {
        const int ixy = (ix + (dy ? hi[1] : lo[1])) * nz;
        const float wxy = __fmul_rn(wx, dy ? f[1] : t[1]);
        for (int dz = 0; dz < 2; ++dz, ++c) {
            idx[c] = ixy + (dz ? hi[2] : lo[2]);
            w[c] = __fmul_rn(wxy, dz ? f[2] : t[2]);
        }
    }
}

// Fill idx[8] (flat index into an nx*ny*nz mesh) and w[8] for the
// particle at p, dx-major. Returns false for a particle beyond an open
// x-slab.
__device__ __forceinline__ bool corners(const float* p, int nx, int ny,
                                        int nz, float icx, float icy,
                                        float icz, int idx[8], float w[8],
                                        XAxis ax = XAxis{0, 0}) {
    int lo[3], hi[3];
    float f[3], t[3];
    if (!cell(p, nx, ny, nz, icx, icy, icz, ax, lo, hi, f, t)) return false;
    plane_corners(0, lo, hi, f, t, ny, nz, idx, w);
    plane_corners(1, lo, hi, f, t, ny, nz, idx + 4, w + 4);
    return true;
}

}  // namespace fastpm_cic
