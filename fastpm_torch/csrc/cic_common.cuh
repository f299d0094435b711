// Device code shared by the CIC kernels K1-K4: the base cell, fraction
// and the 8 corner indices and weights of one particle.
//
// For each particle g = x * InvCellSize in float32, base = floor(g),
// frac = g - base; the base cell and its +1 neighbour wrap periodically;
// the 8 corner weights are the products ((wx * wy) * wz) of
// (1 - frac, frac) per axis, dx-major (fastpm_tpu/ops/paint_pallas.py:
// 273-295 base_cell_frac / w8_from_frac). __fmul_rn / __fsub_rn keep
// nvcc from contracting x * inv - floor into a fused multiply-add, so the
// fraction is rounded exactly as the float32 reference computes it.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace fastpm_cic {

__device__ __forceinline__ int wrap_cell(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

// Fill idx[8] (flat index into an nx*ny*nz mesh) and w[8] for particle i
// of x (n x 3 float32).
__device__ __forceinline__ void corners(const float* __restrict__ x,
                                        long long i, int nx, int ny, int nz,
                                        float icx, float icy, float icz,
                                        size_t idx[8], float w[8]) {
    const float g[3] = {__fmul_rn(x[3 * i], icx),
                        __fmul_rn(x[3 * i + 1], icy),
                        __fmul_rn(x[3 * i + 2], icz)};
    const int nm[3] = {nx, ny, nz};
    int lo[3], hi[3];
    float f[3], t[3];
    for (int d = 0; d < 3; ++d) {
        const float b = floorf(g[d]);
        f[d] = __fsub_rn(g[d], b);
        t[d] = __fsub_rn(1.0f, f[d]);
        lo[d] = wrap_cell((int)b, nm[d]);
        hi[d] = lo[d] + 1 == nm[d] ? 0 : lo[d] + 1;
    }
    int c = 0;
    for (int dx = 0; dx < 2; ++dx) {
        const size_t ix = (size_t)(dx ? hi[0] : lo[0]) * ny;
        const float wx = dx ? f[0] : t[0];
        for (int dy = 0; dy < 2; ++dy) {
            const size_t ixy = (ix + (dy ? hi[1] : lo[1])) * nz;
            const float wxy = __fmul_rn(wx, dy ? f[1] : t[1]);
            for (int dz = 0; dz < 2; ++dz, ++c) {
                idx[c] = ixy + (dz ? hi[2] : lo[2]);
                w[c] = __fmul_rn(wxy, dz ? f[2] : t[2]);
            }
        }
    }
}

// Add particle i's mass m at its 8 corners of canvas (float atomics).
__device__ __forceinline__ void deposit(const float* __restrict__ x,
                                        long long i, int nx, int ny, int nz,
                                        float icx, float icy, float icz,
                                        float m, float* canvas) {
    size_t idx[8];
    float w[8];
    corners(x, i, nx, ny, nz, icx, icy, icz, idx, w);
    for (int c = 0; c < 8; ++c) atomicAdd(canvas + idx[c], __fmul_rn(w[c], m));
}

// The weighted sum of field f over particle i's 8 corners.
__device__ __forceinline__ float gather(const float* __restrict__ f,
                                        const size_t idx[8],
                                        const float w[8]) {
    float acc = 0.0f;
    for (int c = 0; c < 8; ++c) acc += w[c] * __ldg(f + idx[c]);
    return acc;
}

}  // namespace fastpm_cic
