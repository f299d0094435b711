// K1: CIC paint (mass deposit) of particles onto a periodic mesh.
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel8
// (reached through make_paint_from8_fn), the one-pass deposit of
// cell-sorted particles into two dx streams with a halo carry between
// windows and a padded-face fold done by the caller.
//
// Contract (the from8 path's, not its TPU mechanism): for each particle
// g = x * InvCellSize in float32, base = floor(g), frac = g - base; the
// base cell and its +1 neighbour wrap periodically; the 8 corner weights
// are the products ((wx * wy) * wz) of (1 - frac, frac) per axis
// (paint_pallas.py:273-295 base_cell_frac / w8_from_frac), times the
// particle's mass: a scalar, or a per-particle column where one is given.
// There are no windows, no range table, no packed cw9 operand and no
// face fold: periodic indices go straight into the (nx, ny, nz) canvas.
//
// What bounds it on an H100: device-memory bytes (12 B read per
// particle, the canvas written once) and, under clustering, atomic
// throughput on hot cells. One thread per particle with 8 float
// atomicAdds. The caller passes particles sorted by cell, so the
// threads of a warp touch neighbouring canvas lines and most atomics
// resolve in L2. Shared-memory tiling over the sorted order and warp
// aggregation of atomics are left for later work.
//
// The canvas must be zeroed by the caller. f32 atomics land in an order
// that changes from run to run, so the result differs in the last bits
// between runs.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap_cell(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

__global__ void cic_paint_kernel(const float* __restrict__ x, long long n,
                                 int nx, int ny, int nz,
                                 float icx, float icy, float icz,
                                 float mass, const float* __restrict__ masses,
                                 float* __restrict__ canvas) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float m = masses ? masses[i] : mass;
    // __fmul_rn / __fsub_rn: no fused multiply-add, so the fraction is
    // rounded exactly as the float32 reference computes it
    float g[3] = {__fmul_rn(x[3 * i], icx), __fmul_rn(x[3 * i + 1], icy),
                  __fmul_rn(x[3 * i + 2], icz)};
    int nm[3] = {nx, ny, nz};
    int lo[3], hi[3];
    float f[3], t[3];
    for (int d = 0; d < 3; ++d) {
        float b = floorf(g[d]);
        f[d] = __fsub_rn(g[d], b);
        t[d] = __fsub_rn(1.0f, f[d]);
        lo[d] = wrap_cell((int)b, nm[d]);
        hi[d] = lo[d] + 1 == nm[d] ? 0 : lo[d] + 1;
    }
    for (int dx = 0; dx < 2; ++dx) {
        const size_t ix = (size_t)(dx ? hi[0] : lo[0]) * ny;
        const float wx = dx ? f[0] : t[0];
        for (int dy = 0; dy < 2; ++dy) {
            const size_t ixy = (ix + (dy ? hi[1] : lo[1])) * nz;
            const float wxy = __fmul_rn(wx, dy ? f[1] : t[1]);
            for (int dz = 0; dz < 2; ++dz) {
                const float w = __fmul_rn(wxy, dz ? f[2] : t[2]);
                atomicAdd(canvas + ixy + (dz ? hi[2] : lo[2]),
                          __fmul_rn(w, m));
            }
        }
    }
}

}  // namespace

// Paint n particles (x: n x 3 float32, device) of mass `mass`, or of
// masses[i] when masses (n float32, device) is not null, onto canvas
// (nx*ny*nz float32, device, zeroed) on `stream`. Returns
// cudaGetLastError().
extern "C" int fastpm_cic_paint(const float* x, long long n, int nx, int ny,
                                int nz, float icx, float icy, float icz,
                                float mass, const float* masses,
                                float* canvas, cudaStream_t stream) {
    if (n > 0) {
        const int threads = 256;
        const long long blocks = (n + threads - 1) / threads;
        cic_paint_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, mass, masses, canvas);
    }
    return (int)cudaGetLastError();
}
