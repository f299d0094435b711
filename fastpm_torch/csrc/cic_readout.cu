// K2: CIC readout (gather) of 1 to 3 periodic mesh fields at particles.
//
// Replaces the TPU kernel fastpm_tpu/ops/readout_pallas.py:_readout_kernel8
// (reached through make_readout3_from8_fn), the one-pass 3-component
// gather of cell-sorted particles from wrap-padded canvas windows.
//
// Contract: the same base cell, fraction and corner weights as K1
// (cic_paint.cu); out[i, c] = sum over the 8 corners of w * field_c at the
// periodically wrapped corner. No wrap-padded canvases, windows or range
// tables: the periodic wrap is index arithmetic.
//
// What bounds it on an H100: device-memory bytes. Each field is read
// once if the particles are sorted by cell (the caller sorts them), so
// the 8 corner loads of neighbouring threads share cache lines in L1/L2.
// One thread per particle computes the 8 indices and weights once and
// reuses them for every field. Staging canvas tiles in shared memory
// over the sorted order is left for later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap_cell(int i, int n) {
    int r = i % n;
    return r < 0 ? r + n : r;
}

__global__ void cic_readout_kernel(const float* __restrict__ x, long long n,
                                   int nx, int ny, int nz,
                                   float icx, float icy, float icz,
                                   const float* __restrict__ f0,
                                   const float* __restrict__ f1,
                                   const float* __restrict__ f2, int k,
                                   float* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
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
    size_t idx[8];
    float w[8];
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
    const float* fields[3] = {f0, f1, f2};
    for (int comp = 0; comp < k; ++comp) {
        const float* fc = fields[comp];
        float acc = 0.0f;
        for (int j = 0; j < 8; ++j) acc += w[j] * __ldg(fc + idx[j]);
        out[i * k + comp] = acc;
    }
}

}  // namespace

// Read k (1..3) fields (each nx*ny*nz float32, device) at n particles
// (x: n x 3 float32, device) into out (n x k float32, device) on
// `stream`. Unused field pointers may be null. Returns cudaGetLastError().
extern "C" int fastpm_cic_readout(const float* x, long long n, int nx,
                                  int ny, int nz, float icx, float icy,
                                  float icz, const float* f0,
                                  const float* f1, const float* f2, int k,
                                  float* out, cudaStream_t stream) {
    if (k < 1 || k > 3) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int threads = 256;
        const long long blocks = (n + threads - 1) / threads;
        cic_readout_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, f0, f1, f2, k, out);
    }
    return (int)cudaGetLastError();
}
