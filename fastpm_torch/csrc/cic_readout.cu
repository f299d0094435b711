// K2 and K4: CIC readout (gather) of 1 to 3 periodic mesh fields at
// particles in any order.
//
// Replaces two TPU kernels:
// - K2 fastpm_tpu/ops/readout_pallas.py:_readout_kernel8 (reached through
//   make_readout3_from8_fn), the one-pass 3-component gather of
//   cell-sorted particles from wrap-padded canvas windows: the
//   order-free force's readout and, with one field, the 2LPT readouts;
// - K4 readout_pallas.py:_readout_kernel (reached through
//   make_readout3_fn), which sorts unsorted particles by cell, gathers 24
//   per-corner rows from canvas windows on the MXU, sums them and sorts
//   the values back: the multi-species force's readout, once per species.
//
// Contract: the base cell, fraction and corner weights of cic_common.cuh;
// out[i, c] = sum over the 8 corners of w * field_c at the periodically
// wrapped corner. No wrap-padded canvases, windows or range tables: the
// periodic wrap is index arithmetic. Thread i writes row i, so K4's rows
// come back in the caller's order with no sort and no unsort.
//
// What bounds it on an H100: device-memory bytes when the particles are
// sorted by cell (the carry force sorts them; the 2LPT readouts come in
// lattice order), as the 8 corner loads of neighbouring threads share
// cache lines in L1/L2; the latency of scattered loads when they are not
// (a random store order misses L2 on most of its 24 loads per particle).
// One thread per particle computes the 8 indices and weights once and
// reuses them for every field. Staging canvas tiles in shared memory, or
// binning unsorted particles by cell first, is left for later work.

#include "cic_common.cuh"

namespace {

__global__ void cic_readout_kernel(const float* __restrict__ x, long long n,
                                   int nx, int ny, int nz,
                                   float icx, float icy, float icz,
                                   const float* __restrict__ f0,
                                   const float* __restrict__ f1,
                                   const float* __restrict__ f2, int k,
                                   float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    size_t idx[8];
    float w[8];
    fastpm_cic::corners(x, i, nx, ny, nz, icx, icy, icz, idx, w);
    const float* fields[3] = {f0, f1, f2};
    for (int comp = 0; comp < k; ++comp)
        out[i * k + comp] = fastpm_cic::gather(fields[comp], idx, w);
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
