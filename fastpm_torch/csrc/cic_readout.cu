// K2 and K4: CIC readout (gather) of 1 to 3 mesh fields at particles in
// any order: periodic fields, or, homed, one rank's extended x-slabs.
//
// Replaces two TPU kernels:
// - K2 fastpm_tpu/ops/readout_pallas.py:_readout_kernel8, the one-pass
//   3-component gather of cell-sorted particles from wrap-padded canvas
//   windows. make_readout3_from8_fn reaches it for the order-free force's
//   readout and, with one field, the 2LPT readouts;
//   make_readout3_from8_homed_fn for the homed slab force's readout from
//   the extended slabs (open in x);
// - K4 readout_pallas.py:_readout_kernel (reached through
//   make_readout3_fn), which sorts unsorted particles by cell, gathers 24
//   per-corner rows from canvas windows on the MXU, sums them and sorts
//   the values back: the multi-species force's readout, once per species.
//
// Contract: the base cell, fraction and corner weights of cic_common.cuh;
// out[i, c] = sum over the 8 corners of w * field_c at the corner. No
// wrap-padded canvases, windows or range tables: the periodic wrap is
// index arithmetic. In the homed form a particle beyond the slab reads
// zero (its paint counted it). Thread i writes row i, so K4's rows come
// back in the caller's order with no sort and no unsort.
//
// What bounds it on an H100: device-memory bytes when the particles are
// sorted by cell (the carry force sorts them, the stale force reads out
// in the order of an earlier sort, the 2LPT readouts come in lattice
// order), as the 8 corner loads of neighbouring threads share
// cache lines in L1/L2; the latency of scattered loads when they are not
// (a random store order misses L2 on most of its 24 loads per particle).
// One thread per particle computes the 8 indices and weights once and
// reuses them for every field. Staging canvas tiles in shared memory, or
// binning unsorted particles by cell first, is left for later work.

#include "cic_common.cuh"

namespace {

using fastpm_cic::XAxis;

template <bool OPEN_X>
__global__ void cic_readout_kernel(const float* __restrict__ x, long long n,
                                   int nx, int ny, int nz,
                                   float icx, float icy, float icz,
                                   XAxis ax,
                                   const float* __restrict__ f0,
                                   const float* __restrict__ f1,
                                   const float* __restrict__ f2, int k,
                                   float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    size_t idx[8];
    float w[8];
    const float* fields[3] = {f0, f1, f2};
    if (!fastpm_cic::corners(x, i, nx, ny, nz, icx, icy, icz, idx, w,
                             OPEN_X ? ax : XAxis{0, 0})) {
        for (int comp = 0; comp < k; ++comp) out[i * k + comp] = 0.0f;
        return;
    }
    for (int comp = 0; comp < k; ++comp)
        out[i * k + comp] = fastpm_cic::gather(fields[comp], idx, w);
}

int launch(const float* x, long long n, int nx, int ny, int nz, float icx,
           float icy, float icz, XAxis ax, const float* f0,
           const float* f1, const float* f2, int k, float* out,
           cudaStream_t stream) {
    if (k < 1 || k > 3) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int threads = 256;
        const unsigned int blocks =
            (unsigned int)((n + threads - 1) / threads);
        if (ax.n0 > 0)
            cic_readout_kernel<true><<<blocks, threads, 0, stream>>>(
                x, n, nx, ny, nz, icx, icy, icz, ax, f0, f1, f2, k, out);
        else
            cic_readout_kernel<false><<<blocks, threads, 0, stream>>>(
                x, n, nx, ny, nz, icx, icy, icz, ax, f0, f1, f2, k, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Read k (1..3) periodic fields (each nx*ny*nz float32, device) at n
// particles (x: n x 3 float32, device) into out (n x k float32, device)
// on `stream`. Unused field pointers may be null. Returns
// cudaGetLastError().
extern "C" int fastpm_cic_readout(const float* x, long long n, int nx,
                                  int ny, int nz, float icx, float icy,
                                  float icz, const float* f0,
                                  const float* f1, const float* f2, int k,
                                  float* out, cudaStream_t stream) {
    return launch(x, n, nx, ny, nz, icx, icy, icz, XAxis{0, 0}, f0, f1, f2,
                  k, out, stream);
}

// The homed form: the fields are extended slabs (nx*ny*nz), open in x
// over a global mesh of n0 > 0 planes with shift H - r0.
extern "C" int fastpm_cic_readout_homed(const float* x, long long n, int nx,
                                        int ny, int nz, float icx,
                                        float icy, float icz, int n0,
                                        int shift, const float* f0,
                                        const float* f1, const float* f2,
                                        int k, float* out,
                                        cudaStream_t stream) {
    if (n0 <= 0 || nx < 2) return (int)cudaErrorInvalidValue;
    return launch(x, n, nx, ny, nz, icx, icy, icz, XAxis{n0, shift}, f0, f1,
                  f2, k, out, stream);
}
