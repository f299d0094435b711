// K3: CIC paint of particles in any order, with a scalar mass or a
// per-particle mass column, added into a canvas the caller owns.
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel
// (reached through make_paint_fn), the 8-pass deposit over a
// (window x corner) grid that first sorts the unsorted particles by cell
// and contracts one-hot masks on the MXU. The multi-species force paints
// every species into one canvas through it (fastpm_tpu/gravity.py:
// paint_delta_k): CDM with its scalar mass, ncdm with a mass column.
//
// Contract: the base cell, fraction and 8 corner weights of
// cic_common.cuh, times the particle's mass (masses[i] where masses is
// not null, else `mass`), ADDED into canvas. The kernel never zeroes the
// canvas, so species accumulate by calling it once each. On the TPU the
// sort exists because scatter is slow there; here one thread per
// particle with 8 float atomicAdds computes the same sum in any order,
// so there is no sort.
//
// What bounds it on an H100: atomic throughput. Particles come in store
// order, not cell order, so the 8 atomics of a warp's threads scatter
// over the whole canvas (537 MB at 512^3, ten times the L2) and most of
// them miss L2; the byte bound (12-16 B per particle, the canvas read
// and written once) is far below that. Binning by cell in shared memory
// or sorting first are left for later work.
//
// f32 atomics land in an order that changes from run to run, so the
// result differs in the last bits between runs.

#include "cic_common.cuh"

namespace {

__global__ void cic_paint_into_kernel(const float* __restrict__ x,
                                      long long n, int nx, int ny, int nz,
                                      float icx, float icy, float icz,
                                      float mass,
                                      const float* __restrict__ masses,
                                      float* __restrict__ canvas) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fastpm_cic::deposit(x + 3 * i, nx, ny, nz, icx, icy, icz,
                        masses ? masses[i] : mass, canvas);
}

}  // namespace

// Add n particles (x: n x 3 float32, device) of mass `mass`, or of
// masses[i] when masses (n float32, device) is not null, into canvas
// (nx*ny*nz float32, device; not zeroed here) on `stream`. Returns
// cudaGetLastError().
extern "C" int fastpm_cic_paint_into(const float* x, long long n, int nx,
                                     int ny, int nz, float icx, float icy,
                                     float icz, float mass,
                                     const float* masses, float* canvas,
                                     cudaStream_t stream) {
    if (n > 0) {
        const int threads = 256;
        const long long blocks = (n + threads - 1) / threads;
        cic_paint_into_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, mass, masses, canvas);
    }
    return (int)cudaGetLastError();
}
