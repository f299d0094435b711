// K1: CIC paint (mass deposit) of particles in cell order, for the
// single-species order-free force: onto a periodic mesh, or, homed, into
// one rank's extended x-slab. The result is right in any order; cell
// order only buys locality (the stale force paints in the order of an
// earlier sort, which the particles have drifted from).
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel8,
// the one-pass deposit of cell-sorted particles into two dx streams with
// a halo carry between windows and a padded-face fold done by the
// caller. Two factories reach it: make_paint_from8_fn (the periodic
// mesh) and make_paint_from8_homed_fn (the homed slab force's extended
// slab, open in x, with a scalar mass or a mass column).
//
// Contract (the from8 factories', not their TPU mechanism): the base
// cell, fraction and 8 corner weights of cic_common.cuh, times the
// species' mass. There are no windows, no range table, no packed cw9
// operand and no face fold: periodic indices go straight into the
// canvas. In the homed form the x index is the extended-slab plane of
// cic_common.cuh; a particle beyond the slab deposits nothing and is
// counted in *bad (the overflow contract of the homed force).
//
// What bounds it on an H100: device-memory bytes (12 B read per
// particle, the canvas written once) and, under clustering, atomic
// throughput on hot cells. One thread per particle with 8 float
// atomicAdds. The caller passes particles sorted by cell, so the
// threads of a warp touch neighbouring canvas lines and most atomics
// resolve in L2. Shared-memory tiling over the sorted order and warp
// aggregation of atomics are left for later work.
//
// The canvas must be zeroed by the caller (the homed form adds into it,
// so species accumulate). f32 atomics land in an order that changes from
// run to run, so the result differs in the last bits between runs.

#include "cic_common.cuh"

namespace {

using fastpm_cic::XAxis;

__global__ void cic_paint_kernel(const float* __restrict__ x, long long n,
                                 int nx, int ny, int nz,
                                 float icx, float icy, float icz,
                                 float mass, float* __restrict__ canvas) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fastpm_cic::deposit(x + 3 * i, nx, ny, nz, icx, icy, icz, mass,
                        canvas);
}

__global__ void cic_paint_homed_kernel(const float* __restrict__ x,
                                       long long n, int nx, int ny, int nz,
                                       float icx, float icy, float icz,
                                       XAxis ax, float mass,
                                       const float* __restrict__ masses,
                                       float* __restrict__ canvas,
                                       int* __restrict__ bad) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fastpm_cic::deposit(x + 3 * i, nx, ny, nz, icx, icy, icz,
                        masses ? masses[i] : mass, canvas, ax, bad);
}

}  // namespace

// Paint n particles (x: n x 3 float32, device) of mass `mass` onto
// canvas (nx*ny*nz float32, device, zeroed) on `stream`. Returns
// cudaGetLastError().
extern "C" int fastpm_cic_paint(const float* x, long long n, int nx, int ny,
                                int nz, float icx, float icy, float icz,
                                float mass, float* canvas,
                                cudaStream_t stream) {
    if (n > 0) {
        const int threads = 256;
        const long long blocks = (n + threads - 1) / threads;
        cic_paint_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, mass, canvas);
    }
    return (int)cudaGetLastError();
}

// Add n particles of mass `mass`, or of masses[i] when masses is not
// null, into the extended slab canvas (nx*ny*nz float32, device; not
// zeroed here), open in x over a global mesh of n0 > 0 planes with shift
// H - r0; add the count of particles beyond the slab to *bad (one int32,
// device). Returns cudaGetLastError().
extern "C" int fastpm_cic_paint_homed(const float* x, long long n, int nx,
                                      int ny, int nz, float icx, float icy,
                                      float icz, int n0, int shift,
                                      float mass, const float* masses,
                                      float* canvas, int* bad,
                                      cudaStream_t stream) {
    if (n0 <= 0 || nx < 2) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int threads = 256;
        const long long blocks = (n + threads - 1) / threads;
        cic_paint_homed_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, XAxis{n0, shift}, mass, masses,
            canvas, bad);
    }
    return (int)cudaGetLastError();
}
