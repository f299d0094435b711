// K1: CIC paint (mass deposit) of cell-sorted particles onto a periodic
// mesh, for the single-species order-free force.
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel8
// (reached through make_paint_from8_fn), the one-pass deposit of
// cell-sorted particles into two dx streams with a halo carry between
// windows and a padded-face fold done by the caller.
//
// Contract (the from8 path's, not its TPU mechanism): the base cell,
// fraction and 8 corner weights of cic_common.cuh, times the species'
// scalar mass. There are no windows, no range table, no packed cw9
// operand and no face fold: periodic indices go straight into the
// (nx, ny, nz) canvas.
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

#include "cic_common.cuh"

namespace {

__global__ void cic_paint_kernel(const float* __restrict__ x, long long n,
                                 int nx, int ny, int nz,
                                 float icx, float icy, float icz,
                                 float mass, float* __restrict__ canvas) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fastpm_cic::deposit(x, i, nx, ny, nz, icx, icy, icz, mass, canvas);
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
