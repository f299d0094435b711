// K5: CIC paint of the TPU's two-pass deposit (4 corners a pass, one per
// x plane of the cloud), with a scalar mass or a mass column, added into
// a canvas the caller owns (a periodic mesh, or one rank's extended
// x-slab or extended pencil).
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel4,
// the 4-corners-per-pass deposit (pass p = dx scatters the corner
// quadruple (0, 1, nzp, nzp + 1) of cell-sorted particles into halo'd
// window accumulators on the MXU). Two factories reach it:
// make_paint_from4_fn (a periodic mesh) and make_paint_from4_homed_fn
// (the homed slab force's extended slab, open in x, mass column through
// w8T_m; with open_y the pencil force's extended pencil, open in x and
// y), which the homed forces take with homed_kernel="from4".
//
// Contract: the same function as K1 (cic_paint.cu): the base cell,
// fraction and corner weights of cic_common.cuh times the mass, added
// into the canvas; in the homed form a particle beyond the slab deposits
// nothing and is counted in *bad, once. The two passes only order the
// additions, and f32 atomics fix no order anyway.
//
// What bounds it on an H100: as K1, the reductions the canvas takes in
// L2. So K5 runs K1's tiled deposit (cic_deposit.cuh) over both planes
// in one launch, as K6 runs K2's readout. A split by plane (two blocks a
// chunk, each depositing one plane's 4 corners through a footprint of
// one plane's lines, the TPU kernel's two passes) was built and timed
// against it on the same rows: 1.11 against 0.89 ms on the slab force's
// 16.8 M rows, since each block computes every row's cell and flushes
// its own footprint (PERF.md).
//
// f32 atomics land in an order that changes from run to run, so the
// result differs in the last bits between runs.

#include "cic_deposit.cuh"

using fastpm_cic::Deposit;
using fastpm_cic::OpenAxes;

// Add n particles (x: n x 3 float32, device) of mass `mass`, or of
// masses[i] when masses is not null, into canvas (nx*ny*nz float32,
// device; not zeroed here) on `stream`. n0 == 0: periodic in x. n0 > 0:
// the extended slab, open in x over a global mesh of n0 planes with
// shift H - r0 (n1 > 0: the extended pencil, also open in y over a
// global mesh of n1 rows with shift Hy - r0y), and the count of
// particles beyond it is added to *bad (one int32, device). Returns
// cudaGetLastError().
extern "C" int fastpm_cic_paint4(const float* x, long long n, int nx,
                                 int ny, int nz, float icx, float icy,
                                 float icz, int n0, int shift, int n1,
                                 int yshift, float mass,
                                 const float* masses, float* canvas,
                                 int* bad, cudaStream_t stream) {
    if (n0 < 0 || (n0 > 0 && nx < 2) || n1 < 0 || (n1 > 0 && n0 == 0)
        || (n1 > 0 && ny < 2))
        return (int)cudaErrorInvalidValue;
    return fastpm_cic::launch_deposit(
        Deposit{x, nullptr, n, nx, ny, nz, icx, icy, icz,
                OpenAxes{n0, shift, n1, yshift},
                mass, masses, canvas, n0 > 0 ? bad : nullptr,
                fastpm_cic::deposit_vec(nz, canvas)},
        stream);
}
