// K3: CIC paint of particles in any order, with a scalar mass or a
// per-particle mass column, added into a canvas the caller owns.
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel
// (reached through make_paint_fn, and through make_paint_from_fn with a
// sort prepared by the caller), the 8-pass deposit over a
// (window x corner) grid that first sorts the unsorted particles by cell
// and contracts one-hot masks on the MXU. The multi-species force paints
// every species into one canvas through it (fastpm_tpu/gravity.py:
// paint_delta_k): CDM with its scalar mass, ncdm with a mass column.
//
// Contract: the base cell, fraction and 8 corner weights of
// cic_common.cuh, times the particle's mass (masses[i] where masses is
// not null, else `mass`), ADDED into canvas. The kernel never zeroes the
// canvas, so species accumulate by calling it once each.
//
// What bounds it on an H100: in store order the 8 atomics of a warp's
// threads scatter over the whole canvas (537 MB at 512^3, ten times the
// L2), and most of them miss L2. So K3 keeps the TPU kernel's order of
// work: its wrapper (ops/cic.py:cic_paint_into) puts the rows in cell
// order first (csrc/cic_bin.cu's counting sort by line), or takes the
// order the caller already has (the multi-species force computes it
// once per species and reads out in it too). This kernel then runs K1's
// tiled deposit (cic_deposit.cuh) on the rows in that order, reading
// each row's position and mass through the index, so nothing is
// gathered into a copy first. It is right in any order: rows in
// another order would only be slower.
//
// f32 atomics land in an order that changes from run to run, so the
// result differs in the last bits between runs.

#include "cic_deposit.cuh"

using fastpm_cic::Deposit;
using fastpm_cic::XAxis;

// Add n particles (x: n x 3 float32, device) of mass `mass`, or of
// masses[i] when masses (n float32, device) is not null, into canvas
// (nx*ny*nz float32, device; not zeroed here) on `stream`, taking them
// in the order of the n int64 indices `order` (device) where it is not
// null. Returns cudaGetLastError().
extern "C" int fastpm_cic_paint_into(const float* x, long long n, int nx,
                                     int ny, int nz, float icx, float icy,
                                     float icz, float mass,
                                     const float* masses,
                                     const long long* order, float* canvas,
                                     cudaStream_t stream) {
    return fastpm_cic::launch_deposit(
        Deposit{x, order, n, nx, ny, nz, icx, icy, icz, XAxis{0, 0}, mass,
                masses, canvas, nullptr, fastpm_cic::deposit_vec(nz, canvas)},
        stream);
}
