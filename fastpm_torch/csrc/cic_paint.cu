// K1: CIC paint (mass deposit) of particles in cell order, for the
// single-species order-free force: onto a periodic mesh, or, homed, into
// one rank's extended x-slab or, for the pencil force, extended pencil. The result is right in any order; cell
// order only buys locality (the stale force paints in the order of an
// earlier sort, which the particles have drifted from).
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel8,
// the one-pass deposit of cell-sorted particles into two dx streams with
// a halo carry between windows and a padded-face fold done by the
// caller. Two factories reach it: make_paint_from8_fn (the periodic
// mesh) and make_paint_from8_homed_fn (the homed slab force's extended
// slab, open in x, with a scalar mass or a mass column; with open_y the
// pencil force's extended pencil, open in x and y, z alone folded).
//
// Contract (the from8 factories', not their TPU mechanism): the base
// cell, fraction and 8 corner weights of cic_common.cuh, times the
// species' mass. There are no windows, no range table, no packed cw9
// operand and no face fold: periodic indices go straight into the
// canvas. In the homed form the x index is the extended-slab plane of
// cic_common.cuh (and with an open y the y index the extended-pencil
// row); a particle beyond the slab or pencil deposits nothing and is
// counted in *bad (the overflow contract of the homed force). The open y
// is a launch parameter of the same body (n1 > 0).
//
// What bounds it on an H100: the canvas's read-modify-writes in L2, and
// under clustering the atomics that pile onto hot cells. Both forms run
// the tiled deposit of cic_deposit.cuh: a block gathers 1024 rows' 8
// corners in a shared-memory tile of their footprint and adds the tile
// into the canvas once, in float4 reductions of whole lines; rows whose
// footprint does not fit take one global atomic a corner. The TPU
// kernel's windows over the sorted order become the chunks' footprints.
//
// The canvas must be zeroed by the caller (the homed form adds into it,
// so species accumulate). f32 atomics land in an order that changes from
// run to run, so the result differs in the last bits between runs.

#include "cic_deposit.cuh"

using fastpm_cic::Deposit;
using fastpm_cic::OpenAxes;

// Paint n particles (x: n x 3 float32, device) of mass `mass` onto
// canvas (nx*ny*nz float32, device, zeroed) on `stream`. Returns
// cudaGetLastError().
extern "C" int fastpm_cic_paint(const float* x, long long n, int nx, int ny,
                                int nz, float icx, float icy, float icz,
                                float mass, float* canvas,
                                cudaStream_t stream) {
    return fastpm_cic::launch_deposit(
        Deposit{x, nullptr, n, nx, ny, nz, icx, icy, icz, OpenAxes{0, 0}, mass,
                nullptr, canvas, nullptr, fastpm_cic::deposit_vec(nz, canvas)},
        stream);
}

// Add n particles of mass `mass`, or of masses[i] when masses is not
// null, into the extended slab canvas (nx*ny*nz float32, device; not
// zeroed here), open in x over a global mesh of n0 > 0 planes with shift
// H - r0, and with n1 > 0 also open in y over a global mesh of n1 rows
// with shift Hy - r0y (the extended pencil); add the count of particles
// beyond it to *bad (one int32, device). Returns cudaGetLastError().
extern "C" int fastpm_cic_paint_homed(const float* x, long long n, int nx,
                                      int ny, int nz, float icx, float icy,
                                      float icz, int n0, int shift, int n1,
                                      int yshift, float mass,
                                      const float* masses, float* canvas,
                                      int* bad, cudaStream_t stream) {
    if (n0 <= 0 || nx < 2 || n1 < 0 || (n1 > 0 && ny < 2))
        return (int)cudaErrorInvalidValue;
    return fastpm_cic::launch_deposit(
        Deposit{x, nullptr, n, nx, ny, nz, icx, icy, icz,
                OpenAxes{n0, shift, n1, yshift},
                mass, masses, canvas, bad,
                fastpm_cic::deposit_vec(nz, canvas)},
        stream);
}
