// K5: CIC paint in two passes, one per x plane of the cloud: 4 corners
// a pass, with a scalar mass or a mass column, added into a canvas the
// caller owns (a periodic mesh, or one rank's extended x-slab).
//
// Replaces the TPU kernel fastpm_tpu/ops/paint_pallas.py:_paint_kernel4,
// the 4-corners-per-pass deposit (pass p = dx scatters the corner
// quadruple (0, 1, nzp, nzp + 1) of cell-sorted particles into halo'd
// window accumulators on the MXU). Two factories reach it:
// make_paint_from4_fn (a periodic mesh) and make_paint_from4_homed_fn
// (the homed slab force's extended slab, open in x, mass column through
// w8T_m), which the homed force takes with homed_kernel="from4".
//
// Contract: the same function as K1 (cic_paint.cu): the base cell,
// fraction and corner weights of cic_common.cuh times the mass, added
// into the canvas; in the homed form a particle beyond the slab deposits
// nothing and is counted in *bad. Pass dx of particle i is thread i of
// grid row blockIdx.y = dx: 2N threads with 4 atomics each, where K1 has
// N threads with 8. The split keeps a thread's atomics on one x plane
// (two rows of the canvas, 8-16 bytes apart in z); whether that pays
// against K1 on this card is measured in PERF.md, not assumed.
//
// What bounds it on an H100: as K1, device-memory bytes and atomic
// throughput; each pass recomputes the cell and fraction (12 B read per
// particle per pass, from L2 for the second).
//
// f32 atomics land in an order that changes from run to run, so the
// result differs in the last bits between runs.

#include "cic_common.cuh"

namespace {

using fastpm_cic::XAxis;

__global__ void cic_paint4_kernel(const float* __restrict__ x, long long n,
                                  int nx, int ny, int nz,
                                  float icx, float icy, float icz,
                                  XAxis ax, float mass,
                                  const float* __restrict__ masses,
                                  float* __restrict__ canvas,
                                  int* __restrict__ bad) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int dx = blockIdx.y;
    if (i >= n) return;
    int lo[3], hi[3];
    float f[3], t[3];
    if (!fastpm_cic::cell(x, i, nx, ny, nz, icx, icy, icz, ax, lo, hi, f,
                          t)) {
        if (dx == 0) atomicAdd(bad, 1);
        return;
    }
    size_t idx[4];
    float w[4];
    fastpm_cic::plane_corners(dx, lo, hi, f, t, ny, nz, idx, w);
    const float m = masses ? masses[i] : mass;
    for (int c = 0; c < 4; ++c) atomicAdd(canvas + idx[c], __fmul_rn(w[c], m));
}

}  // namespace

// Add n particles (x: n x 3 float32, device) of mass `mass`, or of
// masses[i] when masses is not null, into canvas (nx*ny*nz float32,
// device; not zeroed here) on `stream`. n0 == 0: periodic in x. n0 > 0:
// the extended slab, open in x over a global mesh of n0 planes with
// shift H - r0, and the count of particles beyond it is added to *bad
// (one int32, device). Returns cudaGetLastError().
extern "C" int fastpm_cic_paint4(const float* x, long long n, int nx,
                                 int ny, int nz, float icx, float icy,
                                 float icz, int n0, int shift, float mass,
                                 const float* masses, float* canvas,
                                 int* bad, cudaStream_t stream) {
    if (n0 < 0 || (n0 > 0 && nx < 2)) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int threads = 256;
        const dim3 blocks((unsigned int)((n + threads - 1) / threads), 2);
        cic_paint4_kernel<<<blocks, threads, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, XAxis{n0, shift}, mass, masses,
            canvas, bad);
    }
    return (int)cudaGetLastError();
}
