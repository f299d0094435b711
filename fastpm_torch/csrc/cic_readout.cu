// K2, K4 and K6: CIC readout (gather) of 1 to 3 mesh fields at particles
// in any order, periodic fields, one rank's extended x-slabs, or (the
// pencil force) its extended pencils, in one pass over the fields.
//
// Replaces three TPU kernels of fastpm_tpu/ops/readout_pallas.py:
// - K2 _readout_kernel8 (:836), the one-pass gather of cell-sorted
//   particles from wrap-padded canvas windows. make_readout3_from8_fn
//   (:1248) reaches it for the order-free force's readout and, with one
//   field, the 2LPT readouts; make_readout3_from8_homed_fn (:764) for the
//   homed slab force's readout from the extended slabs (open in x), and
//   with open_y the pencil force's from the extended pencils (open in x
//   and y: the index and validity test of cic_common.cuh, a launch
//   parameter of the same body);
// - K6 _readout_kernel4 (:371), which gathers the 4 corners of each x
//   plane of the cloud in a pass of its own, the caller adding the two
//   passes (:1416-1419): make_readout3_from4_fn (:659) and
//   make_readout3_from4_homed_fn (:1354);
// - K4 _readout_kernel (:48, through make_readout3_fn, :186), which sorts
//   unsorted particles by cell, gathers 24 per-corner rows on the MXU and
//   sorts the values back: the multi-species force's readout, once per
//   species, in store order.
//
// Contract: the base cell, fraction and corner weights ((wx * wy) * wz)
// of cic_common.cuh; out[i, c] = the sum over the 8 corners (dx-major)
// of w * field_c at the corner (K2, K4), or the sum over x plane 0's 4
// corners plus the sum over plane 1's (K6). Every product and sum is
// rounded on its own in the plain version's order (no fused
// multiply-add), so the result equals ops/cic.py's plain version bit
// for bit. In the homed form a particle beyond the slab or pencil reads
// zero (its paint counted it). Row i of the output is particle i's, so K4's rows
// come back in the caller's order with no sort and no unsort.
//
// What bounds it on an H100: device-memory bytes. The fields read once,
// the positions read once, the values written once: at 256^3 particles
// on 512^3 with three fields 2.0 GB, 0.60 ms at 3.35 TB/s. The gathers
// come close to that only where the 8 corner loads of neighbouring
// threads share cache lines in L1 and L2: particles in cell order (the
// carry force sorts them, the stale force reads out in the order of an
// earlier sort, the 2LPT readouts come in lattice order). In store
// order (K4) most of the 24 loads of a particle miss L2, and latency
// bounds it. The design:
// 1. One pass. A thread computes its particle's cell, 8 corner indices
//    and 8 weights once (cell() and corners() of cic_common.cuh, as the
//    paints) and sums every field from them. K6's two planes are two
//    running sums in registers, added at the end: no second pass over
//    the fields and no partial buffer (TWO_PLANES).
// 2. Little work beside the loads: int32 flat indices and the
//    compare-and-add wrap of cic_common.cuh; a block's positions come
//    in, and its (n, k) values go out, through shared memory in
//    coalesced 16-byte accesses.
// 3. Few lines in flight, so L1 keeps the ones that neighbouring
//    particles' corners share. A thread gathers one field at a time:
//    its 8 loads are summed before the next field's issue, so it holds
//    8 lines in flight, not 24. Five blocks of 256 threads an SM
//    (__launch_bounds__): against 6 (the compiler's own choice) fewer
//    lines in flight, against 4 or fewer too few loads to cover the
//    latency in cell order. Against all 24 loads at once this is 2 %
//    faster in cell order, 6 % in stale order, 9 % in store order and
//    24 % on clustered store order (K4); one field at the 2LPT lattice
//    is 7 % slower (PERF.md).
// Staging the rows of a cell-sorted block in shared memory (cp.async,
// double-buffered by field) was measured against this and lost on every
// case, the 2LPT lattice included: at an eighth of a particle per cell a
// block's rows of planes x and x + 1 cost as many L2 bytes as the
// gathers, and the tile's shared memory takes L1 from them (PERF.md).

#include "cic_common.cuh"

namespace {

using fastpm_cic::OpenAxes;

constexpr int THREADS = 256;

struct Params {
    const float* x;
    long long n;
    int nx, ny, nz;
    float icx, icy, icz;
    OpenAxes ax;
    const float* f[3];
    int k;         // fields: 1 to 3
    float* out;
    bool vec;      // x and out 16-byte aligned: vector copies
};

// The weighted sum of the 8 corner values v (dx-major, then dy, then
// dz): one running sum (K2, K4) or one per x plane added at the end
// (K6), each product and sum rounded alone, as the plain version.
template <bool TWO_PLANES>
__device__ __forceinline__ float weigh(const float v[8], const float w[8]) {
    if (TWO_PLANES) {
        float a0 = 0.0f, a1 = 0.0f;
        for (int q = 0; q < 4; ++q) {
            a0 = __fadd_rn(a0, __fmul_rn(w[q], v[q]));
            a1 = __fadd_rn(a1, __fmul_rn(w[q + 4], v[q + 4]));
        }
        return __fadd_rn(a0, a1);
    }
    float acc = 0.0f;
    for (int q = 0; q < 8; ++q) acc = __fadd_rn(acc, __fmul_rn(w[q], v[q]));
    return acc;
}

// Copy m floats between device and shared memory, coalesced: 16 bytes a
// thread for a whole, aligned block, else 4.
__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int m, bool vec) {
    if (vec && m % 4 == 0) {
        for (int j = threadIdx.x; j < m / 4; j += THREADS)
            reinterpret_cast<float4*>(dst)[j] =
                reinterpret_cast<const float4*>(src)[j];
    } else {
        for (int j = threadIdx.x; j < m; j += THREADS) dst[j] = src[j];
    }
}

template <bool OPEN_X, bool TWO_PLANES>
__global__ void __launch_bounds__(THREADS, 5)
readout_kernel(const Params a) {
    __shared__ __align__(16) float pos[3 * THREADS];
    __shared__ __align__(16) float val[3 * THREADS];
    const int tid = threadIdx.x;
    const long long start = (long long)blockIdx.x * THREADS;
    const int cnt = (int)min((long long)THREADS, a.n - start);

    copy_block(pos, a.x + 3 * start, 3 * cnt, a.vec);
    __syncthreads();
    int idx[8];
    float w[8];
    const bool inside =
        tid < cnt && fastpm_cic::corners(pos + 3 * tid, a.nx, a.ny, a.nz,
                                         a.icx, a.icy, a.icz, idx, w,
                                         OPEN_X ? a.ax : OpenAxes{0, 0});
    // one field at a time: its 8 loads are summed before the next
    // field's issue
#pragma unroll 1
    for (int k = 0; k < a.k; ++k) {
        const float* f = k == 0 ? a.f[0] : (k == 1 ? a.f[1] : a.f[2]);
        float r = 0.0f;
        if (inside) {
            float v[8];
            for (int q = 0; q < 8; ++q) v[q] = __ldg(f + idx[q]);
            r = weigh<TWO_PLANES>(v, w);
        }
        val[tid * a.k + k] = r;
    }
    __syncthreads();
    copy_block(a.out + a.k * start, val, a.k * cnt, a.vec);
}

template <bool OPEN_X, bool TWO_PLANES>
int launch_as(const Params& a, cudaStream_t stream) {
    const unsigned int blocks = (unsigned int)((a.n + THREADS - 1) / THREADS);
    readout_kernel<OPEN_X, TWO_PLANES><<<blocks, THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace

// Read k (1..3) fields (each nx*ny*nz float32, device; unused pointers
// may be null) at n particles (x: n x 3 float32, device) into out (n x k
// float32, device) on `stream`. n0 == 0: periodic in x; n0 > 0: the
// extended slab, open in x over a global mesh of n0 planes with shift
// H - r0; n1 > 0 (with n0 > 0): the extended pencil, also open in y over
// a global mesh of n1 rows with shift Hy - r0y. two_planes (k == 3
// only): K6's sum, plane by plane. Returns cudaGetLastError().
extern "C" int fastpm_cic_readout(const float* x, long long n, int nx,
                                  int ny, int nz, float icx, float icy,
                                  float icz, int n0, int shift, int n1,
                                  int yshift, int two_planes,
                                  const float* f0, const float* f1,
                                  const float* f2, int k, float* out,
                                  cudaStream_t stream) {
    if (k < 1 || k > 3 || (two_planes && k != 3) || n0 < 0
        || (n0 > 0 && nx < 2) || n1 < 0 || (n1 > 0 && n0 == 0)
        || (n1 > 0 && ny < 2))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    const Params a{x, n, nx, ny, nz, icx, icy, icz,
                   OpenAxes{n0, shift, n1, yshift},
                   {f0, f1, f2}, k, out, aligned16(x) && aligned16(out)};
    const bool open = n0 > 0;
    if (two_planes)
        return open ? launch_as<true, true>(a, stream)
                    : launch_as<false, true>(a, stream);
    return open ? launch_as<true, false>(a, stream)
                : launch_as<false, false>(a, stream);
}
