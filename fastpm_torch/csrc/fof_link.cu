// The neighbour sweep of the device friends-of-friends: for every row of
// a cell-sorted particle set, the least label over the rows within the
// linking length in the 27 linking cells around it (its own included).
// One round of the label propagation of ops/fof_device.py is this sweep,
// a scatter-min hook and four pointer-doubling compress steps.
//
// Replaces neighbor_min of fastpm_tpu/ops/fof_device.py:103-116. That is
// XLA code, not a pallas_call: it unrolls 27 x rmax gather / compare /
// min steps over all rows, which XLA fuses into one loop; eager PyTorch
// would run each step as kernels of its own (about 27 * rmax * 10
// launches and as many full passes over the rows a round).
//
// Contract: rows are sorted by their int64 cell id c = (cx * ncell + cy)
// * ncell + cz, each axis cell floor(x / cs) wrapped into [0, ncell). Row
// i links to row j by the rule of the host union-find (csrc/fof.c), so
// that the labels equal its labels: each separation is the float32
// difference widened to double, wrapped once by the box (dd > L/2: dd -
// L; dd < -L/2: dd + L), and r2 = (dx^2 + dy^2) + dz^2 in double must be
// below ll^2 (double). __dmul_rn / __dadd_rn keep nvcc from contracting
// into fused multiply-adds, which the host build does not use either.
// (The JAX package's device FOF tests float32 d^2 <= float32(ll^2)
// instead; at 16.8 M rows of a z = 0 state some pair lands between the
// two rules and the labels differ from the host's.)
//
// Design: one thread per sorted row. For each of the 27 neighbour cells
// the thread finds the cell's first row by a binary search in the sorted
// ids and walks the segment to its real end. It keeps no table of 27
// starts a row (the JAX version's 27 searchsorted arrays: 1.8 GB at
// 16.8 M rows) and has no occupancy cap: a crowded cell costs time, not
// links. Neighbouring threads hold rows of the same cell, so their
// searches and segment walks read the same cache lines.
//
// What bounds it on an H100: device-memory bytes. Each row's position
// (12 B) and label (4 B) are read once and its new label (4 B) written
// once, 20 B a row (0.10 ms a round at 16.8 M rows and 3.35 TB/s); the
// re-reads of neighbours' rows come from L1 / L2 while the sorted rows
// keep a cell's segment together.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// First index in [0, n) with ids[index] >= key (n when none).
__device__ __forceinline__ long long lower_bound(const long long* ids,
                                                 long long n,
                                                 long long key) {
    long long lo = 0, hi = n;
    while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (ids[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

__device__ __forceinline__ double wrap_sep(float d, double L, double Lh) {
    double dd = (double)d;
    if (dd > Lh) dd = __dsub_rn(dd, L);
    if (dd < -Lh) dd = __dadd_rn(dd, L);
    return dd;
}

__global__ void neighbor_min_kernel(const float* __restrict__ x,
                                    const long long* __restrict__ cid,
                                    const int* __restrict__ lab,
                                    long long n, long long ncell, double L,
                                    double ll2, int* __restrict__ out) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const long long c = cid[i];
    const long long cz = c % ncell;
    const long long cy = (c / ncell) % ncell;
    const long long cx = c / (ncell * ncell);
    const float xi = x[3 * i], yi = x[3 * i + 1], zi = x[3 * i + 2];
    const double Lh = 0.5 * L;
    int best = lab[i];
    for (int ox = -1; ox <= 1; ++ox) {
        const long long nx = (cx + ox + ncell) % ncell;
        for (int oy = -1; oy <= 1; ++oy) {
            const long long ny = (cy + oy + ncell) % ncell;
            for (int oz = -1; oz <= 1; ++oz) {
                const long long nz = (cz + oz + ncell) % ncell;
                const long long key = (nx * ncell + ny) * ncell + nz;
                for (long long j = lower_bound(cid, n, key);
                     j < n && cid[j] == key; ++j) {
                    const double dx =
                        wrap_sep(__fsub_rn(xi, x[3 * j]), L, Lh);
                    const double dy =
                        wrap_sep(__fsub_rn(yi, x[3 * j + 1]), L, Lh);
                    const double dz =
                        wrap_sep(__fsub_rn(zi, x[3 * j + 2]), L, Lh);
                    const double r2 = __dadd_rn(
                        __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
                        __dmul_rn(dz, dz));
                    if (r2 < ll2) best = min(best, lab[j]);
                }
            }
        }
    }
    out[i] = best;
}

}  // namespace

// out[i] = the least of lab[i] and lab[j] over every row j within the
// linking length of row i (see the contract above). x: n x 3 float32,
// cid: n int64 sorted ascending, lab and out: n int32, all on the
// device; ncell^3 cells of a periodic box of side L; ll2 the squared
// linking length (double). Returns cudaGetLastError().
extern "C" int fastpm_fof_neighbor_min(const float* x, const long long* cid,
                                       const int* lab, long long n,
                                       long long ncell, double L, double ll2,
                                       int* out, cudaStream_t stream) {
    if (n > 0) {
        const unsigned int blocks =
            (unsigned int)((n + THREADS - 1) / THREADS);
        neighbor_min_kernel<<<blocks, THREADS, 0, stream>>>(
            x, cid, lab, n, ncell, L, ll2, out);
    }
    return (int)cudaGetLastError();
}
