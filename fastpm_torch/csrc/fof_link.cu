// The device friends-of-friends in one sweep: a table of (x, y) columns
// built once a call, and a union-find that every linked pair hooks as
// the sweep finds it. The result is the root of each row's group, which
// is its least sorted row: ops/fof_device.py maps it to the least
// original row.
//
// Replaces neighbor_min of fastpm_tpu/ops/fof_device.py:103-116 and the
// label rounds around it (:118-136). That is XLA code, not a
// pallas_call: 27 x rmax gather / compare / min steps over all rows a
// round, then a scatter-min hook and four pointer-doubling passes, until
// a fixed point.
//
// Contract: rows are sorted by their int32 column c = cx * ncol + cy,
// each axis floor(x * inv) (float32) wrapped into [0, ncol), and within a
// column by z ascending; the columns are wider than the linking length.
// Rows i and j link by the rule of the host union-find (csrc/fof.c), so
// that the labels equal its labels: each separation is the float32
// difference widened to double, wrapped once by the box (dd > L/2: dd -
// L; dd < -L/2: dd + L), and r2 = (dx^2 + dy^2) + dz^2 in double must be
// below ll^2 (double). __dmul_rn / __dadd_rn keep nvcc from contracting
// into fused multiply-adds, which the host build does not use either.
//
// Design.
// - The table: start[c] is the first sorted row of column c (start[ncol^2]
//   = n), filled by one thread a row over the columns from its
//   predecessor's to its own; a gap of more than FILL_MAX columns is left
//   to one binary search a column in a second pass. At most one column a
//   row (ops/fof_device.py:_table_grid): the table is smaller than the
//   rows, and a neighbour column costs two loads.
// - The z window: within a column the rows are sorted by z, so a row
//   reads from each of its 9 neighbour columns only the rows with z within
//   reach = ll + margin of its own (a binary search into the column, then
//   a scan that stops past the window), and near a z face the rows at the
//   column's other end. The rows read fill 3 x 3 columns of one linking
//   length by a window of two: a pair of rows within reach is read,
//   whatever the density, and few beyond it. The margin bounds the
//   float32 rounding of the column assignment and of the differences
//   (ops/fof_device.py:_margin); where a row lies farther than reach from
//   a column face, the column beyond that face is not read. If any z lies
//   outside [0, L] (flag whole), the windows read whole columns.
// - Each pair is tested once, from its lower sorted row: a column before
//   the row's own is skipped, and in its own column the row reads only
//   past itself. A linked pair hooks the larger root under the smaller
//   with atomicCAS (ECL-CC, Jaiganesh and Burtscher, HPDC 2018), finds
//   halve their paths, and a last pass writes each row's root. Parents
//   only ever point to smaller rows, so the root of a group is its least
//   sorted row whatever order the atomics took: the labels do not depend
//   on the run.
//
// What bounds it on an H100: device-memory bytes. The sorted columns (4
// B) and positions (12 B) are read once and the roots (4 B) written once,
// 20 B a row (0.10 ms at 16.8 M rows and 3.35 TB/s); the table is
// scratch, and the neighbours' rows are read again from L1 / L2 while the
// sort keeps a column's rows together.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// a row fills at most this many table columns; longer gaps are searched
constexpr int FILL_MAX = 64;

// First index in [0, n) with ids[index] >= key (n when none).
__device__ __forceinline__ int lower_bound(const int* ids, int n, int key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (ids[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// Row k in [0, n]: start[c] = k for the columns c in (cid[k-1], cid[k]]
// (cid[-1] = -1, cid[n] = ncols), unless they are more than FILL_MAX;
// parent[k] = k.
__global__ void fill_kernel(const int* __restrict__ cid, int n, int ncols,
                            int* __restrict__ start,
                            int* __restrict__ parent) {
    const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (k > n) return;
    if (k < n) parent[k] = (int)k;
    const int lo = k == 0 ? 0 : cid[k - 1] + 1;
    const int hi = k == n ? ncols : cid[k];
    if (hi - lo < FILL_MAX)
        for (int c = lo; c <= hi; ++c) start[c] = (int)k;
}

// The columns a long gap left unset (start[c] < 0) take a binary search.
__global__ void gap_kernel(const int* __restrict__ cid, int n, int ncols,
                           int* __restrict__ start) {
    const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (c > ncols || start[c] >= 0) return;
    start[c] = lower_bound(cid, n, (int)c);
}

__device__ __forceinline__ int wrap_cell(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

__device__ __forceinline__ double wrap_sep(float d, double L, double Lh) {
    double dd = (double)d;
    if (dd > Lh) dd = __dsub_rn(dd, L);
    if (dd < -Lh) dd = __dadd_rn(dd, L);
    return dd;
}

// The root of v, halving the path on the way (ECL-CC's representative).
// Other threads rewrite parents meanwhile; a read sees an ancestor either
// way, and parents only decrease along a path, so the walk ends.
__device__ __forceinline__ int find_root(int v, int* parent) {
    int cur = parent[v];
    if (cur != v) {
        int next, prev = v;
        while (cur > (next = parent[cur])) {
            parent[prev] = next;
            prev = cur;
            cur = next;
        }
    }
    return cur;
}

// Join the groups of a and b: hook the larger root under the smaller.
__device__ __forceinline__ void unite(int a, int b, int* parent) {
    int ra = find_root(a, parent), rb = find_root(b, parent);
    while (ra != rb) {
        if (ra > rb) {
            const int t = ra;
            ra = rb;
            rb = t;
        }
        const int old = atomicCAS(parent + rb, rb, ra);
        if (old == rb) return;
        // rb was hooked meanwhile: carry on from its new parent
        rb = old;
    }
}

struct Box {
    double L, Lh, cs, ll2, reach;
    float inv;
};

// Row i against row j: hook them if they link.
__device__ __forceinline__ void test(const float* __restrict__ x, int i,
                                     const float xi[3], int j, const Box& g,
                                     int* parent) {
    const double dx = wrap_sep(__fsub_rn(xi[0], x[3 * j]), g.L, g.Lh);
    const double dy = wrap_sep(__fsub_rn(xi[1], x[3 * j + 1]), g.L, g.Lh);
    const double dz = wrap_sep(__fsub_rn(xi[2], x[3 * j + 2]), g.L, g.Lh);
    const double r2 = __dadd_rn(
        __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
    if (r2 < g.ll2) unite(i, j, parent);
}

// The rows j = a, a + 1, ... below b while z_j <= hi.
__device__ __forceinline__ void scan_up(const float* __restrict__ x, int i,
                                        const float xi[3], int a, int b,
                                        double hi, const Box& g,
                                        int* parent) {
    for (int j = a; j < b && (double)x[3 * j + 2] <= hi; ++j)
        test(x, i, xi, j, g, parent);
}

// The rows j = b - 1, b - 2, ... down to a while z_j >= lo.
__device__ __forceinline__ void scan_down(const float* __restrict__ x,
                                          int i, const float xi[3], int a,
                                          int b, double lo, const Box& g,
                                          int* parent) {
    for (int j = b - 1; j >= a && (double)x[3 * j + 2] >= lo; --j)
        test(x, i, xi, j, g, parent);
}

// The first row in [a, b) with z >= lo (the rows sorted by z).
__device__ __forceinline__ int first_from(const float* __restrict__ x,
                                          int a, int b, double lo) {
    while (a < b) {
        const int m = a + ((b - a) >> 1);
        if ((double)x[3 * m + 2] < lo)
            a = m + 1;
        else
            b = m;
    }
    return a;
}

__global__ void link_kernel(const float* __restrict__ x,
                            const int* __restrict__ start, int n, int ncol,
                            Box g, const bool* __restrict__ outside,
                            int* parent) {
    const int i = (int)((long long)blockIdx.x * THREADS + threadIdx.x);
    if (i >= n) return;
    const float xi[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
    // per axis (x, y) the first column and the offsets [lo, hi] to read:
    // with 3 or more columns the row's own and each face's neighbour
    // within reach; with 1 or 2 every column (all are neighbours)
    int first[2], lo[2], hi[2], own[2];
    for (int d = 0; d < 2; ++d) {
        const int f = (int)floorf(__fmul_rn(xi[d], g.inv));
        const int c = wrap_cell(f, ncol);
        own[d] = c;
        if (ncol < 3) {
            first[d] = 0;
            lo[d] = 0;
            hi[d] = ncol - 1;
            continue;
        }
        first[d] = c;
        lo[d] = -1;
        hi[d] = 1;
        // a row outside [0, L) keeps every neighbour
        if (f == c) {
            const double xd = (double)xi[d];
            if (xd - c * g.cs > g.reach) lo[d] = 0;
            if ((c + 1) * g.cs - xd > g.reach) hi[d] = 0;
        }
    }
    // the z window, and the rows past a z face that wrap into it
    const bool whole = *outside || 2.0 * g.reach >= g.L;
    const double zlo = (double)xi[2] - g.reach, zhi = (double)xi[2] + g.reach;
    const int own_col = own[0] * ncol + own[1];
    for (int ox = lo[0]; ox <= hi[0]; ++ox) {
        const int cx = wrap_cell(first[0] + ox, ncol);
        for (int oy = lo[1]; oy <= hi[1]; ++oy) {
            const int col = cx * ncol + wrap_cell(first[1] + oy, ncol);
            // every row of an earlier column precedes row i
            if (col < own_col) continue;
            const int a = start[col], b = start[col + 1];
            if (whole) {
                scan_up(x, i, xi, col == own_col ? i + 1 : a, b, 1e300, g,
                        parent);
            } else if (col == own_col) {
                // the rows past i up to the window's top; past the top z
                // face, the column's last rows (the rows that wrap below
                // the bottom face precede i and read it themselves)
                scan_up(x, i, xi, i + 1, b, zhi, g, parent);
                if (zlo < 0.0)
                    scan_down(x, i, xi, i + 1, b, zlo + g.L, g, parent);
            } else {
                scan_up(x, i, xi, first_from(x, a, b, zlo), b, zhi, g,
                        parent);
                if (zlo < 0.0)
                    scan_down(x, i, xi, a, b, zlo + g.L, g, parent);
                if (zhi > g.L)
                    scan_up(x, i, xi, a, b, zhi - g.L, g, parent);
            }
        }
    }
}

// Every row takes its root.
__global__ void root_kernel(int n, int* parent) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    int r = parent[i];
    while (parent[r] != r) r = parent[r];
    parent[i] = r;
}

unsigned int blocks_of(long long n) {
    return (unsigned int)((n + THREADS - 1) / THREADS);
}

}  // namespace

// FOF roots of n rows sorted by column, then z (see the contract above):
// x n x 3 float32, cid n int32 ascending (each below ncol^2); columns of
// side L / ncol with inv = float32(ncol / L); ll2 the squared linking
// length and reach the window's half height (double); outside a device
// bool, true if some z lies outside [0, L]. table (ncol^2 + 1 int32) is
// scratch; out (n int32) gets each row's root, the least sorted row of
// its group. All pointers on the device. Returns cudaGetLastError().
extern "C" int fastpm_fof_link(const float* x, const int* cid, long long n,
                               int ncol, float inv, double L, double ll2,
                               double reach, const bool* outside, int* table,
                               int* out, cudaStream_t stream) {
    const long long ncols = (long long)ncol * ncol;
    cudaError_t rc = cudaMemsetAsync(table, 0xff,
                                     sizeof(int) * (size_t)(ncols + 1),
                                     stream);
    if (rc != cudaSuccess) return (int)rc;
    const Box g{L, 0.5 * L, L / ncol, ll2, reach, inv};
    fill_kernel<<<blocks_of(n + 1), THREADS, 0, stream>>>(
        cid, (int)n, (int)ncols, table, out);
    gap_kernel<<<blocks_of(ncols + 1), THREADS, 0, stream>>>(
        cid, (int)n, (int)ncols, table);
    if (n > 0) {
        link_kernel<<<blocks_of(n), THREADS, 0, stream>>>(
            x, table, (int)n, ncol, g, outside, out);
        root_kernel<<<blocks_of(n), THREADS, 0, stream>>>((int)n, out);
    }
    return (int)cudaGetLastError();
}
