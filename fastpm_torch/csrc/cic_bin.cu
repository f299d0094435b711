// The cell order of K3 and K4: a counting sort of particles by the
// (x, y) line of their base cell, in two kernels around a scan of the
// line counts (ops/cic.py:cell_order runs the scan with torch.cumsum).
//
// Replaces the sort that fastpm_tpu/ops/paint_pallas.py:make_paint_fn
// runs before K3's pallas_call (jax.lax.sort by padded cell key, :212-
// 224), and which make_prepare_fn shares between make_paint_from_fn and
// make_readout3_from_fn. The port's first version of this order was
// torch.sort of the int32 cell keys: 3.7 ms for the ncdm path's 22.0 M
// rows, more than the tiled deposit it feeds (PERF.md).
//
// Contract: order is a permutation of the n rows with their base cells'
// lines (base x plane * ny + base y row, cell() of cic_common.cuh) in
// ascending order. The order of the rows within a line is not fixed:
// on the card it depends on the order of the atomics. That is all K3
// and K4 need: the tiled deposit's footprint is a range of lines, and a
// readout block of rows on a few lines shares their cache lines.
//
// What bounds it on an H100: device-memory bytes, 12 B read a row twice
// (count, then scatter) and 8 B written; the counters (1 MB at 512^2
// lines) stay in L2. Rows that share a line within a warp (the lattice
// order the solver's stores keep) add to its counter once: the lanes of
// one line are matched (__match_any_sync), and one lane adds their count
// and hands out the slots.

#include "cic_common.cuh"

namespace {

using fastpm_cic::XAxis;

constexpr int THREADS = 256;

__device__ __forceinline__ int line_of(const float* x, long long i, int nx,
                                       int ny, int nz, float icx, float icy,
                                       float icz) {
    int lo[3], hi[3];
    float f[3], t[3];
    fastpm_cic::cell(x + 3 * i, nx, ny, nz, icx, icy, icz, XAxis{0, 0}, lo,
                     hi, f, t);
    return lo[0] * ny + lo[1];
}

__global__ void count_kernel(const float* __restrict__ x, long long n,
                             int nx, int ny, int nz, float icx, float icy,
                             float icz, int* __restrict__ counts) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const int line = line_of(x, i, nx, ny, nz, icx, icy, icz);
    const unsigned peers = __match_any_sync(__activemask(), line);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(counts + line, __popc(peers));
}

__global__ void scatter_kernel(const float* __restrict__ x, long long n,
                               int nx, int ny, int nz, float icx, float icy,
                               float icz, int* __restrict__ cursor,
                               long long* __restrict__ order) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const int line = line_of(x, i, nx, ny, nz, icx, icy, icz);
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(__activemask(), line);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (lane == leader) slot = atomicAdd(cursor + line, __popc(peers));
    slot = __shfl_sync(peers, slot, leader)
           + __popc(peers & ((1u << lane) - 1u));
    order[slot] = i;
}

unsigned int blocks_of(long long n) {
    return (unsigned int)((n + THREADS - 1) / THREADS);
}

}  // namespace

// Count n particles (x: n x 3 float32, device) by the line of their
// base cell on an nx*ny*nz mesh into counts (nx*ny int32, device),
// which this zeroes first. Returns cudaGetLastError().
extern "C" int fastpm_cic_bin_count(const float* x, long long n, int nx,
                                    int ny, int nz, float icx, float icy,
                                    float icz, int* counts,
                                    cudaStream_t stream) {
    cudaError_t rc = cudaMemsetAsync(counts, 0,
                                     sizeof(int) * (size_t)nx * ny, stream);
    if (rc != cudaSuccess) return (int)rc;
    if (n > 0)
        count_kernel<<<blocks_of(n), THREADS, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, counts);
    return (int)cudaGetLastError();
}

// Write the row of each of n particles into order (n int64, device) at
// the next slot of its line: cursor (nx*ny int32, device) holds each
// line's first slot (the exclusive scan of the counts) and is advanced.
// Returns cudaGetLastError().
extern "C" int fastpm_cic_bin_scatter(const float* x, long long n, int nx,
                                      int ny, int nz, float icx, float icy,
                                      float icz, int* cursor,
                                      long long* order,
                                      cudaStream_t stream) {
    if (n > 0)
        scatter_kernel<<<blocks_of(n), THREADS, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, cursor, order);
    return (int)cudaGetLastError();
}
