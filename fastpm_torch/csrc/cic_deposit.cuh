// The CIC deposit body of the paints K1 (cic_paint.cu: periodic, and
// homed into one rank's extended x-slab), K3 (cic_paint_into.cu) and K5
// (cic_paint4.cu):
// add mass m times the 8 corner weights of cic_common.cuh at every row
// into a canvas, with a scalar mass or a mass column, the rows read in
// their order or through an index (K3's cell order); on an open x axis
// (and, for the pencil force, an open y axis) a row beyond the slab or
// pencil deposits nothing and adds one to *bad.
//
// What bounds a deposit on an H100 is the reductions the canvas takes
// in L2. One thread a row with 8 scalar global atomics (the port's first
// design) sends 8 reductions a row to L2, 134 M for 16.8 M rows, and
// under clustering many of them on the same cells, where they
// serialise. The design here:
// 1. Chunks. A block takes DEPOSIT_THREADS consecutive rows, one a
//    thread, and computes each row's cell once (cell() of
//    cic_common.cuh, the one copy the readout shares), keeping it in
//    registers.
// 2. Footprint. The block reduces the rows' base planes and base rows
//    to their ranges: the chunk's corners lie on (x span + 2) x
//    (y span + 2) lines of nz floats, kept relative to the lowest base
//    plane and row. The +1 corner is the next tile plane or row, mapped
//    back with the periodic wrap when the tile is flushed (it never
//    wraps on an open axis: a row inside the slab has relx <= nx - 2,
//    one inside the pencil also rely <= ny - 2).
// 3. Tile path, where the footprint is at most TILE_FLOATS_PER_ROW
//    floats a row: in passes of as many lines as TILE_BYTES of dynamic
//    shared memory hold, zero the tile, add the corners on its lines
//    with shared atomics, and add the tile into the canvas once. The
//    flush is one float4 global reduction a quad (sm_90's vector
//    atomicAdd) where nz % 4 == 0 and the canvas is 16-byte aligned,
//    else one a float; quads (floats) that stayed zero are skipped. L2
//    charges a reduction per operation more than per byte (PERF.md), so
//    a cell-sorted chunk's ~3 quads a row beat 8 scalar atomics. A warp
//    whose rows share base cells (a clustered run) first sums each
//    corner over the lanes of one cell (a segmented sum in shuffles),
//    so one lane a cell adds to shared memory.
// 4. Direct path, for a larger footprint (rows in random order, rows
//    that straddle an x plane, voids): each row's 8 corners go straight
//    to the canvas with scalar atomics, from the registers of step 1.
// The result is right whatever the row order: only speed depends on it
// (the stale force paints rows that have drifted from their sort, K3's
// callers may hand rows in any order). A row's cell is computed once,
// so a row beyond an open slab is counted exactly once.
//
// f32 atomics land in an order that changes from run to run, so the
// canvas differs in the last bits between runs.

#pragma once

#include <climits>

#include "cic_common.cuh"

namespace fastpm_cic {
namespace {

// one row a thread, four blocks an SM: 2048 threads and 4 x (48 KB + 1
// KB reserved) of the SM's 228 KB of shared memory (PERF.md: against 2
// or 4 rows a thread and 2-3 blocks an SM, the fewest registers and the
// most rows in flight won every K1 row)
constexpr int DEPOSIT_THREADS = 512;
constexpr int DEPOSIT_BLOCKS_PER_SM = 4;
constexpr int TILE_BYTES = 48 * 1024;
constexpr int TILE_FLOATS = TILE_BYTES / 4;
// the footprint a chunk may flush through the tile: 16 quads a row,
// twice a row's 8 direct atomics before the zero quads are skipped
constexpr int TILE_FLOATS_PER_ROW = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Deposit {
    const float* x;
    const long long* order;  // null: row r is x[r], else x[order[r]]
    long long n;
    int nx, ny, nz;
    float icx, icy, icz;
    OpenAxes ax;
    float mass;
    const float* masses;     // null: every row has `mass`
    float* canvas;
    int* bad;                // open axes only
    bool vec;                // nz % 4 == 0 and canvas 16-byte aligned
};

// Add the 8 weighted corners of a row (base cell lo, +1 neighbours hi,
// fraction f) times m into the canvas with global atomics.
__device__ __forceinline__ void add_corners(float* canvas, const int lo[3],
                                            const int hi[3],
                                            const float f[3], float m,
                                            int ny, int nz) {
    const float t[3] = {__fsub_rn(1.0f, f[0]), __fsub_rn(1.0f, f[1]),
                        __fsub_rn(1.0f, f[2])};
    int idx[4];
    float w[4];
    for (int dx = 0; dx < 2; ++dx) {
        plane_corners(dx, lo, hi, f, t, ny, nz, idx, w);
        for (int c = 0; c < 4; ++c)
            atomicAdd(canvas + idx[c], __fmul_rn(w[c], m));
    }
}

__device__ __forceinline__ bool nonzero(float4 v) {
    return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

template <bool OPEN_X>
__global__ void __launch_bounds__(DEPOSIT_THREADS, DEPOSIT_BLOCKS_PER_SM)
deposit_kernel(const Deposit a) {
    extern __shared__ float4 tile4[];
    float* tile = reinterpret_cast<float*>(tile4);
    __shared__ int box[4];   // lowest and highest base plane and row
    const int tid = threadIdx.x, lane = tid & 31;
    const long long r = (long long)blockIdx.x * DEPOSIT_THREADS + tid;
    const int cnt = (int)min((long long)DEPOSIT_THREADS,
                             a.n - (long long)blockIdx.x * DEPOSIT_THREADS);
    if (tid == 0) {
        box[0] = INT_MAX;
        box[1] = INT_MIN;
        box[2] = INT_MAX;
        box[3] = INT_MIN;
    }

    // 1. the row's cell, once
    int lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
    float f[3] = {0.0f, 0.0f, 0.0f}, t[3] = {0.0f, 0.0f, 0.0f}, m = 0.0f;
    bool in = false;
    if (r < a.n) {
        const long long i = a.order ? a.order[r] : r;
        in = cell(a.x + 3 * i, a.nx, a.ny, a.nz, a.icx, a.icy, a.icz,
                  OPEN_X ? a.ax : OpenAxes{0, 0}, lo, hi, f, t);
        if (in) m = a.masses ? a.masses[i] : a.mass;
    }
    if (OPEN_X) {
        const unsigned out = __ballot_sync(FULL, r < a.n && !in);
        if (lane == 0 && out) atomicAdd(a.bad, __popc(out));
    }

    // 2. the chunk's footprint
    int x0 = __reduce_min_sync(FULL, in ? lo[0] : INT_MAX);
    const int x1 = __reduce_max_sync(FULL, in ? lo[0] : INT_MIN);
    int y0 = __reduce_min_sync(FULL, in ? lo[1] : INT_MAX);
    const int y1 = __reduce_max_sync(FULL, in ? lo[1] : INT_MIN);
    __syncthreads();
    if (lane == 0) {
        atomicMin(box + 0, x0);
        atomicMax(box + 1, x1);
        atomicMin(box + 2, y0);
        atomicMax(box + 3, y1);
    }
    __syncthreads();
    x0 = box[0];
    y0 = box[2];
    if (x0 == INT_MAX) return;   // every row beyond the slab
    const int py = box[3] - y0 + 2;
    const long long lines = (long long)(box[1] - x0 + 2) * py;
    const int per_pass = TILE_FLOATS / a.nz;   // lines a pass holds

    if (per_pass == 0
        || lines * a.nz > (long long)TILE_FLOATS_PER_ROW * cnt) {
        // 4. direct path
        if (in) add_corners(a.canvas, lo, hi, f, m, a.ny, a.nz);
        return;
    }

    // 3. tile path. The row's base line in the tile; whether it opens a
    // run of rows with the same base cell in its warp; for each shuffle
    // distance 2^k whether lane + 2^k is in its run
    const int nz = a.nz;
    const int line = in ? (lo[0] - x0) * py + lo[1] - y0 : -1;
    const int key = in ? line * nz + lo[2] : -1 - lane;
    const int prev = __shfl_up_sync(FULL, key, 1);
    const bool head = lane == 0 || prev != key;
    const unsigned heads = __ballot_sync(FULL, head);
    // aggregate where the warp's 32 rows hold at most 16 cells
    const bool agg = __popc(heads) <= 16;
    const int run = __popc(heads & ((2u << lane) - 1u));
    unsigned same = 0;
    for (int k = 0; k < 5; ++k) {
        const int other = __shfl_down_sync(FULL, run, 1 << k);
        if (lane + (1 << k) < 32 && other == run) same |= 1u << k;
    }
    const bool vec = a.vec;
    for (long long l0 = 0; l0 < lines; l0 += per_pass) {
        const int nl = (int)min((long long)per_pass, lines - l0);
        const int total = nl * nz;
        if (vec) {
            for (int q = tid; q < total / 4; q += DEPOSIT_THREADS)
                tile4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
            for (int q = tid; q < total; q += DEPOSIT_THREADS) tile[q] = 0.0f;
        }
        __syncthreads();
        // the corners on this pass's lines, with the weights of
        // plane_corners (cic_common.cuh)
        for (int dx = 0; dx < 2; ++dx) {
            const float wx = dx ? f[0] : t[0];
            for (int dy = 0; dy < 2; ++dy) {
                const long long l = line + dx * py + dy - l0;
                const bool here = in && l >= 0 && l < nl;
                const float wxy = __fmul_rn(wx, dy ? f[1] : t[1]);
                for (int dz = 0; dz < 2; ++dz) {
                    float v = __fmul_rn(__fmul_rn(wxy, dz ? f[2] : t[2]), m);
                    if (agg) {
                        // segmented suffix sum over the run (every lane
                        // of a run has the same corner)
                        for (int k = 0; k < 5; ++k) {
                            const float o = __shfl_down_sync(FULL, v, 1 << k);
                            if (same >> k & 1u) v += o;
                        }
                        if (!head) continue;
                    }
                    if (here)
                        atomicAdd(tile + (int)l * nz + (dz ? hi[2] : lo[2]), v);
                }
            }
        }
        __syncthreads();
        // tile line l0 + l = (plane p, row y) -> canvas line
        // (x0 + p, y0 + y), each wrapped once: x0 + p <= nx, y0 + y <= ny
        const int per_line = vec ? nz / 4 : nz;
        for (int q = tid; q < total / (vec ? 4 : 1); q += DEPOSIT_THREADS) {
            const int l = (int)l0 + q / per_line, z = q % per_line;
            const int p = l / py, y = l - p * py;
            int cx = x0 + p, cy = y0 + y;
            if (!OPEN_X && cx >= a.nx) cx -= a.nx;
            if (cy >= a.ny) cy -= a.ny;
            float* dst = a.canvas + ((long long)cx * a.ny + cy) * nz;
            if (vec) {
                const float4 v = tile4[q];
                if (nonzero(v))
                    atomicAdd(reinterpret_cast<float4*>(dst) + z, v);
            } else {
                const float v = tile[q];
                if (v != 0.0f) atomicAdd(dst + z, v);
            }
        }
        if (l0 + per_pass < lines) __syncthreads();
    }
}

// Launch the deposit on `stream`; returns cudaGetLastError().
int launch_deposit(const Deposit& a, cudaStream_t stream) {
    if (a.n <= 0) return (int)cudaGetLastError();
    const unsigned int blocks =
        (unsigned int)((a.n + DEPOSIT_THREADS - 1) / DEPOSIT_THREADS);
    const bool open = a.ax.n0 > 0;
    const void* fn = open ? (const void*)deposit_kernel<true>
                          : (const void*)deposit_kernel<false>;
    cudaError_t rc = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_BYTES);
    if (rc == cudaSuccess)
        rc = cudaFuncSetAttribute(
            fn, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (rc != cudaSuccess) return (int)rc;
    if (open)
        deposit_kernel<true><<<blocks, DEPOSIT_THREADS, TILE_BYTES, stream>>>(a);
    else
        deposit_kernel<false><<<blocks, DEPOSIT_THREADS, TILE_BYTES, stream>>>(a);
    return (int)cudaGetLastError();
}

bool deposit_vec(int nz, const float* canvas) {
    return nz % 4 == 0 && ((size_t)canvas & 15) == 0;
}

}  // namespace
}  // namespace fastpm_cic
