// The cell order of K3 and K4: a stable LSD radix sort of the rows by
// the (x, y) line of their base cell.
//
// Replaces the sort that fastpm_tpu/ops/paint_pallas.py:make_paint_fn
// runs before K3's pallas_call (jax.lax.sort by padded cell key, :212-
// 224), and which make_prepare_fn shares between make_paint_from_fn and
// make_readout3_from_fn.
//
// Contract: order is the permutation that sorts the rows by line (base x
// plane * ny + base y row, cell() of cic_common.cuh), lines ascending and
// the rows of one line in their given order: torch.sort(line,
// stable=True).indices bit for bit (jax.lax.sort is stable as well).
//
// Design. The line is computed once, into an int32 key, by a kernel that
// also counts every pass's digits (per-block histograms in shared
// memory, added to the global counts once a block); one small kernel
// scans the counts. Then one kernel a digit pass (the key's bits in
// passes of at most MAX_BITS: two of 9 bits on 512^2 lines) sorts tiles
// of TILE rows: each warp ranks its rows, in order, by the peers of
// equal digit (one ballot a bit) into a histogram of its own, which keeps
// the ranks stable (a warp whose rows share one digit skips the
// ballots); the tile's digit offsets come from a decoupled look-back over
// the earlier tiles (single-pass prefix, Merrill and Garland 2016): each
// tile publishes its counts as soon as it has loaded its rows, and reads
// LOOK earlier tiles at once; tiles are taken in the order they start; the rows are staged in shared memory in digit order
// and written out as runs of a digit, not as one scattered write a row.
// Each pass moves (key, row) as int32; the last writes the rows as the
// int64 order.
//
// What bounds it on an H100: device-memory bytes. The positions (12 B a
// row) are read once and the order (8 B) written once; the counts (4 B a
// line) are written once. The keys and rows between passes (8 B a row
// written and read a pass) and the look-back's tile states are the
// design's own traffic.

#include "cic_common.cuh"

namespace {

using fastpm_cic::OpenAxes;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                  // rows a thread per tile
constexpr int TILE = THREADS * ITEMS;     // rows a tile
constexpr int MAX_BITS = 9;
constexpr int MAX_RADIX = 1 << MAX_BITS;
constexpr int MAX_PASSES = 4;
constexpr int KEY_BLOCKS = 1024;          // blocks of the key kernel
constexpr int LOOK = 8;                   // tiles a look-back step reads
// a tile state: the flag in the top two bits, the count below
constexpr unsigned FLAG_AGGREGATE = 1u << 30;
constexpr unsigned FLAG_PREFIX = 2u << 30;
constexpr unsigned COUNT_MASK = FLAG_AGGREGATE - 1u;

__device__ __forceinline__ int line_of(const float* x, long long i, int nx,
                                       int ny, int nz, float icx, float icy,
                                       float icz) {
    int lo[3], hi[3];
    float f[3], t[3];
    fastpm_cic::cell(x + 3 * i, nx, ny, nz, icx, icy, icz, OpenAxes{0, 0}, lo,
                     hi, f, t);
    return lo[0] * ny + lo[1];
}

// The lanes whose label equals this lane's, for labels below 2^nbits:
// one ballot a bit, as CUB's MatchAny (__match_any_sync is slower).
__device__ __forceinline__ unsigned match_peers(unsigned label, int nbits) {
    unsigned peers = 0xffffffffu;
#pragma unroll
    for (int b = 0; b <= MAX_BITS; ++b) {
        if (b == nbits) break;
        const bool bit = (label >> b) & 1u;
        const unsigned m = __ballot_sync(0xffffffffu, bit);
        peers &= bit ? m : ~m;
    }
    return peers;
}

// Add each lane's digit d (radix: none) to hist: one add for a warp whose
// lanes share one digit (rows in store order), else one shared atomic a
// lane.
__device__ __forceinline__ void count_digit(unsigned* hist, int d, int radix,
                                            int lane) {
    const int d0 = __shfl_sync(0xffffffffu, d, 0);
    if (__all_sync(0xffffffffu, d == d0)) {
        if (lane == 0 && d0 < radix) atomicAdd(hist + d0, 32u);
    } else if (d < radix) {
        atomicAdd(hist + d, 1u);
    }
}

// keys[i] = the line of row i; counts[p * radix + d] += the rows whose
// digit p is d. The block steps over the rows together, so every warp is
// whole at each warp vote.
__global__ void __launch_bounds__(THREADS)
keys_kernel(const float* __restrict__ x, long long n, int nx, int ny,
            int nz, float icx, float icy, float icz, int bits, int passes,
            int* __restrict__ keys, unsigned* __restrict__ counts) {
    __shared__ unsigned hist[MAX_PASSES * MAX_RADIX];
    const int radix = 1 << bits;
    for (int k = threadIdx.x; k < passes * radix; k += THREADS) hist[k] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (long long base = (long long)blockIdx.x * THREADS; base < n;
         base += (long long)gridDim.x * THREADS) {
        const long long i = base + threadIdx.x;
        const bool valid = i < n;
        int key = 0;
        if (valid) {
            key = line_of(x, i, nx, ny, nz, icx, icy, icz);
            keys[i] = key;
        }
        for (int p = 0; p < passes; ++p) {
            const int d = valid ? (key >> (p * bits)) & (radix - 1) : radix;
            count_digit(hist + p * radix, d, radix, lane);
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < passes * radix; k += THREADS)
        if (hist[k]) atomicAdd(counts + k, hist[k]);
}

// Block-wide exclusive scan of one value a thread: the thread's prefix.
__device__ __forceinline__ unsigned block_scan(unsigned v,
                                               unsigned* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned s = v;
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += t;
    }
    if (lane == 31) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
        unsigned w = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned t = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += t;
        }
        if (lane < (int)(blockDim.x >> 5)) warp_sums[lane] = w;
    }
    __syncthreads();
    const unsigned before = (warp ? warp_sums[warp - 1] : 0) + s - v;
    __syncthreads();
    return before;
}

// starts[p * radix + d] = the rows whose digit p is below d: one block
// of MAX_RADIX threads a pass.
__global__ void scan_kernel(const unsigned* __restrict__ counts, int radix,
                            unsigned* __restrict__ starts) {
    __shared__ unsigned warp_sums[32];
    const int p = blockIdx.x, d = threadIdx.x;
    const unsigned v = d < radix ? counts[p * radix + d] : 0;
    const unsigned before = block_scan(v, warp_sums);
    if (d < radix) starts[p * radix + d] = before;
}

// One digit pass over tiles of TILE rows (see the design above). FIRST:
// the rows are 0..n-1 (no vals_in); LAST: only the rows are written, as
// the int64 order.
template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(THREADS)
pass_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
            long long n, int shift, int bits,
            const unsigned* __restrict__ digit_start,
            volatile unsigned* state,
            unsigned* tile_counter, int* __restrict__ keys_out,
            int* __restrict__ vals_out, long long* __restrict__ order) {
    __shared__ union {
        unsigned warp_hist[WARPS * MAX_RADIX];
        struct {
            int key[TILE];
            int val[TILE];
        } stage;
    } sm;
    __shared__ unsigned tile_start[MAX_RADIX];   // first slot of a digit
    __shared__ unsigned out_start[MAX_RADIX];    // its first output row
    __shared__ unsigned tile_count[MAX_RADIX];   // the tile's rows a digit
    __shared__ unsigned warp_sums[32];
    __shared__ unsigned tile_s;

    const int radix = 1 << bits, mask = radix - 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) tile_s = atomicAdd(tile_counter, 1u);
    for (int k = threadIdx.x; k < WARPS * radix; k += THREADS)
        sm.warp_hist[k] = 0;
    __syncthreads();
    const long long tile = tile_s;
    const long long wbase = tile * TILE + (long long)warp * 32 * ITEMS;

    int key[ITEMS], val[ITEMS];
    unsigned rank[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const long long i = wbase + r * 32 + lane;
        const bool valid = i < n;
        key[r] = valid ? keys_in[i] : 0;
        val[r] = FIRST ? (int)i : (valid ? vals_in[i] : 0);
    }
    // the tile's count of each digit, published at once so that later
    // tiles looking back find it early
    for (int k = threadIdx.x; k < radix; k += THREADS) tile_count[k] = 0;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const bool valid = wbase + r * 32 + lane < n;
        count_digit(tile_count, valid ? (key[r] >> shift) & mask : radix,
                    radix, lane);
    }
    __syncthreads();
    volatile unsigned* st = state + tile * radix;
    for (int d = threadIdx.x; d < radix; d += THREADS)
        st[d] = (tile == 0 ? +FLAG_PREFIX : +FLAG_AGGREGATE) | tile_count[d];

    // rank in the warp, in row order: the warp's earlier rows of the
    // digit, then this round's peers in lower lanes
    unsigned* hist = sm.warp_hist + warp * radix;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const bool valid = wbase + r * 32 + lane < n;
        const int d = valid ? (key[r] >> shift) & mask : radix;
        const bool same = __all_sync(0xffffffffu,
                                     d == __shfl_sync(0xffffffffu, d, 0));
        const unsigned peers = same ? 0xffffffffu : match_peers(d, bits + 1);
        const int leader = __ffs(peers) - 1;
        unsigned before = 0;
        if (valid && lane == leader) before = hist[d];
        before = __shfl_sync(0xffffffffu, before, leader);
        rank[r] = before + __popc(peers & ((1u << lane) - 1u));
        if (valid && lane == leader) hist[d] = before + __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    // per digit: each warp's count becomes the earlier warps' sum, and
    // the scan of the tile's counts gives each digit's first slot
    const int per = (radix + THREADS - 1) / THREADS;
    unsigned mine = 0;
    for (int k = 0; k < per; ++k) {
        const int d = threadIdx.x * per + k;
        if (d >= radix) break;
        unsigned s = 0;
        for (int w = 0; w < WARPS; ++w) {
            const unsigned t = sm.warp_hist[w * radix + d];
            sm.warp_hist[w * radix + d] = s;
            s += t;
        }
        mine += s;
    }
    unsigned run = block_scan(mine, warp_sums);
    for (int k = 0; k < per; ++k) {
        const int d = threadIdx.x * per + k;
        if (d >= radix) break;
        tile_start[d] = run;
        run += tile_count[d];
    }

    // decoupled look-back: add the earlier tiles' counts until one has
    // published its prefix
    for (int d = threadIdx.x; d < radix; d += THREADS) {
        unsigned before = 0;
        if (tile > 0) {
            // step back LOOK tiles at a time: add their counts from the
            // nearest until a prefix; a tile not yet published is read
            // again
            long long k = tile - 1;
            for (bool done = false; !done;) {
                unsigned v[LOOK];
#pragma unroll
                for (int w = 0; w < LOOK; ++w)
                    v[w] = k - w >= 0 ? (unsigned)state[(k - w) * radix + d]
                                      : +FLAG_PREFIX;
                int w = 0;
                for (; w < LOOK; ++w) {
                    if (!(v[w] & ~COUNT_MASK)) break;
                    before += v[w] & COUNT_MASK;
                    if (v[w] & FLAG_PREFIX) {
                        done = true;
                        break;
                    }
                }
                k -= w;
            }
            st[d] = FLAG_PREFIX | (before + tile_count[d]);
        }
        out_start[d] = digit_start[d] + before;
    }
    __syncthreads();

    // stage the rows in digit order, then write each digit's run
    unsigned slot[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const int d = (key[r] >> shift) & mask;
        slot[r] = tile_start[d] + sm.warp_hist[warp * radix + d] + rank[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        if (wbase + r * 32 + lane < n) {
            sm.stage.key[slot[r]] = key[r];
            sm.stage.val[slot[r]] = val[r];
        }
    }
    __syncthreads();
    const long long left = n - tile * TILE;
    const int rows = left < TILE ? (int)left : TILE;
    for (int s = threadIdx.x; s < rows; s += THREADS) {
        const int k = sm.stage.key[s];
        const int d = (k >> shift) & mask;
        const unsigned dst = out_start[d] + (s - tile_start[d]);
        if (LAST) {
            order[dst] = sm.stage.val[s];
        } else {
            keys_out[dst] = k;
            vals_out[dst] = sm.stage.val[s];
        }
    }
}

struct Workspace {
    int* keys[2];
    int* vals[2];
    unsigned* counts;    // passes x radix
    unsigned* starts;    // passes x radix
    unsigned* state;     // passes x (tiles x radix + 1): the last word of
                         // each pass is its tile counter
    size_t bytes;
};

// Carve the workspace of n rows; base null only sizes it.
Workspace carve(char* base, long long n, int bits, int passes) {
    const size_t radix = (size_t)1 << bits;
    const size_t tiles = (size_t)((n + TILE - 1) / TILE);
    const size_t rows = ((size_t)n + 63) / 64 * 64;
    Workspace w;
    size_t at = 0;
    auto take = [&](size_t bytes) {
        char* p = base ? base + at : nullptr;
        at += (bytes + 255) / 256 * 256;
        return p;
    };
    for (int k = 0; k < 2; ++k) {
        w.keys[k] = (int*)take(sizeof(int) * rows);
        w.vals[k] = (int*)take(sizeof(int) * rows);
    }
    w.counts = (unsigned*)take(sizeof(unsigned) * passes * radix);
    w.starts = (unsigned*)take(sizeof(unsigned) * passes * radix);
    w.state = (unsigned*)take(sizeof(unsigned) * passes *
                              (tiles * radix + 1));
    w.bytes = at;
    return w;
}

bool plan_ok(long long n, int bits, int passes) {
    return n >= 0 && n < (1ll << 30) && bits >= 1 && bits <= MAX_BITS &&
           passes >= 1 && passes <= MAX_PASSES;
}

}  // namespace

// Bytes of workspace cell_order needs for n rows and the digit plan
// (bits a pass, passes); -1 for a plan the kernels do not take.
extern "C" long long fastpm_cic_order_workspace(long long n, int bits,
                                                int passes) {
    if (!plan_ok(n, bits, passes)) return -1;
    return (long long)carve(nullptr, n, bits, passes).bytes;
}

// The cell order of n particles (x: n x 3 float32, device) on an
// nx*ny*nz mesh into order (n int64, device): the rows sorted stably by
// line, whose bits * passes bits must hold every line below nx * ny.
// workspace: fastpm_cic_order_workspace bytes on the device. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan out of range).
extern "C" int fastpm_cic_order(const float* x, long long n, int nx, int ny,
                                int nz, float icx, float icy, float icz,
                                int bits, int passes, void* workspace,
                                long long* order, cudaStream_t stream) {
    if (!plan_ok(n, bits, passes) ||
        (long long)nx * ny > (1ll << (bits * passes)))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const Workspace w = carve((char*)workspace, n, bits, passes);
    const unsigned radix = 1u << bits;
    const unsigned tiles = (unsigned)((n + TILE - 1) / TILE);
    cudaError_t rc = cudaMemsetAsync(
        w.counts, 0, sizeof(unsigned) * passes * radix, stream);
    if (rc == cudaSuccess)
        rc = cudaMemsetAsync(
            w.state, 0,
            sizeof(unsigned) * passes * ((size_t)tiles * radix + 1), stream);
    if (rc != cudaSuccess) return (int)rc;
    const long long kblocks = (n + THREADS - 1) / THREADS;
    keys_kernel<<<(unsigned)(kblocks < KEY_BLOCKS ? kblocks : KEY_BLOCKS),
                  THREADS, 0, stream>>>(x, n, nx, ny, nz, icx, icy, icz,
                                        bits, passes, w.keys[0], w.counts);
    scan_kernel<<<passes, MAX_RADIX, 0, stream>>>(w.counts, (int)radix,
                                                  w.starts);
    for (int p = 0; p < passes; ++p) {
        const int in = p & 1, out = in ^ 1;
        unsigned* state = w.state + (size_t)p * ((size_t)tiles * radix + 1);
        unsigned* counter = state + (size_t)tiles * radix;
        const unsigned* start = w.starts + (size_t)p * radix;
        const bool first = p == 0, last = p == passes - 1;
        const auto kernel =
            first ? (last ? pass_kernel<true, true> : pass_kernel<true, false>)
                  : (last ? pass_kernel<false, true>
                          : pass_kernel<false, false>);
        kernel<<<tiles, THREADS, 0, stream>>>(
            w.keys[in], w.vals[in], n, p * bits, bits, start, state, counter,
            w.keys[out], w.vals[out], order);
    }
    return (int)cudaGetLastError();
}
