// K7: bitonic merge of each aligned pair of B-runs of an int32 key and up
// to 8 float32 payloads, for the k-sorted carry sort (ops/sort.py).
//
// Replaces the TPU kernel fastpm_tpu/ops/sort_pallas.py:_merge_kernel,
// reached through make_merge_pairs_fn: each 2B-run is DMA'd into VMEM
// and swept by log2(2B) butterfly stages, row strides by sublane
// reshuffles and lane strides by dual lane rolls.
//
// Contract (make_merge_pairs_fn's, not its TPU mechanism): in every
// aligned 2B-run the first B elements ascend and the last B descend; on
// return every 2B-run ascends. The network: stages at XOR strides
// j = B, B/2, ..., 1; at each the lower index of a pair keeps the min,
// and the pair swaps only when key[hi] < key[lo] (no swap on ties), with
// every payload moving with its key. This is the TPU kernel's network
// and tie rule (_butterfly_rows, _butterfly_lanes), so the output is
// bit-identical to it, payload order on ties included. A network does not
// depend on the data: no atomics, the same result on every run.
//
// What bounds it on an H100: device-memory bytes. At the carry sort's
// B = 32768 and 2^24 rows with 6 payloads the bound moves 28 B a row in
// and out once. The port's first design let the payloads ride every
// compare-exchange and ran one stride a launch over device memory: 6
// passes over the 28 B. The design here:
// 1. Key and offset. The swaps depend on the keys alone, so a row's
//    offset inside its 2B-run rides the network in place of its
//    payloads (16 bits where 2B <= 65536, else 32) and undergoes
//    exactly the permutation they would: the payloads are gathered once
//    at the end, out_p[i] = in_p[run + off[i]]. The gather's reads stay
//    inside one 2B-run (256 KB a column at B = 32768), which the blocks
//    of that run read together through L2.
// 2. Several strides a pass, in registers. A tile of kTile (key,
//    offset) pairs sits in a block's shared memory; its strides run in
//    groups of three in registers between shared-memory exchanges, then
//    each warp's 256 pairs alone (the strides 128-32 in registers, 16-1
//    in shuffles), and the block writes the keys and gathers the
//    payloads. Where 2B fits a tile, that one launch does it all.
// 3. A 2B-run of 2 to 8 tiles (B = 8192 ... 32768, the carry sort's
//    runs) is one launch on a thread-block cluster (Hopper's distributed
//    shared memory): each block reads the keys at the run's strides B,
//    B/2, B/4, applies those three stages in registers and writes each
//    pair into the shared memory of the block whose tile holds it; then
//    each block runs its tile. That moves 4 + 4 + 24 + 24 B a row, the
//    bound's 56. (At one block an SM it lost to a register pass and a
//    tile, item 4's form; at two blocks an SM it takes 15 % less time
//    than that form: PERF.md.)
// 4. Longer runs: the strides a tile does not hold run first in register
//    passes over device memory, up to four strides a pass (a thread
//    holds 2^k pairs closed under k strides), then the tile launch.
// The stages run in the network's order, B down to 1, so the network is
// the same one. The (key, offset) intermediate between the launches of
// item 4 lives in the outputs: the keys in out[0], the 32-bit offsets in
// out[1]'s storage, which each tile reads before it writes them; so the
// kernel allocates nothing, and the output payloads must not overlap
// the inputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxPayloads = 8;
constexpr int kTile = 8192;          // (key, offset) pairs of a tile
constexpr int kPerThread = 8;        // pairs a tile thread holds
constexpr int kTileThreads = kTile / kPerThread;
// two tile blocks an SM: at most 32 registers a thread (PERF.md: against
// one block an SM, 19 % less time in a cluster, 2 % alone)
constexpr int kTileBlocksPerSM = 2;
constexpr int kMaxCluster = 8;       // blocks of a portable cluster
constexpr int kPassThreads = 256;
constexpr int kMaxPassStrides = 4;   // strides of one register pass
constexpr unsigned kFull = 0xffffffffu;

// The columns of one side (input or output): the key and P payloads.
struct Columns {
    int* key;
    float* pay[kMaxPayloads];
};

// Compare-exchange of a (lower) and b (upper): the pair swaps only when
// key b < key a.
template <bool OFF, typename Off>
__device__ __forceinline__ void exchange(int& ka, Off& oa, int& kb,
                                         Off& ob) {
    const bool s = kb < ka;
    const int k = ka;
    ka = s ? kb : ka;
    kb = s ? k : kb;
    if (OFF) {
        const Off o = oa;
        oa = s ? ob : oa;
        ob = s ? o : ob;
    }
}

// One register pass over device memory: the K strides 2^top ...
// 2^(top-K+1), which are all >= kTile. FIRST: the keys come from the
// input and the offsets are the rows' places in their runs; else both
// come from the outputs (the offsets in out[1]'s storage), which the
// pass updates in place.
template <int K, bool OFF, bool FIRST>
__global__ void __launch_bounds__(kPassThreads)
merge_pass_kernel(const int* kin, int* kout, uint32_t* off, long long n,
                  int run, int top) {
    using Off = uint32_t;
    constexpr int E = 1 << K;
    const long long g = (long long)blockIdx.x * kPassThreads + threadIdx.x;
    if (g >= n / E) return;
    const int sl = top - (K - 1);   // log2 of the group's lowest stride
    const long long base =
        ((g >> sl) << (sl + K)) | (g & ((1LL << sl) - 1));
    int k[E];
    Off o[E];
#pragma unroll
    for (int m = 0; m < E; ++m) {
        const long long i = base + ((long long)m << sl);
        k[m] = kin[i];
        if (OFF) o[m] = FIRST ? (Off)(i & (run - 1)) : off[i];
    }
#pragma unroll
    for (int b = K - 1; b >= 0; --b) {
#pragma unroll
        for (int m = 0; m < E; ++m)
            if (!(m >> b & 1))
                exchange<OFF>(k[m], o[m], k[m | 1 << b], o[m | 1 << b]);
    }
#pragma unroll
    for (int m = 0; m < E; ++m) {
        const long long i = base + ((long long)m << sl);
        kout[i] = k[m];
        if (OFF) off[i] = o[m];
    }
}

// The strides 2^s ... 1 of one tile of `tile` rows (tile / 8 threads),
// then the keys written and the payloads gathered. global: the tile's
// pairs still lie in device memory (SCRATCH: the keys and 32-bit offsets
// in the outputs, after a register pass; else the keys in the input and
// the offsets the rows' places in their runs); else in skey / soff. A
// group's pair at slot m of thread t lies at
// ((t >> sl) << (sl + 3)) | (t & (2^sl - 1)) | m << sl.
template <bool OFF, typename Off, bool SCRATCH>
__device__ __forceinline__ void tile_network(const Columns& src,
                                             const Columns& dst, int* skey,
                                             Off* soff, long long tb,
                                             int run, int s, bool global,
                                             int P) {
    const int* gkey = SCRATCH ? dst.key : src.key;
    const Off* goff = reinterpret_cast<const Off*>(dst.pay[0]);
    const int t = threadIdx.x;
    int k[kPerThread];
    Off o[kPerThread];
    // groups of three strides >= 64 through shared memory
    for (; s >= 8; s -= 3) {
        const int sl = s - 2;
        const int base = ((t >> sl) << (sl + 3)) | (t & ((1 << sl) - 1));
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) {
            const int p = base | m << sl;
            if (global) {
                k[m] = gkey[tb + p];
                if (OFF)
                    o[m] = SCRATCH ? goff[tb + p]
                                   : (Off)((tb + p) & (run - 1));
            } else {
                k[m] = skey[p];
                if (OFF) o[m] = soff[p];
            }
        }
#pragma unroll
        for (int b = 2; b >= 0; --b) {
#pragma unroll
            for (int m = 0; m < kPerThread; ++m)
                if (!(m >> b & 1))
                    exchange<OFF>(k[m], o[m], k[m | 1 << b], o[m | 1 << b]);
        }
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) {
            const int p = base | m << sl;
            skey[p] = k[m];
            if (OFF) soff[p] = o[m];
        }
        global = false;
        __syncthreads();
    }
    // each warp's 256 pairs: slot m of lane l at warp * 256 + m * 32 + l
    const int lane = t & 31;
    const int wbase = (t >> 5) * 256 + lane;
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
        const int p = wbase + m * 32;
        if (global) {
            k[m] = gkey[tb + p];
            if (OFF)
                o[m] = SCRATCH ? goff[tb + p]
                               : (Off)((tb + p) & (run - 1));
        } else {
            k[m] = skey[p];
            if (OFF) o[m] = soff[p];
        }
    }
    // strides 128, 64, 32: bits 2, 1, 0 of the slot
#pragma unroll
    for (int b = 2; b >= 0; --b) {
        if (b + 5 > s) continue;
#pragma unroll
        for (int m = 0; m < kPerThread; ++m)
            if (!(m >> b & 1))
                exchange<OFF>(k[m], o[m], k[m | 1 << b], o[m | 1 << b]);
    }
    // strides 16 ... 1: the lanes; both lanes of a pair take the same
    // decision (swap when the upper key is below the lower one)
#pragma unroll
    for (int b = 4; b >= 0; --b) {
        if (b > s) continue;
        const bool upper = lane >> b & 1;
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) {
            const int pk = __shfl_xor_sync(kFull, k[m], 1 << b);
            const bool swap = upper ? k[m] < pk : pk < k[m];
            k[m] = swap ? pk : k[m];
            if (OFF) {
                const unsigned po =
                    __shfl_xor_sync(kFull, (unsigned)o[m], 1 << b);
                o[m] = swap ? (Off)po : o[m];
            }
        }
    }
    // (a tile that read the scratch ran a shared group, whose barrier
    // has passed: no warp still reads what these writes overwrite)
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) dst.key[tb + wbase + m * 32] = k[m];
    if (!OFF) return;
    // the gather: each row's payloads from its place in its run (a
    // warp's 256 rows lie in one run: 2B >= 256)
    const long long rb = (tb + wbase - lane) & ~(long long)(run - 1);
#pragma unroll
    for (int q = 0; q < kMaxPayloads; ++q) {
        if (q >= P) break;
        const float* in = src.pay[q];
        float* out = dst.pay[q];
        float v[kPerThread];
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) v[m] = __ldg(in + rb + o[m]);
#pragma unroll
        for (int m = 0; m < kPerThread; ++m) out[tb + wbase + m * 32] = v[m];
    }
}

// One tile a block: the strides 2^top ... 1.
template <bool OFF, typename Off, bool SCRATCH>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSM)
merge_tile_kernel(Columns src, Columns dst, int tile, int run, int top,
                  int P) {
    extern __shared__ int smem[];
    tile_network<OFF, Off, SCRATCH>(
        src, dst, smem, reinterpret_cast<Off*>(smem + tile),
        (long long)blockIdx.x * tile, run, top, true, P);
}

// A 2B-run over a cluster of 2B / kTile blocks (2-8), each with one tile
// of the run in its shared memory: the strides B, B/2, B/4 in registers
// (thread t of block r holds the pairs (r * kTile / 8 + t) + m * 2B / 8
// of the run, read from the input), each pair written into the shared
// memory of the block whose tile holds it, then the tile's strides. The
// pairs of a thread lie in every block of the cluster, so its first
// barrier also makes sure they have all started.
template <bool OFF>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSM)
merge_cluster_kernel(Columns src, Columns dst, int run, int sB, int P) {
    using Off = uint16_t;
    extern __shared__ int smem[];
    int* skey = smem;
    Off* soff = reinterpret_cast<Off*>(smem + kTile);
    cg::cluster_group cluster = cg::this_cluster();
    const long long tb = (long long)blockIdx.x * kTile;
    const long long rb = tb & ~(long long)(run - 1);
    const int sl = sB - 2;
    const int lo = (int)((tb - rb) >> 3) + threadIdx.x;
    int k[kPerThread];
    Off o[kPerThread];
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
        const int p = lo + (m << sl);
        k[m] = src.key[rb + p];
        if (OFF) o[m] = (Off)p;
    }
#pragma unroll
    for (int b = 2; b >= 0; --b) {
#pragma unroll
        for (int m = 0; m < kPerThread; ++m)
            if (!(m >> b & 1))
                exchange<OFF>(k[m], o[m], k[m | 1 << b], o[m | 1 << b]);
    }
    cluster.sync();   // every block of the cluster has started
#pragma unroll
    for (int m = 0; m < kPerThread; ++m) {
        const int p = lo + (m << sl);
        const unsigned owner = (unsigned)(p / kTile);
        cluster.map_shared_rank(skey, owner)[p % kTile] = k[m];
        if (OFF) cluster.map_shared_rank(soff, owner)[p % kTile] = o[m];
    }
    cluster.sync();
    tile_network<OFF, Off, false>(src, dst, skey, soff, tb, run, sB - 3,
                                  false, P);
}

int log2_exact(long long v) {
    int s = 0;
    while ((1LL << s) < v) ++s;
    return (1LL << s) == v ? s : -1;
}

template <bool OFF, bool FIRST>
cudaError_t launch_pass(int K, const int* kin, int* kout, uint32_t* off,
                        long long n, int run, int top, cudaStream_t stream) {
    const long long threads = n >> K;
    const unsigned int blocks =
        (unsigned int)((threads + kPassThreads - 1) / kPassThreads);
    switch (K) {
        case 1:
            merge_pass_kernel<1, OFF, FIRST>
                <<<blocks, kPassThreads, 0, stream>>>(kin, kout, off, n,
                                                      run, top);
            break;
        case 2:
            merge_pass_kernel<2, OFF, FIRST>
                <<<blocks, kPassThreads, 0, stream>>>(kin, kout, off, n,
                                                      run, top);
            break;
        case 3:
            merge_pass_kernel<3, OFF, FIRST>
                <<<blocks, kPassThreads, 0, stream>>>(kin, kout, off, n,
                                                      run, top);
            break;
        default:
            merge_pass_kernel<4, OFF, FIRST>
                <<<blocks, kPassThreads, 0, stream>>>(kin, kout, off, n,
                                                      run, top);
    }
    return cudaGetLastError();
}

template <bool OFF, typename Off, bool SCRATCH>
cudaError_t launch_tile(const Columns& src, const Columns& dst, long long n,
                        int tile, int run, int top, int P,
                        cudaStream_t stream) {
    const int smem = tile * (int)(sizeof(int) + (OFF ? sizeof(Off) : 0));
    cudaError_t e = cudaFuncSetAttribute(
        merge_tile_kernel<OFF, Off, SCRATCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const unsigned int blocks = (unsigned int)(n / tile);
    const int threads = tile / kPerThread;   // <= kTileThreads
    merge_tile_kernel<OFF, Off, SCRATCH><<<blocks, threads, smem, stream>>>(
        src, dst, tile, run, top, P);
    return cudaGetLastError();
}

// One merge of 2B-runs that a tile holds: one tile launch, 16-bit
// offsets (OFF: there are payloads).
template <bool OFF>
cudaError_t merge_in_tiles(const Columns& src, const Columns& dst,
                           long long n, int sB, int P, cudaStream_t stream) {
    const long long low = n & -n;      // n's largest power-of-two factor
    const int tile = (int)(low < kTile ? low : kTile);
    return launch_tile<OFF, uint16_t, false>(src, dst, n, tile, 2 << sB, sB,
                                             P, stream);
}

// One merge of 2B-runs longer than kMaxCluster tiles: register passes
// over the strides a tile does not hold, then the tile launch, 32-bit
// offsets.
template <bool OFF>
cudaError_t merge_in_passes(const Columns& src, const Columns& dst,
                            long long n, int sB, int P,
                            cudaStream_t stream) {
    const int run = 2 << sB;
    const int sT = log2_exact(kTile);
    uint32_t* off = reinterpret_cast<uint32_t*>(dst.pay[0]);
    int s = sB;
    bool first = true;
    while (s >= sT) {
        const int K = s - sT + 1 < kMaxPassStrides ? s - sT + 1
                                                   : kMaxPassStrides;
        const cudaError_t e =
            first ? launch_pass<OFF, true>(K, src.key, dst.key, off, n, run,
                                           s, stream)
                  : launch_pass<OFF, false>(K, dst.key, dst.key, off, n, run,
                                            s, stream);
        if (e != cudaSuccess) return e;
        s -= K;
        first = false;
    }
    return launch_tile<OFF, uint32_t, true>(src, dst, n, kTile, run, s, P,
                                            stream);
}

// One merge of 2B-runs of 2 to kMaxCluster tiles on clusters.
template <bool OFF>
cudaError_t launch_cluster(const Columns& src, const Columns& dst,
                           long long n, int sB, int P, cudaStream_t stream) {
    const int run = 2 << sB;
    const int smem = kTile * (int)(sizeof(int) + (OFF ? 2 : 0));
    cudaError_t e = cudaFuncSetAttribute(
        merge_cluster_kernel<OFF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)(n / kTile));
    cfg.blockDim = dim3(kTileThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = run / kTile;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, merge_cluster_kernel<OFF>, src, dst, run,
                           sB, P);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace

// Merge every aligned pair of B-runs of n rows: in[0] / out[0] are the
// int32 keys, in[1..P] / out[1..P] the float32 payloads (host arrays of
// 1 + P device pointers, each 4-byte aligned; out's payloads must not
// overlap in's, since out holds the network's scratch). B is a power of
// two >= 128, n a multiple of 2B, 0 <= P <= 8. Runs on `stream`; returns
// cudaGetLastError() after each launch, or the error of a refused
// argument.
extern "C" int fastpm_bitonic_merge(void* const* in, void* const* out, int P,
                                    long long n, int B,
                                    cudaStream_t stream) {
    const int sB = log2_exact(B);
    if (P < 0 || P > kMaxPayloads || sB < 7 || n < 0 || n % (2LL * B))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    Columns src{}, dst{};
    src.key = static_cast<int*>(in[0]);
    dst.key = static_cast<int*>(out[0]);
    for (int p = 0; p < P; ++p) {
        src.pay[p] = static_cast<float*>(in[1 + p]);
        dst.pay[p] = static_cast<float*>(out[1 + p]);
    }
    cudaError_t e;
    if (2LL * B <= kTile)
        e = P ? merge_in_tiles<true>(src, dst, n, sB, P, stream)
              : merge_in_tiles<false>(src, dst, n, sB, P, stream);
    else if (2LL * B <= (long long)kMaxCluster * kTile)
        e = P ? launch_cluster<true>(src, dst, n, sB, P, stream)
              : launch_cluster<false>(src, dst, n, sB, P, stream);
    else
        e = P ? merge_in_passes<true>(src, dst, n, sB, P, stream)
              : merge_in_passes<false>(src, dst, n, sB, P, stream);
    return (int)e;
}
