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
// Design: a tile of kTile elements (key and payloads) fits in shared
// memory, and a tile holds every pair of the strides below it. The
// strides j >= kTile run as one launch each over device memory, one
// thread per compare pair; the first launch reads the input and writes
// the output, the later ones work in place and write only the pairs they
// swap. The remaining strides run in one launch: each block loads a
// tile, sweeps the strides with __syncthreads() between them and writes
// the tile back. When 2B <= kTile there is only that launch.
//
// What bounds it on an H100: device-memory bytes. At the carry sort's
// B = 32768 and 2^24 rows with 6 payloads one merge moves 28 B a row in
// and out per launch: 6 device-memory stages plus the tile launch, so
// 7 passes over the data where the bound counts one. Register-resident
// networks that merge several strides per pass, and TMA tiles, are left
// for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPayloads = 8;
constexpr int kTile = 2048;            // elements of a shared-memory tile
constexpr int kStageThreads = 256;

// The columns of one side (input or output): the key and P payloads.
struct Columns {
    int* key;
    float* pay[kMaxPayloads];
};

// The lower index of compare pair t at stride 2^s: t with a zero bit
// inserted at position s.
__device__ __forceinline__ long long lower(long long t, int s) {
    return ((t >> s) << (s + 1)) | (t & ((1LL << s) - 1));
}

// One stride 2^s over device memory, one thread per compare pair. With
// src == dst it works in place and writes only swapped pairs.
__global__ void merge_stage_kernel(Columns src, Columns dst, long long pairs,
                                   int s, int P) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= pairs) return;
    const long long lo = lower(t, s);
    const long long hi = lo + (1LL << s);
    const int a = src.key[lo], b = src.key[hi];
    const bool swap = b < a;
    if (!swap && src.key == dst.key) return;
    dst.key[lo] = swap ? b : a;
    dst.key[hi] = swap ? a : b;
#pragma unroll
    for (int p = 0; p < kMaxPayloads; ++p) {
        if (p < P) {
            const float u = src.pay[p][lo], w = src.pay[p][hi];
            dst.pay[p][lo] = swap ? w : u;
            dst.pay[p][hi] = swap ? u : w;
        }
    }
}

// The strides 2^smax, ..., 1 of one tile of `tile` elements in shared
// memory (key, then the P payloads, each `tile` long).
__global__ void merge_tile_kernel(Columns src, Columns dst, int tile,
                                  int smax, int P) {
    extern __shared__ int smem[];
    int* key = smem;
    float* pay = reinterpret_cast<float*>(smem + tile);
    const long long base = (long long)blockIdx.x * tile;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        key[i] = src.key[base + i];
#pragma unroll
        for (int p = 0; p < kMaxPayloads; ++p)
            if (p < P) pay[p * tile + i] = src.pay[p][base + i];
    }
    __syncthreads();
    for (int s = smax; s >= 0; --s) {
        for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
            const int lo = ((t >> s) << (s + 1)) | (t & ((1 << s) - 1));
            const int hi = lo + (1 << s);
            const int a = key[lo], b = key[hi];
            if (b < a) {
                key[lo] = b;
                key[hi] = a;
#pragma unroll
                for (int p = 0; p < kMaxPayloads; ++p) {
                    if (p < P) {
                        const float u = pay[p * tile + lo];
                        pay[p * tile + lo] = pay[p * tile + hi];
                        pay[p * tile + hi] = u;
                    }
                }
            }
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        dst.key[base + i] = key[i];
#pragma unroll
        for (int p = 0; p < kMaxPayloads; ++p)
            if (p < P) dst.pay[p][base + i] = pay[p * tile + i];
    }
}

int log2_exact(long long v) {
    int s = 0;
    while ((1LL << s) < v) ++s;
    return (1LL << s) == v ? s : -1;
}

}  // namespace

// Merge every aligned pair of B-runs of n rows: in[0] / out[0] are the
// int32 keys, in[1..P] / out[1..P] the float32 payloads (host arrays of
// 1 + P device pointers; out may equal in). B is a power of two, n a
// multiple of 2B, 0 <= P <= 8. Runs on `stream`; returns
// cudaGetLastError() or the error of a refused argument.
extern "C" int fastpm_bitonic_merge(void* const* in, void* const* out, int P,
                                    long long n, int B,
                                    cudaStream_t stream) {
    const int sB = log2_exact(B);
    if (P < 0 || P > kMaxPayloads || sB < 0 || n < 0 || n % (2LL * B))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    Columns src{}, dst{};
    src.key = static_cast<int*>(in[0]);
    dst.key = static_cast<int*>(out[0]);
    for (int p = 0; p < P; ++p) {
        src.pay[p] = static_cast<float*>(in[1 + p]);
        dst.pay[p] = static_cast<float*>(out[1 + p]);
    }
    const int tile = 2 * B < kTile ? 2 * B : kTile;
    const int sTile = log2_exact(tile);
    const long long pairs = n / 2;
    // the strides a tile does not hold
    for (int s = sB; s >= sTile; --s) {
        const long long blocks = (pairs + kStageThreads - 1) / kStageThreads;
        merge_stage_kernel<<<(unsigned int)blocks, kStageThreads, 0,
                             stream>>>(src, dst, pairs, s, P);
        src = dst;
    }
    const int smem = (1 + P) * tile * (int)sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            merge_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    merge_tile_kernel<<<(unsigned int)(n / tile), tile / 2, smem, stream>>>(
        src, dst, tile, sTile - 1, P);
    return (int)cudaGetLastError();
}
