// The force's k-space pass: one gradient of the potential, in one pass
// over delta_k.
//
// Replaces no TPU kernel: the JAX package leaves the potential transfer
// and the gradients (fastpm_tpu/transfers.py, mesh.py's c2r_grad3) to
// XLA, which fuses them. Eager PyTorch runs them as a chain of separate
// passes over the hermitian-compressed mesh (transfers.apply_decic,
// apply_pot, apply_grad, PM.c2r's Norm), each a complex field times a
// float32 broadcast through PyTorch's generic elementwise kernel, with
// |k|^2 and the Nyquist mask rebuilt or read as full-size float tensors.
// This kernel computes, for axis d, every mode (i, j, l) of the
// (n0, n1, n2) complex64 input as
//
//   out = Norm * (i g_d) * mask * (-1 / kk) * deconv * delta_k
//
// from the PM's 1D tables: kk = (t0[i] + t1[j]) + t2[l] (the potential
// order's |k|^2 tables; 1 / kk is 0 at kk == 0), g_d the gradient table
// along d, mask 0 where all three 1D Nyquist masks hold, deconv the
// per-axis CIC deconvolution tables applied `deconv` times (the kernel
// type's deconvolveorder). Every product is rounded on its own in the
// chain's order (deconv, 1 / kk, negation, i g_d, mask, Norm) with the
// _rn intrinsics, which the compiler never contracts into a fused
// multiply-add, and 1 / kk is IEEE division: so the output equals the
// chain's bit for bit (ops/kspace.py's plain version is that chain).
//
// What bounds it on an H100: device-memory bytes. delta_k read once and
// the gradient written once, 16 bytes a mode: at 1024^3 (537.9 M modes)
// 8.61 GB, 2.57 ms at 3.35 TB/s. The tables are a few KB and stay in L1.
// The design:
// 1. 16-byte loads and stores: a thread takes two neighbouring modes
//    (one float4) a step of a grid-stride loop over the flat index in
//    memory, 64-bit, with streaming cache hints (the fields are read and
//    written once). Rows of Nz/2 + 1 modes are not 16-byte aligned, so a
//    pair may straddle two rows: the mode's coordinates come from the
//    flat index. cuFFT's r2c output, and so delta_k, need not be laid
//    out in (x, y, z) order: the kernel walks memory in order, and each
//    axis is told where in that order it lies (its stride's rank). A
//    pointer that is not 16-byte aligned (or an odd count of modes)
//    takes a loop of single modes.
// 2. One resident wave: as many blocks as the SMs hold, each looping,
//    so the index arithmetic (two 32-bit divisions a pair while the flat
//    index fits 32 bits) hides under the loads.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Params {
    const float2* in;
    float2* out;
    long long m;            // modes
    int n_mid, n_in;        // sizes of the middle and innermost memory axes
    int pos[3];             // memory position of axis x, y, z (0 outermost)
    const float* kk[3];     // |k|^2 tables along x, y, z
    const float* grad;      // gradient table along `axis`
    int axis;
    const unsigned char* nyq[3];  // 1D Nyquist masks
    int deconv;             // times the deconvolution tables apply
    const float* dc[3];     // deconvolution tables (unused when deconv 0)
    float norm;
};

// a mode's coordinates in memory order: c innermost
struct Mode {
    int a, b, c;
};

__device__ __forceinline__ Mode locate(long long p, const Params& a) {
    Mode m;
    long long r;
    if (p < 0xffffffffLL) {
        const unsigned int q = (unsigned int)p / (unsigned int)a.n_in;
        m.c = (int)((unsigned int)p - q * (unsigned int)a.n_in);
        r = q;
    } else {
        r = p / a.n_in;
        m.c = (int)(p - r * a.n_in);
    }
    const unsigned int rr = (unsigned int)r;
    m.a = (int)(rr / (unsigned int)a.n_mid);
    m.b = (int)(rr - (unsigned int)m.a * (unsigned int)a.n_mid);
    return m;
}

__device__ __forceinline__ void advance(Mode& m, const Params& a) {
    if (++m.c == a.n_in) {
        m.c = 0;
        if (++m.b == a.n_mid) {
            m.b = 0;
            ++m.a;
        }
    }
}

// a mode's coordinates along x, y, z
struct Index {
    int i, j, l;
};

// the coordinate of the axis at memory position `pos`
__device__ __forceinline__ int along(int pos, const Mode& m) {
    return pos == 0 ? m.a : (pos == 1 ? m.b : m.c);
}

__device__ __forceinline__ float2 grad_mode(float2 v, const Mode& mm,
                                            const Params& a) {
    const Index m{along(a.pos[0], mm), along(a.pos[1], mm),
                  along(a.pos[2], mm)};
    float re = v.x, im = v.y;
    for (int r = 0; r < a.deconv; ++r) {
        const float f[3] = {__ldg(a.dc[0] + m.i), __ldg(a.dc[1] + m.j),
                            __ldg(a.dc[2] + m.l)};
        for (int e = 0; e < 3; ++e) {
            re = __fmul_rn(re, f[e]);
            im = __fmul_rn(im, f[e]);
        }
    }
    const float kk = __fadd_rn(
        __fadd_rn(__ldg(a.kk[0] + m.i), __ldg(a.kk[1] + m.j)),
        __ldg(a.kk[2] + m.l));
    const float inv = kk != 0.0f ? __fdiv_rn(1.0f, kk) : 0.0f;
    re = -__fmul_rn(re, inv);
    im = -__fmul_rn(im, inv);
    const int at = a.axis == 0 ? m.i : (a.axis == 1 ? m.j : m.l);
    const float g = __ldg(a.grad + at);
    // i g (re + i im) = -im g + i re g
    float gre = -__fmul_rn(im, g);
    float gim = __fmul_rn(re, g);
    const float keep = (__ldg(a.nyq[0] + m.i) & __ldg(a.nyq[1] + m.j)
                        & __ldg(a.nyq[2] + m.l)) ? 0.0f : 1.0f;
    gre = __fmul_rn(gre, keep);
    gim = __fmul_rn(gim, keep);
    return make_float2(__fmul_rn(gre, a.norm), __fmul_rn(gim, a.norm));
}

__global__ void __launch_bounds__(THREADS)
kspace_grad_pairs(const Params a) {
    const long long stride = (long long)gridDim.x * THREADS;
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const float4* in4 = reinterpret_cast<const float4*>(a.in);
    float4* out4 = reinterpret_cast<float4*>(a.out);
    const long long pairs = a.m / 2;
    for (long long q = t; q < pairs; q += stride) {
        const float4 v = __ldcs(in4 + q);
        Mode m = locate(2 * q, a);
        const float2 lo = grad_mode(make_float2(v.x, v.y), m, a);
        advance(m, a);
        const float2 hi = grad_mode(make_float2(v.z, v.w), m, a);
        __stcs(out4 + q, make_float4(lo.x, lo.y, hi.x, hi.y));
    }
}

__global__ void __launch_bounds__(THREADS)
kspace_grad_modes(const Params a) {
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
         p < a.m; p += stride)
        a.out[p] = grad_mode(a.in[p], locate(p, a), a);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <typename K>
int launch(K kernel, const Params& a, long long work, cudaStream_t stream) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  0);
    long long blocks = (work + THREADS - 1) / THREADS;
    const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (blocks > wave) blocks = wave;
    if (blocks < 1) blocks = 1;
    kernel<<<(unsigned int)blocks, THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// One gradient of the potential of delta_k (n0 x n1 x n2 complex64,
// device, dense: its axes x, y, z at memory positions pos0, pos1, pos2,
// a permutation of 0 (outermost), 1, 2 (stride 1)) into out (the same
// shape and strides; not delta_k): the tables are device arrays, kk0 /
// nyq0 / dc0 n0 long, kk1 / nyq1 / dc1 n1 long, kk2 / nyq2 / dc2 n2
// long, grad as long as the mesh along `axis` (0, 1, 2); nyq* are bytes
// (nonzero: the coordinate is 0 or Nyquist); dc* may be null when
// deconv is 0. Returns cudaGetLastError().
extern "C" int fastpm_kspace_grad(const void* in, void* out, int n0, int n1,
                                  int n2, int pos0, int pos1, int pos2,
                                  const float* kk0, const float* kk1,
                                  const float* kk2, const float* grad,
                                  int axis,
                                  const unsigned char* nyq0,
                                  const unsigned char* nyq1,
                                  const unsigned char* nyq2, int deconv,
                                  const float* dc0, const float* dc1,
                                  const float* dc2, float norm,
                                  cudaStream_t stream) {
    const int n[3] = {n0, n1, n2}, pos[3] = {pos0, pos1, pos2};
    int size[3] = {-1, -1, -1};
    for (int e = 0; e < 3; ++e)
        if (pos[e] >= 0 && pos[e] < 3) size[pos[e]] = n[e];
    if (n0 < 0 || n1 < 0 || n2 < 0 || size[0] < 0 || size[1] < 0
        || size[2] < 0 || axis < 0 || axis > 2 || deconv < 0
        || (deconv > 0 && (!dc0 || !dc1 || !dc2)))
        return (int)cudaErrorInvalidValue;
    const long long m = (long long)n0 * n1 * n2;
    if (m == 0) return (int)cudaGetLastError();
    const Params a{static_cast<const float2*>(in), static_cast<float2*>(out),
                   m, size[1], size[2], {pos0, pos1, pos2},
                   {kk0, kk1, kk2}, grad, axis, {nyq0, nyq1, nyq2}, deconv,
                   {dc0, dc1, dc2}, norm};
    // pairs need an even count, which every PM's (even) mesh gives
    if (aligned16(in) && aligned16(out) && m % 2 == 0)
        return launch(kspace_grad_pairs, a, m / 2, stream);
    return launch(kspace_grad_modes, a, m, stream);
}
