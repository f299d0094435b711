// K6: CIC readout of the three force fields in two passes, one per x
// plane of the cloud: periodic fields, or one rank's extended x-slabs.
//
// Replaces the TPU kernel fastpm_tpu/ops/readout_pallas.py:
// _readout_kernel4, which gathers each pass's 4 corners from padded
// windows and writes 3 value rows per pass, 6 in all, that the caller
// sums (readout_pallas.py:1416-1419). Two factories reach it:
// make_readout3_from4_fn (periodic fields) and
// make_readout3_from4_homed_fn (the homed slab force's extended slabs,
// open in x), which the homed force takes with homed_kernel="from4".
//
// Contract: pass dx writes part[dx, i, c] = sum over the 4 corners of x
// plane dx of w * field_c (cic_common.cuh); the caller adds the two
// passes. In the homed form a particle beyond the slab reads zero. Pass
// dx of particle i is thread i of grid row blockIdx.y = dx.
//
// What bounds it on an H100: as K2, device-memory bytes on sorted
// particles and load latency on unsorted ones, plus the (2, N, 3)
// partial buffer written and read back once (24 B a particle each way).
// Each pass recomputes the cell and fraction.

#include "cic_common.cuh"

namespace {

using fastpm_cic::XAxis;

__global__ void cic_readout4_kernel(const float* __restrict__ x, long long n,
                                    int nx, int ny, int nz,
                                    float icx, float icy, float icz,
                                    XAxis ax,
                                    const float* __restrict__ f0,
                                    const float* __restrict__ f1,
                                    const float* __restrict__ f2,
                                    float* __restrict__ part) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int dx = blockIdx.y;
    if (i >= n) return;
    float* out = part + ((size_t)dx * n + i) * 3;
    int lo[3], hi[3];
    float f[3], t[3];
    if (!fastpm_cic::cell(x, i, nx, ny, nz, icx, icy, icz, ax, lo, hi, f,
                          t)) {
        out[0] = out[1] = out[2] = 0.0f;
        return;
    }
    size_t idx[4];
    float w[4];
    fastpm_cic::plane_corners(dx, lo, hi, f, t, ny, nz, idx, w);
    out[0] = fastpm_cic::gather(f0, idx, w, 4);
    out[1] = fastpm_cic::gather(f1, idx, w, 4);
    out[2] = fastpm_cic::gather(f2, idx, w, 4);
}

}  // namespace

// Read the three fields (each nx*ny*nz float32, device) at n particles
// (x: n x 3 float32, device) into part (2 x n x 3 float32, device), one
// x plane of the cloud per leading index, on `stream`. n0 == 0: periodic
// in x; n0 > 0: the extended slab, open in x over a global mesh of n0
// planes with shift H - r0. Returns cudaGetLastError().
extern "C" int fastpm_cic_readout4(const float* x, long long n, int nx,
                                   int ny, int nz, float icx, float icy,
                                   float icz, int n0, int shift,
                                   const float* f0, const float* f1,
                                   const float* f2, float* part,
                                   cudaStream_t stream) {
    if (n0 < 0 || (n0 > 0 && nx < 2)) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int threads = 256;
        const dim3 blocks((unsigned int)((n + threads - 1) / threads), 2);
        cic_readout4_kernel<<<blocks, threads, 0, stream>>>(
            x, n, nx, ny, nz, icx, icy, icz, XAxis{n0, shift}, f0, f1, f2,
            part);
    }
    return (int)cudaGetLastError();
}
