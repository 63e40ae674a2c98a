// 4x4 FIR blur over an NHWC float32 tensor: upfirdn2d(x, k, up=1, down=1,
// pad=(p0, p1)) with k a 4x4 kernel (gain already folded in).
//
// Replaces the TPU kernel content_aware_gan_compression_tpu/ops/pallas/
// upfirdn2d_pallas.py:_blur4_padded, forward and backward: the backward
// (_blur4_bwd) is this kernel again with the taps flipped back and pads
// (3-p0, 3-p1), launched by ops/cuda/blur4.py:Blur4Fn. The TPU version pads
// with an XLA op and DMAs row tiles with a halo into VMEM. Here the pad is
// never materialised: taps that fall outside the input read 0.
//
// Bound on an H100: memory. 16 taps of 2 flops per output element against
// 8 bytes per element (one read, one write) is 4 flop/byte, far below the
// card's fp32 ridge point, so the least time is 4 * (|x| + |out|) bytes over
// the memory rate. To get near it the kernel has to (a) read each input
// element from HBM about once, and (b) spend few instructions per byte so
// that issue does not become the limit instead. The design:
//
// - Tiling, no per-element division. Grid z is the image, grid y a strip of
//   `th` output rows, grid x the tiles of `tw` output columns times the
//   channel tiles (one division per block). A block is (cv_tile, tw)
//   threads: x the channel vector, y the column, so a warp's accesses to one
//   row are consecutive addresses. One 64-bit base per image, 32-bit offsets
//   inside it (the wrapper refuses images of 2^31 elements or more).
// - Vector lanes along C. With C % 4 == 0 and 16-byte aligned pointers each
//   thread carries a float4 (VEC = 4): one 16-byte load per tap and one
//   16-byte store per output. Otherwise the same tiling with scalar lanes.
// - Row reuse in registers. Each thread walks down its strip of th output
//   rows reading th + 3 input rows once each. Every input row it loads feeds
//   the 4 output rows that use it, through a 4-deep ring of accumulators
//   held in registers (a0 completes next, a3 starts with this row). So a
//   row is fetched from memory once per strip, and the 3-row halo between
//   strips costs 3/th re-reads, which neighbouring strips, in flight at the
//   same time, mostly take from L2. Strips of 32 rows and blocks of 256
//   threads measured best (PERF.md).
// - Horizontal taps from L1. The 4 columns a thread needs are its own and
//   its 3 right neighbours', which the neighbouring threads of the block
//   load in the same instruction; L1 serves the repeats. The next row's 4
//   loads are issued before the current row's 16 multiply-adds, so two rows
//   are in flight per thread. A variant that staged rows in shared memory
//   (16-byte cp.async, 4 buffers, zero-filled halo) was 2% slower with
//   float4 lanes and 23% slower with scalar lanes on the same plan
//   (PERF.md), so the kernel needs no shared memory and no barrier.
// - Taps stay kernel arguments (the constant bank), so one binary serves
//   every kernel and gain.
#include <cuda_runtime.h>

namespace {

// Correlation taps (the FIR kernel flipped on both axes), row-major [di][dj],
// passed by value so one binary serves every kernel and gain.
struct Taps {
    float t[16];
};

template <int VEC>
struct Lane;

template <>
struct Lane<4> {
    using T = float4;
    static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    static __device__ __forceinline__ T load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ void store(float* p, T v) {
        *reinterpret_cast<float4*>(p) = v;
    }
    static __device__ __forceinline__ T fma(float t, T v, T a) {
        return make_float4(fmaf(t, v.x, a.x), fmaf(t, v.y, a.y), fmaf(t, v.z, a.z),
                           fmaf(t, v.w, a.w));
    }
};

template <>
struct Lane<1> {
    using T = float;
    static __device__ __forceinline__ T zero() { return 0.f; }
    static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
    static __device__ __forceinline__ T fma(float t, T v, T a) { return fmaf(t, v, a); }
};

// The 4 taps of one input row that `col` (this thread's 4 columns, as
// element offsets in the row, with `cok` whether each lies inside it) feeds.
template <int VEC>
__device__ __forceinline__ void load_row(typename Lane<VEC>::T (&v)[4], const float* xb,
                                         int ih, int H, int row_stride, const int (&col)[4],
                                         const bool (&cok)[4]) {
    using L = Lane<VEC>;
    const bool rok = (unsigned)ih < (unsigned)H;  // the same for the whole block
    const float* xr = xb + (rok ? ih * row_stride : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (rok && cok[j]) ? L::load(xr + col[j]) : L::zero();
}

template <int VEC>
__device__ __forceinline__ void add_row(const Taps& taps, int di,
                                        const typename Lane<VEC>::T (&v)[4],
                                        typename Lane<VEC>::T& acc) {
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) acc = Lane<VEC>::fma(taps.t[di * 4 + dj], v[dj], acc);
}

template <int VEC>
__global__ void __launch_bounds__(512) blur4_tiled(const float* __restrict__ x,
                                                   float* __restrict__ out, Taps taps, int H,
                                                   int W, int C, int Ho, int Wo, int p0, int th,
                                                   int n_ctiles) {
    using L = Lane<VEC>;
    using V = typename L::T;
    const int ctile = blockIdx.x % n_ctiles;  // once per block
    const int wtile = blockIdx.x / n_ctiles;
    const int c = (ctile * blockDim.x + threadIdx.x) * VEC;
    const int ow = wtile * blockDim.y + threadIdx.y;
    if (c >= C || ow >= Wo) return;  // the ragged edge; no barrier follows
    const int oh0 = blockIdx.y * th;
    const int n_in = min(th, Ho - oh0) + 3;  // input rows this strip reads
    const int row_stride = W * C;
    const int out_row = Wo * C;
    const float* xb = x + (long long)blockIdx.z * (H * row_stride) + c;
    float* ob = out + (long long)blockIdx.z * (Ho * out_row) + oh0 * out_row + ow * C + c;

    int col[4];
    bool cok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int iw = ow - p0 + j;
        cok[j] = (unsigned)iw < (unsigned)W;
        col[j] = iw * C;
    }

    V a0 = L::zero(), a1 = L::zero(), a2 = L::zero(), a3 = L::zero();
    V cur[4], nxt[4];
    int ih = oh0 - p0;
    load_row<VEC>(cur, xb, ih, H, row_stride, col, cok);
#pragma unroll 2
    for (int i = 0; i < n_in; ++i, ++ih) {
        if (i + 1 < n_in) load_row<VEC>(nxt, xb, ih + 1, H, row_stride, col, cok);
        // input row ih is tap row di of output row ih + p0 - di
        add_row<VEC>(taps, 3, cur, a0);
        add_row<VEC>(taps, 2, cur, a1);
        add_row<VEC>(taps, 1, cur, a2);
        add_row<VEC>(taps, 0, cur, a3);
        if (i >= 3) L::store(ob + (i - 3) * out_row, a0);  // output row oh0 + i - 3 is done
        a0 = a1;
        a1 = a2;
        a2 = a3;
        a3 = L::zero();
#pragma unroll
        for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
    }
}

}  // namespace

extern "C" {

// x: [B, H, W, C] contiguous; out: [B, H+p0+p1-3, W+p0+p1-3, C] contiguous;
// taps16: host pointer to the 16 correlation taps. The launch plan
// (ops/cuda/blur4.py:launch_plan): vec lanes per thread (4 needs C % 4 == 0
// and 16-byte aligned pointers), blocks of (cv_tile, tw) threads, strips of
// th rows, n_ctiles channel tiles, a (grid_x, grid_y, B) grid and smem_bytes
// of dynamic shared memory. stream: a cudaStream_t of `device`. Launches on
// `device` and gives the calling thread its current device back. Returns
// cudaGetLastError() after the launch.
int blur4_forward(const void* x, void* out, const float* taps16, int B, int H, int W, int C,
                  int p0, int p1, int vec, int cv_tile, int tw, int th, int n_ctiles,
                  int grid_x, int grid_y, int smem_bytes, int device, void* stream) {
    const int Ho = H + p0 + p1 - 3;
    const int Wo = W + p0 + p1 - 3;
    if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0) return (int)cudaSuccess;
    if ((vec != 1 && vec != 4) || C % vec != 0) return (int)cudaErrorInvalidValue;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Taps taps;
    for (int i = 0; i < 16; ++i) taps.t[i] = taps16[i];
    const dim3 grid(grid_x, grid_y, B), block(cv_tile, tw);
    if (vec == 4) {
        blur4_tiled<4><<<grid, block, smem_bytes, (cudaStream_t)stream>>>(
            (const float*)x, (float*)out, taps, H, W, C, Ho, Wo, p0, th, n_ctiles);
    } else {
        blur4_tiled<1><<<grid, block, smem_bytes, (cudaStream_t)stream>>>(
            (const float*)x, (float*)out, taps, H, W, C, Ho, Wo, p0, th, n_ctiles);
    }
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

const char* blur4_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
