// 4x4 FIR blur over an NHWC float32 or bfloat16 tensor: upfirdn2d(x, k,
// up=1, down=1, pad=(p0, p1)) with k a 4x4 kernel (gain already folded in).
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
// the memory rate (2 * (|x| + |out|) in bfloat16, 8 flop/byte). To get near it the kernel has to (a) read each input
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
// - bfloat16 (template parameter T). A 16-byte vector carries 8 values
//   (VEC = 8, C % 8 == 0); else a pair, one __nv_bfloat162 of 4 bytes (VEC =
//   2, C % 2 == 0, 4-byte aligned pointers); else one value. The 11x
//   student's widths take pairs at C = 154 (77 threads span a row's
//   channels) and single values at C = 77 and 39: 2-byte loads, a quarter
//   of a 32-byte sector per thread, which neighbouring columns of the same
//   warp fill. Each value is widened to float32 as it is loaded (its bits
//   shifted into the high half, exact); the 16 taps accumulate in float32
//   in the float32 kernel's order (tap row by tap row, columns left to
//   right), each a product and a sum rounded on their own (not one FMA, as
//   in float32), and each output is rounded to bfloat16 once, to nearest
//   even, when it is stored. Those are ops/cuda/blur4.py:blur4_plain's
//   rounding points for a bfloat16 tensor (a float32 multiply, then a
//   float32 add, per tap), so the two agree bit for bit. With FMAs an
//   output whose taps nearly cancel would differ by more than a bfloat16
//   ulp of its own small value. Two instructions per tap cost issue slots
//   that the halved bytes no longer hide (PERF.md).
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Correlation taps (the FIR kernel flipped on both axes), row-major [di][dj],
// passed by value so one binary serves every kernel and gain.
struct Taps {
    float t[16];
};

// A lane: VEC channels of element type T. Raw is what one load brings in,
// Acc the float32 values the sums take; widen turns one into the other and
// store rounds an Acc back to T.
template <typename T, int VEC>
struct Lane;

template <>
struct Lane<float, 4> {
    using Raw = float4;
    using Acc = float4;
    static __device__ __forceinline__ Acc zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
    static __device__ __forceinline__ Raw zero_raw() { return zero(); }
    static __device__ __forceinline__ Raw load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ Acc widen(Raw v) { return v; }
    static __device__ __forceinline__ void store(float* p, Acc v) {
        *reinterpret_cast<float4*>(p) = v;
    }
    static __device__ __forceinline__ Acc fma(float t, Acc v, Acc a) {
        return make_float4(fmaf(t, v.x, a.x), fmaf(t, v.y, a.y), fmaf(t, v.z, a.z),
                           fmaf(t, v.w, a.w));
    }
};

template <>
struct Lane<float, 1> {
    using Raw = float;
    using Acc = float;
    static __device__ __forceinline__ Acc zero() { return 0.f; }
    static __device__ __forceinline__ Raw zero_raw() { return 0.f; }
    static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ Acc widen(Raw v) { return v; }
    static __device__ __forceinline__ void store(float* p, Acc v) { *p = v; }
    static __device__ __forceinline__ Acc fma(float t, Acc v, Acc a) { return fmaf(t, v, a); }
};

// bfloat16 bits <-> float32: a bfloat16 is the high half of a float32
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    return bf16_bits(lo) | (bf16_bits(hi) << 16);
}
// a + t * v with both roundings, in the plain version's order: the
// intrinsics keep nvcc from contracting them into an FMA
__device__ __forceinline__ float mul_add(float t, float v, float a) {
    return __fadd_rn(a, __fmul_rn(t, v));
}

struct Float8 {
    float v[8];
};

template <>
struct Lane<__nv_bfloat16, 8> {
    using Raw = uint4;
    using Acc = Float8;
    static __device__ __forceinline__ Acc zero() {
        Acc a;
#pragma unroll
        for (int k = 0; k < 8; ++k) a.v[k] = 0.f;
        return a;
    }
    static __device__ __forceinline__ Raw zero_raw() { return make_uint4(0u, 0u, 0u, 0u); }
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
    static __device__ __forceinline__ Acc widen(Raw r) {
        const unsigned w[4] = {r.x, r.y, r.z, r.w};
        Acc a;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            a.v[2 * k] = lo_bf16(w[k]);
            a.v[2 * k + 1] = hi_bf16(w[k]);
        }
        return a;
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const Acc& a) {
        *reinterpret_cast<uint4*>(p) =
            make_uint4(pack_bf16(a.v[0], a.v[1]), pack_bf16(a.v[2], a.v[3]),
                       pack_bf16(a.v[4], a.v[5]), pack_bf16(a.v[6], a.v[7]));
    }
    static __device__ __forceinline__ Acc fma(float t, const Acc& v, Acc a) {
#pragma unroll
        for (int k = 0; k < 8; ++k) a.v[k] = mul_add(t, v.v[k], a.v[k]);
        return a;
    }
};

template <>
struct Lane<__nv_bfloat16, 2> {
    using Raw = unsigned;  // one __nv_bfloat162
    using Acc = float2;
    static __device__ __forceinline__ Acc zero() { return make_float2(0.f, 0.f); }
    static __device__ __forceinline__ Raw zero_raw() { return 0u; }
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const unsigned*>(p));
    }
    static __device__ __forceinline__ Acc widen(Raw w) {
        return make_float2(lo_bf16(w), hi_bf16(w));
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, Acc a) {
        *reinterpret_cast<unsigned*>(p) = pack_bf16(a.x, a.y);
    }
    static __device__ __forceinline__ Acc fma(float t, Acc v, Acc a) {
        return make_float2(mul_add(t, v.x, a.x), mul_add(t, v.y, a.y));
    }
};

template <>
struct Lane<__nv_bfloat16, 1> {
    using Raw = unsigned short;
    using Acc = float;
    static __device__ __forceinline__ Acc zero() { return 0.f; }
    static __device__ __forceinline__ Raw zero_raw() { return 0; }
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    static __device__ __forceinline__ Acc widen(Raw w) { return lo_bf16(w); }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, Acc a) {
        *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(a);
    }
    static __device__ __forceinline__ Acc fma(float t, Acc v, Acc a) { return mul_add(t, v, a); }
};

// The 4 taps of one input row that `col` (this thread's 4 columns, as
// element offsets in the row, with `cok` whether each lies inside it) feeds.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(typename Lane<T, VEC>::Raw (&v)[4], const T* xb,
                                         int ih, int H, int row_stride, const int (&col)[4],
                                         const bool (&cok)[4]) {
    using L = Lane<T, VEC>;
    const bool rok = (unsigned)ih < (unsigned)H;  // the same for the whole block
    const T* xr = xb + (rok ? ih * row_stride : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (rok && cok[j]) ? L::load(xr + col[j]) : L::zero_raw();
}

template <typename T, int VEC>
__device__ __forceinline__ void add_row(const Taps& taps, int di,
                                        const typename Lane<T, VEC>::Acc (&v)[4],
                                        typename Lane<T, VEC>::Acc& acc) {
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) acc = Lane<T, VEC>::fma(taps.t[di * 4 + dj], v[dj], acc);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(512) blur4_tiled(const T* __restrict__ x, T* __restrict__ out,
                                                   Taps taps, int H, int W, int C, int Ho,
                                                   int Wo, int p0, int th, int n_ctiles) {
    using L = Lane<T, VEC>;
    using A = typename L::Acc;
    using R = typename L::Raw;
    const int ctile = blockIdx.x % n_ctiles;  // once per block
    const int wtile = blockIdx.x / n_ctiles;
    const int c = (ctile * blockDim.x + threadIdx.x) * VEC;
    const int ow = wtile * blockDim.y + threadIdx.y;
    if (c >= C || ow >= Wo) return;  // the ragged edge; no barrier follows
    const int oh0 = blockIdx.y * th;
    const int n_in = min(th, Ho - oh0) + 3;  // input rows this strip reads
    const int row_stride = W * C;
    const int out_row = Wo * C;
    const T* xb = x + (long long)blockIdx.z * (H * row_stride) + c;
    T* ob = out + (long long)blockIdx.z * (Ho * out_row) + oh0 * out_row + ow * C + c;

    int col[4];
    bool cok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int iw = ow - p0 + j;
        cok[j] = (unsigned)iw < (unsigned)W;
        col[j] = iw * C;
    }

    A a0 = L::zero(), a1 = L::zero(), a2 = L::zero(), a3 = L::zero();
    A cur[4];
    R nxt[4];
    int ih = oh0 - p0;
    if constexpr (std::is_same<A, R>::value) {
        // float32: the first row straight into cur. Staged through nxt, as
        // bfloat16 must be, nvcc gave the float4 kernel 73 registers, not
        // 62, and it ran 10% slower (PERF.md)
        load_row<T, VEC>(cur, xb, ih, H, row_stride, col, cok);
    } else {
        load_row<T, VEC>(nxt, xb, ih, H, row_stride, col, cok);
#pragma unroll
        for (int j = 0; j < 4; ++j) cur[j] = L::widen(nxt[j]);
    }
#pragma unroll 2
    for (int i = 0; i < n_in; ++i, ++ih) {
        if (i + 1 < n_in) load_row<T, VEC>(nxt, xb, ih + 1, H, row_stride, col, cok);
        // input row ih is tap row di of output row ih + p0 - di
        add_row<T, VEC>(taps, 3, cur, a0);
        add_row<T, VEC>(taps, 2, cur, a1);
        add_row<T, VEC>(taps, 1, cur, a2);
        add_row<T, VEC>(taps, 0, cur, a3);
        if (i >= 3) L::store(ob + (i - 3) * out_row, a0);  // output row oh0 + i - 3 is done
        a0 = a1;
        a1 = a2;
        a2 = a3;
        a3 = L::zero();
#pragma unroll
        for (int j = 0; j < 4; ++j) cur[j] = L::widen(nxt[j]);
    }
}

template <typename T, int VEC>
void launch(const void* x, void* out, const Taps& taps, int B, int H, int W, int C, int Ho,
            int Wo, int p0, int cv_tile, int tw, int th, int n_ctiles, int grid_x, int grid_y,
            int smem_bytes, cudaStream_t stream) {
    const dim3 grid(grid_x, grid_y, B), block(cv_tile, tw);
    blur4_tiled<T, VEC><<<grid, block, smem_bytes, stream>>>(
        (const T*)x, (T*)out, taps, H, W, C, Ho, Wo, p0, th, n_ctiles);
}

// The launch both entries share: checks, the device switch, the launch by
// lane width, and cudaGetLastError().
template <typename T>
int forward(const void* x, void* out, const float* taps16, int B, int H, int W, int C, int p0,
            int p1, int vec, int cv_tile, int tw, int th, int n_ctiles, int grid_x, int grid_y,
            int smem_bytes, int device, void* stream) {
    const int Ho = H + p0 + p1 - 3;
    const int Wo = W + p0 + p1 - 3;
    if (B <= 0 || Ho <= 0 || Wo <= 0 || C <= 0) return (int)cudaSuccess;
    const bool bf16 = sizeof(T) == 2;
    const bool lanes_ok = bf16 ? (vec == 1 || vec == 2 || vec == 8) : (vec == 1 || vec == 4);
    if (!lanes_ok || C % vec != 0) return (int)cudaErrorInvalidValue;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Taps taps;
    for (int i = 0; i < 16; ++i) taps.t[i] = taps16[i];
    const cudaStream_t s = (cudaStream_t)stream;
#define BLUR4_LAUNCH(V)                                                                     \
    launch<T, V>(x, out, taps, B, H, W, C, Ho, Wo, p0, cv_tile, tw, th, n_ctiles, grid_x,   \
                 grid_y, smem_bytes, s)
    if constexpr (sizeof(T) == 2) {
        if (vec == 8) BLUR4_LAUNCH(8);
        else if (vec == 2) BLUR4_LAUNCH(2);
        else BLUR4_LAUNCH(1);
    } else {
        if (vec == 4) BLUR4_LAUNCH(4);
        else BLUR4_LAUNCH(1);
    }
#undef BLUR4_LAUNCH
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

}  // namespace

extern "C" {

// x: [B, H, W, C] contiguous; out: [B, H+p0+p1-3, W+p0+p1-3, C] contiguous;
// taps16: host pointer to the 16 correlation taps. The launch plan
// (ops/cuda/blur4.py:launch_plan): vec lanes per thread (float32: 4 needs
// C % 4 == 0 and 16-byte aligned pointers, or 1; bfloat16: 8 needs C % 8 ==
// 0 and 16-byte alignment, 2 needs C % 2 == 0 and 4-byte alignment, or 1),
// blocks of (cv_tile, tw) threads, strips of th rows, n_ctiles channel
// tiles, a (grid_x, grid_y, B) grid and smem_bytes of dynamic shared memory.
// stream: a cudaStream_t of `device`. Launches on `device` and gives the
// calling thread its current device back. Returns cudaGetLastError() after
// the launch. blur4_forward takes float32 tensors, blur4_forward_bf16
// bfloat16 ones.
int blur4_forward(const void* x, void* out, const float* taps16, int B, int H, int W, int C,
                  int p0, int p1, int vec, int cv_tile, int tw, int th, int n_ctiles,
                  int grid_x, int grid_y, int smem_bytes, int device, void* stream) {
    return forward<float>(x, out, taps16, B, H, W, C, p0, p1, vec, cv_tile, tw, th, n_ctiles,
                          grid_x, grid_y, smem_bytes, device, stream);
}

int blur4_forward_bf16(const void* x, void* out, const float* taps16, int B, int H, int W,
                       int C, int p0, int p1, int vec, int cv_tile, int tw, int th,
                       int n_ctiles, int grid_x, int grid_y, int smem_bytes, int device,
                       void* stream) {
    return forward<__nv_bfloat16>(x, out, taps16, B, H, W, C, p0, p1, vec, cv_tile, tw, th,
                                  n_ctiles, grid_x, grid_y, smem_bytes, device, stream);
}

const char* blur4_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
