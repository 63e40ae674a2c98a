// The lane machinery that csrc/fused_noise_bias_lrelu.cu and
// csrc/masked_scale.cu share: both walk their tensors as one flat array of n
// elements cut into lanes of 16 bytes (4 float32 or 8 bfloat16 values), the
// cut that ops/cuda/lanes.py:lane_plan makes on the host.
//
// Lane l holds elements [l * L, min(l * L + L, n)). Block b's thread t takes
// the V lanes b * T * V + j * T + t, j = 0 .. V-1 (T threads a block), so a
// warp's j-th loads are 512 neighbouring bytes. A full lane of 16-byte aligned
// tensors moves with one 16-byte load or store; the last, partial lane, and
// every lane of a view that is not 16-byte aligned, moves element by element
// (`vec` == 0 or the lane is short). A lane waits in registers as its 16 raw
// bytes and each value is widened to float32 where it is used: exactly, for
// bfloat16. (Widened on load, a bfloat16 lane held 8 registers instead of 4,
// and the kernels with more lanes a thread lost occupancy.)
//
// `stream` != 0 stores with st.global.cs (evict-first: each byte is written
// once); loads take the read-only path. (Streaming loads were tried too and
// measured no faster at the paths' shapes.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lanes {

constexpr int kMaxThreads = 512;  // __launch_bounds__ of every lane kernel

// n / d for n < 2^31 by a multiply-high: mul and shift from the host
// (ops/cuda/lanes.py:magic_divider, PyTorch's IntDivider rule).
struct Divider {
    unsigned mul;
    unsigned shift;
};

__device__ __forceinline__ unsigned divide(unsigned n, unsigned, Divider m) {
    return (__umulhi(n, m.mul) + n) >> m.shift;
}
__device__ __forceinline__ unsigned long long divide(unsigned long long n, unsigned long long d,
                                                     Divider) {
    return n / d;
}

// A lane stays in its 16 raw bytes (`Raw`) from load to use, and `get(r, k)`
// widens value k (k a constant once the loops over a lane are unrolled); the
// stores take the lane's float32 results. The element-by-element forms, for
// the last partial lane and misaligned views, are out of line, so the full
// lanes' code stays as small as a one-vector kernel's.
struct F32 {
    using Elem = float;
    using Raw = float4;
    static constexpr int kLanes = 4;
    __device__ static float widen(float v) { return v; }
    __device__ __noinline__ static float4 load_each(const float* p, long long count) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = k < count ? __ldg(p + k) : 0.f;
        return make_float4(v[0], v[1], v[2], v[3]);
    }
    __device__ static float4 load(const float* p, bool full, long long count, bool vec) {
        return vec && full ? __ldg(reinterpret_cast<const float4*>(p)) : load_each(p, count);
    }
    __device__ static float get(const float4& r, int k) {
        return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
    }
    __device__ __noinline__ static void store_each(float* p, float4 w, long long count) {
        const float r[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (k < count) p[k] = r[k];
    }
    __device__ static void store(float* p, const float (&r)[4], bool full, long long count,
                                 bool vec, int streaming) {
        const float4 w = make_float4(r[0], r[1], r[2], r[3]);
        if (!(vec && full)) store_each(p, w, count);
        else if (streaming) __stcs(reinterpret_cast<float4*>(p), w);
        else *reinterpret_cast<float4*>(p) = w;
    }
};

// bfloat16 values travel as their bits; a bfloat16 is the high half of a
// float32, and each result is rounded once, to nearest even
struct BF16 {
    using Elem = unsigned short;
    using Raw = uint4;
    static constexpr int kLanes = 8;
    __device__ static float widen(unsigned short h) { return __uint_as_float((unsigned)h << 16); }
    __device__ __noinline__ static uint4 load_each(const unsigned short* p, long long count) {
        unsigned u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const unsigned lo = 2 * k < count ? __ldg(p + 2 * k) : 0u;
            const unsigned hi = 2 * k + 1 < count ? __ldg(p + 2 * k + 1) : 0u;
            u[k] = lo | (hi << 16);
        }
        return make_uint4(u[0], u[1], u[2], u[3]);
    }
    __device__ static uint4 load(const unsigned short* p, bool full, long long count, bool vec) {
        return vec && full ? __ldg(reinterpret_cast<const uint4*>(p)) : load_each(p, count);
    }
    __device__ static float get(const uint4& r, int k) {
        const unsigned w = k / 2 == 0 ? r.x : k / 2 == 1 ? r.y : k / 2 == 2 ? r.z : r.w;
        return __uint_as_float(k % 2 ? w & 0xffff0000u : w << 16);
    }
    __device__ static unsigned pair(float lo, float hi) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);  // .x is the low half
        return *reinterpret_cast<const unsigned*>(&b);
    }
    __device__ __noinline__ static void store_each(unsigned short* p, uint4 w, long long count) {
        const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (k < count) p[k] = (unsigned short)(k % 2 ? u[k / 2] >> 16 : u[k / 2] & 0xffffu);
    }
    __device__ static void store(unsigned short* p, const float (&r)[8], bool full,
                                 long long count, bool vec, int streaming) {
        const uint4 w = make_uint4(pair(r[0], r[1]), pair(r[2], r[3]), pair(r[4], r[5]),
                                   pair(r[6], r[7]));
        if (!(vec && full)) store_each(p, w, count);
        else if (streaming) __stcs(reinterpret_cast<uint4*>(p), w);
        else *reinterpret_cast<uint4*>(p) = w;
    }
};

// The launch both kernels share: the device switch, the plan's checks and
// cudaGetLastError() after `launch()`, which launches one instantiation.
template <typename Launch>
int launch_on(int device, int threads, int vectors, long long blocks, Launch&& launch) {
    if (blocks <= 0) return (int)cudaSuccess;
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
        (vectors != 1 && vectors != 2 && vectors != 4) || blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    launch();
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

}  // namespace lanes
