// The StyledConv epilogue's backward: dx = g * (out >= 0 ? 1 : 0.2) * sqrt(2)
// over two float32 or two bfloat16 tensors of the same shape, the mask taken
// from the saved epilogue output.
//
// Replaces the TPU kernel content_aware_gan_compression_tpu/ops/pallas/
// fused_act_pallas.py:_masked_scale -> _run_bwd / _bwd_kernel. The TPU version
// tiles [B, H, W, C] by row blocks of one sample; the op is elementwise, so
// here the tensors are one flat array and the shape does not matter.
//
// Bound on an H100: memory. One compare and two multiplies per element against
// 12 bytes (g and out read, dx written), so the least time is 12 * n bytes over
// the memory rate (6 * n in bfloat16). Each thread moves one float4 of each
// tensor (8 bfloat16 values in bfloat16) over the
// aligned body of the flat array, whatever C is: the student generator's
// widths (154, 77, 39) are not multiples of 4, so a float4 along C alone would
// never run on the training path. The last n % 4 elements take one scalar
// thread each. Index math is 32-bit while the element count fits in an int.
// The arithmetic uses round-to-nearest intrinsics in the plain PyTorch
// expression's order, so the result equals the plain version bit for bit.
//
// bfloat16: g and out are widened to float32 (exact), the sqrt(2) gain and
// then the 0.2 slope are float32 products, and dx is rounded to bfloat16
// once, to nearest even. The sign of a bfloat16 out is the sign of its
// float32 value, so the mask is the same. The gain comes first here (last
// in float32, as the JAX kernel has it) because that is the order autograd
// of the plain epilogue, lrelu(pre) * sqrt(2), differentiates in: so the
// epilogue's backward and double backward in bfloat16 round where the plain
// version's do. ops/cuda/masked_scale.py:masked_scale_plain computes a
// bfloat16 dx in the same order, so the two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float masked(float g, float o) {
    const float v = o >= 0.f ? g : __fmul_rn(g, 0.2f);
    return __fmul_rn(v, 1.41421356237309515f);
}

// the bfloat16 order: the gain, then the slope
__device__ __forceinline__ float masked_gain_first(float g, float o) {
    const float v = __fmul_rn(g, 1.41421356237309515f);
    return o >= 0.f ? v : __fmul_rn(v, 0.2f);
}

__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned masked_pair(unsigned g, unsigned o) {
    return bf16_bits(masked_gain_first(lo_bf16(g), lo_bf16(o))) |
           (bf16_bits(masked_gain_first(hi_bf16(g), hi_bf16(o))) << 16);
}

// bfloat16: threads [0, n8) take 8 values (16 bytes) i; threads [n8, n8 +
// tail) take scalar element 8 * n8 + (i - n8).
template <typename Index>
__global__ void masked_scale_bf16_kernel(const unsigned short* __restrict__ g,
                                         const unsigned short* __restrict__ out,
                                         unsigned short* __restrict__ dx, Index n8,
                                         Index tail) {
    const Index i = (Index)blockIdx.x * (Index)blockDim.x + (Index)threadIdx.x;
    if (i < n8) {
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g) + i);
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(out) + i);
        reinterpret_cast<uint4*>(dx)[i] =
            make_uint4(masked_pair(gv.x, ov.x), masked_pair(gv.y, ov.y),
                       masked_pair(gv.z, ov.z), masked_pair(gv.w, ov.w));
    } else if (i < n8 + tail) {
        const Index e = 8 * n8 + (i - n8);
        dx[e] = (unsigned short)bf16_bits(
            masked_gain_first(lo_bf16(__ldg(g + e)), lo_bf16(__ldg(out + e))));
    }
}

// Threads [0, n4) take float4 i; threads [n4, n4 + tail) take scalar element
// 4 * n4 + (i - n4).
template <typename Index>
__global__ void masked_scale_kernel(const float* __restrict__ g,
                                    const float* __restrict__ out,
                                    float* __restrict__ dx, Index n4,
                                    Index tail) {
    const Index i = (Index)blockIdx.x * (Index)blockDim.x + (Index)threadIdx.x;
    if (i < n4) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(g) + i);
        const float4 ov = __ldg(reinterpret_cast<const float4*>(out) + i);
        float4 r;
        r.x = masked(gv.x, ov.x);
        r.y = masked(gv.y, ov.y);
        r.z = masked(gv.z, ov.z);
        r.w = masked(gv.w, ov.w);
        reinterpret_cast<float4*>(dx)[i] = r;
    } else if (i < n4 + tail) {
        const Index e = 4 * n4 + (i - n4);
        dx[e] = masked(__ldg(g + e), __ldg(out + e));
    }
}

}  // namespace

extern "C" {

// g, out, dx: n contiguous floats (masked_scale_forward) or bfloat16 values
// (masked_scale_forward_bf16) each on `device`. vec4 != 0 selects the
// 16-byte body (g, out and dx 16-byte aligned, checked by the caller);
// otherwise every element takes the scalar path. Launches on `device` and
// gives the calling thread its current device back. Returns
// cudaGetLastError() after the launch.
static int masked_scale_launch(const void* g, const void* out, void* dx, long long n,
                               int vec4, int bf16, int device, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int lanes = bf16 ? 8 : 4;
    const long long nv = vec4 ? n / lanes : 0;
    const long long tail = n - lanes * nv;
    const long long threads_total = nv + tail;
    const int threads = 256;
    const unsigned int blocks =
        (unsigned int)((threads_total + threads - 1) / threads);
    const cudaStream_t s = (cudaStream_t)stream;
    const bool small = n < (1LL << 31) - threads;
    if (bf16 && small) {
        masked_scale_bf16_kernel<int><<<blocks, threads, 0, s>>>(
            (const unsigned short*)g, (const unsigned short*)out, (unsigned short*)dx,
            (int)nv, (int)tail);
    } else if (bf16) {
        masked_scale_bf16_kernel<long long><<<blocks, threads, 0, s>>>(
            (const unsigned short*)g, (const unsigned short*)out, (unsigned short*)dx, nv,
            tail);
    } else if (small) {
        masked_scale_kernel<int><<<blocks, threads, 0, s>>>(
            (const float*)g, (const float*)out, (float*)dx, (int)nv, (int)tail);
    } else {
        masked_scale_kernel<long long><<<blocks, threads, 0, s>>>(
            (const float*)g, (const float*)out, (float*)dx, nv, tail);
    }
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

int masked_scale_forward(const void* g, const void* out, void* dx, long long n,
                         int vec4, int device, void* stream) {
    return masked_scale_launch(g, out, dx, n, vec4, 0, device, stream);
}

int masked_scale_forward_bf16(const void* g, const void* out, void* dx, long long n,
                              int vec4, int device, void* stream) {
    return masked_scale_launch(g, out, dx, n, vec4, 1, device, stream);
}

const char* masked_scale_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
