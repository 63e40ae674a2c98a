// StyledConv epilogue: out = lrelu(x + nw * noise + bias, 0.2) * sqrt(2) over
// an NHWC float32 or bfloat16 tensor, noise [B or 1, H, W, 1] broadcast over
// channels, bias [C], nw a 1-element device tensor, all of x's type.
//
// Replaces the TPU kernel content_aware_gan_compression_tpu/ops/pallas/
// fused_act_pallas.py:_fwd_kernel; its backward is csrc/masked_scale.cu. The
// TPU version takes nw through SMEM; here it is read on the device from the
// parameter's own pointer, so the host never synchronises to fetch it.
//
// Bound on an H100: memory. About 5 flops per element against 8 bytes (x read,
// out written; noise and bias are 1/C and 1/(B*H*W) of that), so the least
// time is 4 * (2|x| + |noise| + C) bytes over the memory rate (2 * (...) in
// bfloat16). One thread per element, four float32 channels (16 bytes) at a
// time where C % 4 == 0, eight bfloat16 ones where C % 8 == 0.
// The arithmetic uses round-to-nearest intrinsics in the order of the plain
// PyTorch expression ((x + nw*noise) + bias), so nvcc contracts nothing into
// an FMA and the result equals the plain version bit for bit.
//
// bfloat16: the inputs are widened to float32 (exact), the whole expression
// runs in float32 as above, and the output is rounded to bfloat16 once, to
// nearest even. That is the one rounding point: nw * noise, the two adds,
// the 0.2 slope and the sqrt(2) gain are float32 operations.
// ops/cuda/fused_noise_bias_lrelu.py:fused_noise_bias_lrelu_plain computes a
// bfloat16 epilogue the same way, so the two agree bit for bit in bfloat16
// too. (The JAX package computes its bfloat16 epilogue as plain expressions,
// which round after every operation.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float act(float pre) {
    const float v = pre >= 0.f ? pre : __fmul_rn(pre, 0.2f);
    return __fmul_rn(v, 1.41421356237309515f);
}

__device__ __forceinline__ float epilogue(float x, float nz, float b) {
    return act(__fadd_rn(__fadd_rn(x, nz), b));
}

// bfloat16 bits <-> float32: a bfloat16 is the high half of a float32
__device__ __forceinline__ float bf(unsigned short h) { return __uint_as_float((unsigned)h << 16); }
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__global__ void fnbl_vec4_kernel(const float4* __restrict__ x,
                                 const float* __restrict__ noise,
                                 const float4* __restrict__ bias,
                                 const float* __restrict__ nw,
                                 float4* __restrict__ out, long long n4,
                                 int C4, long long HW, long long noise_bstride) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n4) return;
    const long long pix = i / C4;
    const int c4 = (int)(i - pix * C4);
    const long long b = pix / HW;
    const float nz =
        __fmul_rn(__ldg(nw), __ldg(noise + b * noise_bstride + (pix - b * HW)));
    const float4 v = x[i];
    const float4 bb = __ldg(bias + c4);
    float4 r;
    r.x = epilogue(v.x, nz, bb.x);
    r.y = epilogue(v.y, nz, bb.y);
    r.z = epilogue(v.z, nz, bb.z);
    r.w = epilogue(v.w, nz, bb.w);
    out[i] = r;
}

__global__ void fnbl_scalar_kernel(const float* __restrict__ x,
                                   const float* __restrict__ noise,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ nw,
                                   float* __restrict__ out, long long n, int C,
                                   long long HW, long long noise_bstride) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long pix = i / C;
    const int c = (int)(i - pix * C);
    const long long b = pix / HW;
    const float nz =
        __fmul_rn(__ldg(nw), __ldg(noise + b * noise_bstride + (pix - b * HW)));
    out[i] = epilogue(x[i], nz, __ldg(bias + c));
}

// bfloat16, 8 channels (16 bytes) per thread: C % 8 == 0
__global__ void fnbl_bf16_vec8_kernel(const uint4* __restrict__ x,
                                      const unsigned short* __restrict__ noise,
                                      const uint4* __restrict__ bias,
                                      const unsigned short* __restrict__ nw,
                                      uint4* __restrict__ out, long long n8,
                                      int C8, long long HW, long long noise_bstride) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n8) return;
    const long long pix = i / C8;
    const int c8 = (int)(i - pix * C8);
    const long long b = pix / HW;
    const float nz = __fmul_rn(bf(__ldg(nw)),
                               bf(__ldg(noise + b * noise_bstride + (pix - b * HW))));
    const uint4 v = x[i];
    const uint4 bb = __ldg(bias + c8);
    const unsigned xv[4] = {v.x, v.y, v.z, v.w};
    const unsigned bv[4] = {bb.x, bb.y, bb.z, bb.w};
    unsigned r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float lo = epilogue(lo_bf16(xv[k]), nz, lo_bf16(bv[k]));
        const float hi = epilogue(hi_bf16(xv[k]), nz, hi_bf16(bv[k]));
        r[k] = bf16_bits(lo) | (bf16_bits(hi) << 16);
    }
    out[i] = make_uint4(r[0], r[1], r[2], r[3]);
}

__global__ void fnbl_bf16_scalar_kernel(const unsigned short* __restrict__ x,
                                        const unsigned short* __restrict__ noise,
                                        const unsigned short* __restrict__ bias,
                                        const unsigned short* __restrict__ nw,
                                        unsigned short* __restrict__ out, long long n,
                                        int C, long long HW, long long noise_bstride) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long pix = i / C;
    const int c = (int)(i - pix * C);
    const long long b = pix / HW;
    const float nz = __fmul_rn(bf(__ldg(nw)),
                               bf(__ldg(noise + b * noise_bstride + (pix - b * HW))));
    out[i] = (unsigned short)bf16_bits(epilogue(bf(x[i]), nz, bf(__ldg(bias + c))));
}

// The launch both entries share: the device switch, the kernel by type and
// lane width, and cudaGetLastError().
int forward(const void* x, const void* noise, const void* bias, const void* nw, void* out,
            int B, int H, int W, int C, int noise_batch, int vec, int bf16, int device,
            void* stream) {
    const long long HW = (long long)H * W;
    const long long n = (long long)B * HW * C;
    if (n <= 0) return (int)cudaSuccess;
    if (vec != 1 && (vec != (bf16 ? 8 : 4) || C % vec != 0)) return (int)cudaErrorInvalidValue;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long noise_bstride = noise_batch == 1 ? 0 : HW;
    const int threads = 256;
    const long long nv = n / vec;
    const unsigned int blocks = (unsigned int)((nv + threads - 1) / threads);
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16 && vec == 8) {
        fnbl_bf16_vec8_kernel<<<blocks, threads, 0, s>>>(
            (const uint4*)x, (const unsigned short*)noise, (const uint4*)bias,
            (const unsigned short*)nw, (uint4*)out, nv, C / 8, HW, noise_bstride);
    } else if (bf16) {
        fnbl_bf16_scalar_kernel<<<blocks, threads, 0, s>>>(
            (const unsigned short*)x, (const unsigned short*)noise,
            (const unsigned short*)bias, (const unsigned short*)nw, (unsigned short*)out, n,
            C, HW, noise_bstride);
    } else if (vec == 4) {
        fnbl_vec4_kernel<<<blocks, threads, 0, s>>>(
            (const float4*)x, (const float*)noise, (const float4*)bias, (const float*)nw,
            (float4*)out, nv, C / 4, HW, noise_bstride);
    } else {
        fnbl_scalar_kernel<<<blocks, threads, 0, s>>>(
            (const float*)x, (const float*)noise, (const float*)bias, (const float*)nw,
            (float*)out, n, C, HW, noise_bstride);
    }
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

}  // namespace

extern "C" {

// x, out: [B, H, W, C] contiguous; noise: [B, H, W, 1] (noise_batch == B) or
// [1, H, W, 1] (noise_batch == 1) contiguous; bias: [C]; nw: 1 element, all
// on the device and all float32 (fused_noise_bias_lrelu_forward) or all
// bfloat16 (fused_noise_bias_lrelu_forward_bf16). vec4 != 0 selects the
// 16-byte kernel: float32 with C % 4 == 0, bfloat16 with C % 8 == 0, and x,
// out, bias 16-byte aligned, checked by the caller. Launches on `device` and
// gives the calling thread its current device back. Returns
// cudaGetLastError() after the launch.
int fused_noise_bias_lrelu_forward(const void* x, const void* noise,
                                   const void* bias, const void* nw, void* out,
                                   int B, int H, int W, int C, int noise_batch,
                                   int vec4, int device, void* stream) {
    return forward(x, noise, bias, nw, out, B, H, W, C, noise_batch, vec4 ? 4 : 1, 0, device,
                   stream);
}

int fused_noise_bias_lrelu_forward_bf16(const void* x, const void* noise,
                                        const void* bias, const void* nw, void* out,
                                        int B, int H, int W, int C, int noise_batch,
                                        int vec4, int device, void* stream) {
    return forward(x, noise, bias, nw, out, B, H, W, C, noise_batch, vec4 ? 8 : 1, 1, device,
                   stream);
}

const char* fused_noise_bias_lrelu_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
