// StyledConv epilogue: out = lrelu(x + nw * noise + bias, 0.2) * sqrt(2) over
// an NHWC float32 tensor, noise [B or 1, H, W, 1] broadcast over channels,
// bias [C], nw a 1-element device tensor.
//
// Replaces the TPU kernel content_aware_gan_compression_tpu/ops/pallas/
// fused_act_pallas.py:_fwd_kernel; its backward is csrc/masked_scale.cu. The
// TPU version takes nw through SMEM; here it is read on the device from the
// parameter's own pointer, so the host never synchronises to fetch it.
//
// Bound on an H100: memory. About 5 flops per element against 8 bytes (x read,
// out written; noise and bias are 1/C and 1/(B*H*W) of that), so the least
// time is 4 * (2|x| + |noise| + C) bytes over the memory rate. One thread per
// element, four channels at a time (16-byte loads and stores) where C % 4 == 0.
// The arithmetic uses round-to-nearest intrinsics in the order of the plain
// PyTorch expression ((x + nw*noise) + bias), so nvcc contracts nothing into
// an FMA and the result equals the plain version bit for bit.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float act(float pre) {
    const float v = pre >= 0.f ? pre : __fmul_rn(pre, 0.2f);
    return __fmul_rn(v, 1.41421356237309515f);
}

__device__ __forceinline__ float epilogue(float x, float nz, float b) {
    return act(__fadd_rn(__fadd_rn(x, nz), b));
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

}  // namespace

extern "C" {

// x, out: [B, H, W, C] contiguous; noise: [B, H, W, 1] (noise_batch == B) or
// [1, H, W, 1] (noise_batch == 1) contiguous; bias: [C]; nw: 1 float, all on
// the device. vec4 != 0 selects the float4 kernel (C % 4 == 0 and x, out,
// bias 16-byte aligned, checked by the caller). Launches on `device` and
// gives the calling thread its current device back. Returns
// cudaGetLastError() after the launch.
int fused_noise_bias_lrelu_forward(const void* x, const void* noise,
                                   const void* bias, const void* nw, void* out,
                                   int B, int H, int W, int C, int noise_batch,
                                   int vec4, int device, void* stream) {
    const long long HW = (long long)H * W;
    const long long n = (long long)B * HW * C;
    if (n <= 0) return (int)cudaSuccess;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long noise_bstride = noise_batch == 1 ? 0 : HW;
    const int threads = 256;
    if (vec4) {
        const long long n4 = n / 4;
        fnbl_vec4_kernel<<<(unsigned int)((n4 + threads - 1) / threads),
                           threads, 0, (cudaStream_t)stream>>>(
            (const float4*)x, (const float*)noise, (const float4*)bias,
            (const float*)nw, (float4*)out, n4, C / 4, HW, noise_bstride);
    } else {
        fnbl_scalar_kernel<<<(unsigned int)((n + threads - 1) / threads),
                             threads, 0, (cudaStream_t)stream>>>(
            (const float*)x, (const float*)noise, (const float*)bias,
            (const float*)nw, (float*)out, n, C, HW, noise_bstride);
    }
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

const char* fused_noise_bias_lrelu_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
