// The StyledConv epilogue's backward: dx = g * (out >= 0 ? 1 : 0.2) * sqrt(2)
// over two float32 tensors of the same shape, the mask taken from the saved
// epilogue output.
//
// Replaces the TPU kernel content_aware_gan_compression_tpu/ops/pallas/
// fused_act_pallas.py:_masked_scale -> _run_bwd / _bwd_kernel. The TPU version
// tiles [B, H, W, C] by row blocks of one sample; the op is elementwise, so
// here the tensors are one flat array and the shape does not matter.
//
// Bound on an H100: memory. One compare and two multiplies per element against
// 12 bytes (g and out read, dx written), so the least time is 12 * n bytes over
// the memory rate. Each thread moves one float4 of each tensor over the
// aligned body of the flat array, whatever C is: the student generator's
// widths (154, 77, 39) are not multiples of 4, so a float4 along C alone would
// never run on the training path. The last n % 4 elements take one scalar
// thread each. Index math is 32-bit while the element count fits in an int.
// The arithmetic uses round-to-nearest intrinsics in the plain PyTorch
// expression's order, so the result equals the plain version bit for bit.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float masked(float g, float o) {
    const float v = o >= 0.f ? g : __fmul_rn(g, 0.2f);
    return __fmul_rn(v, 1.41421356237309515f);
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

// g, out, dx: n contiguous floats each on `device`. vec4 != 0 selects the
// float4 body (g, out and dx 16-byte aligned, checked by the caller);
// otherwise every element takes the scalar path. Launches on `device` and
// gives the calling thread its current device back. Returns
// cudaGetLastError() after the launch.
int masked_scale_forward(const void* g, const void* out, void* dx, long long n,
                         int vec4, int device, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long n4 = vec4 ? n / 4 : 0;
    const long long tail = n - 4 * n4;
    const long long threads_total = n4 + tail;
    const int threads = 256;
    const unsigned int blocks =
        (unsigned int)((threads_total + threads - 1) / threads);
    if (n < (1LL << 31) - threads) {
        masked_scale_kernel<int><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)g, (const float*)out, (float*)dx, (int)n4, (int)tail);
    } else {
        masked_scale_kernel<long long>
            <<<blocks, threads, 0, (cudaStream_t)stream>>>(
                (const float*)g, (const float*)out, (float*)dx, n4, tail);
    }
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

const char* masked_scale_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
