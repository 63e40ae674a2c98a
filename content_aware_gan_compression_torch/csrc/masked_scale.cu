// The StyledConv epilogue's backward: dx = g * (out >= 0 ? 1 : 0.2) * sqrt(2)
// over two float32 or two bfloat16 tensors of the same shape, the mask taken
// from the saved epilogue output.
//
// Replaces the TPU kernel content_aware_gan_compression_tpu/ops/pallas/
// fused_act_pallas.py:_masked_scale -> _run_bwd / _bwd_kernel. The TPU version
// tiles [B, H, W, C] by row blocks of one sample; the op is elementwise, so
// here the tensors are one flat array and the shape does not matter: the
// student generator's widths (154, 77, 39, 20, 10) are not multiples of 4, so
// a float4 along C alone would never run on the training path.
//
// Bound on an H100: memory. One compare and two multiplies per element against
// 12 bytes (g and out read, dx written), so the least time is 12 * n bytes over
// the memory rate (6 * n in bfloat16). Design (csrc/lanes.cuh,
// ops/cuda/lanes.py:lane_plan): the epilogue's 16-byte lanes, each thread V
// of them with the loads of all 2V vectors issued before any arithmetic,
// block size, V and streaming stores from the plan (bench_fused_act --sweep
// chose them); the last partial lane and a misaligned view move element by
// element. Index math is 32-bit while n < 2^31. At the training shapes it
// runs level with aten.leaky_relu_backward, both at 86-93% of the bound.
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
#include "lanes.cuh"

namespace {

// float32: the slope, then the gain
__device__ __forceinline__ float masked(lanes::F32, float g, float o) {
    const float v = o >= 0.f ? g : __fmul_rn(g, 0.2f);
    return __fmul_rn(v, 1.41421356237309515f);
}

// bfloat16: the gain, then the slope
__device__ __forceinline__ float masked(lanes::BF16, float g, float o) {
    const float v = __fmul_rn(g, 1.41421356237309515f);
    return o >= 0.f ? v : __fmul_rn(v, 0.2f);
}

template <typename T, typename Index, int V>
__global__ void __launch_bounds__(lanes::kMaxThreads)
    masked_scale_kernel(const typename T::Elem* __restrict__ g,
                        const typename T::Elem* __restrict__ out,
                        typename T::Elem* __restrict__ dx, Index n, Index n_lanes, int vec,
                        int streaming) {
    constexpr int L = T::kLanes;
    const Index first = (Index)blockIdx.x * (Index)(blockDim.x * V) + threadIdx.x;
    typename T::Raw gr[V], orr[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const Index lane = first + (Index)j * blockDim.x;
        if (lane < n_lanes) {
            const Index e = lane * L;
            gr[j] = T::load(g + e, e + L <= n, (long long)(n - e), vec);
            orr[j] = T::load(out + e, e + L <= n, (long long)(n - e), vec);
        }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const Index lane = first + (Index)j * blockDim.x;
        if (lane >= n_lanes) continue;
        const Index e = lane * L;
        float r[L];
#pragma unroll
        for (int k = 0; k < L; ++k) r[k] = masked(T(), T::get(gr[j], k), T::get(orr[j], k));
        T::store(dx + e, r, e + L <= n, (long long)(n - e), vec, streaming);
    }
}

template <typename T, typename Index>
void launch_kernel(int vectors, long long blocks, int threads, cudaStream_t s, const void* g,
                   const void* out, void* dx, Index n, int vec, int streaming) {
    using E = typename T::Elem;
    const Index n_lanes = (n + T::kLanes - 1) / T::kLanes;
    const dim3 grid((unsigned)blocks);
#define MS_ARGS (const E*)g, (const E*)out, (E*)dx, n, n_lanes, vec, streaming
    if (vectors == 1) masked_scale_kernel<T, Index, 1><<<grid, threads, 0, s>>>(MS_ARGS);
    else if (vectors == 2) masked_scale_kernel<T, Index, 2><<<grid, threads, 0, s>>>(MS_ARGS);
    else masked_scale_kernel<T, Index, 4><<<grid, threads, 0, s>>>(MS_ARGS);
#undef MS_ARGS
}

template <typename T>
int forward(const void* g, const void* out, void* dx, long long n, int vec, int threads,
            int vectors, long long blocks, int wide_index, int streaming, int device,
            void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const int L = T::kLanes;
    if ((!wide_index && n > 0x7fffffffLL) ||
        blocks != ((n + L - 1) / L + (long long)threads * vectors - 1) /
                      ((long long)threads * vectors))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return lanes::launch_on(device, threads, vectors, blocks, [&] {
        if (wide_index)
            launch_kernel<T, unsigned long long>(vectors, blocks, threads, s, g, out, dx, n, vec,
                                                 streaming);
        else
            launch_kernel<T, unsigned>(vectors, blocks, threads, s, g, out, dx, (unsigned)n, vec,
                                       streaming);
    });
}

}  // namespace

extern "C" {

// g, out, dx: n contiguous floats (masked_scale_forward) or bfloat16 values
// (masked_scale_forward_bf16) each on `device`. The rest is
// ops/cuda/lanes.py:lane_plan's: vec != 0 for 16-byte loads and stores over
// the full lanes (g, out and dx 16-byte aligned, checked by the caller),
// threads per block, lanes per thread (1, 2 or 4), blocks, 64-bit offsets
// (needed from n = 2^31) and streaming stores. Launches on `device` and gives
// the calling thread its current device back. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a plan the kernel does not
// take.
int masked_scale_forward(const void* g, const void* out, void* dx, long long n, int vec,
                         int threads, int vectors, long long blocks, int wide_index,
                         int streaming, int device, void* stream) {
    return forward<lanes::F32>(g, out, dx, n, vec, threads, vectors, blocks, wide_index,
                               streaming, device, stream);
}

int masked_scale_forward_bf16(const void* g, const void* out, void* dx, long long n, int vec,
                              int threads, int vectors, long long blocks, int wide_index,
                              int streaming, int device, void* stream) {
    return forward<lanes::BF16>(g, out, dx, n, vec, threads, vectors, blocks, wide_index,
                                streaming, device, stream);
}

const char* masked_scale_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
