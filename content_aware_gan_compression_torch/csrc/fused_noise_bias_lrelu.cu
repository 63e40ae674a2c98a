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
// bfloat16). The pruned student's widths (C = 154, 77, 39, 20, 10) are not
// multiples of a 16-byte lane, and a thread per element with two divisions
// each spends instructions, not bytes: so the lanes run over the flat tensor
// and divide once per lane.
//
// Design (csrc/lanes.cuh, ops/cuda/lanes.py:epilogue_plan): x and out are one
// flat array of 16-byte lanes whatever C is, with the last partial lane and a
// misaligned view moved element by element. Each lane divides its first
// element's index once into (pixel, channel), by a multiply-high with the
// host's magic numbers while n < 2^31 and by a 64-bit division above, and the
// pixel once more by H*W where a [1,H,W,1] noise buffer is broadcast. The
// lane's other values follow without division, on one of three paths, each
// its own instantiation: where C % L == 0 (the full-width generator's widths)
// and bias is 16-byte aligned a lane lies in one pixel and loads its bias as
// one vector; elsewhere, where C >= L, it spans at most two pixels, whose two
// noise values it loads; narrower C steps channel and pixel value by value.
// Off the aligned path bias sits in shared memory, staged once per block as
// float32 over C + L slots (slot j holds bias[j % C], so a lane reads
// channels c0 .. c0 + L - 1 without wrapping), one padding slot after every
// L: the warp's lanes start L channels apart, and the padding spreads them
// over the banks. So bias needs no alignment. Noise is read through the
// read-only path, and each thread issues the loads of all its V lanes before
// any arithmetic, holding each lane as its 16 raw bytes, and before the block
// stages its bias table (staged first, the table's round trip to L2 would
// come before every block's first load). The plan sets the path, the block
// size, V and streaming stores.
//
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
#include "lanes.cuh"

namespace {

__device__ __forceinline__ float act(float pre) {
    const float v = pre >= 0.f ? pre : __fmul_rn(pre, 0.2f);
    return __fmul_rn(v, 1.41421356237309515f);
}

__device__ __forceinline__ float epilogue(float x, float nz, float b) {
    return act(__fadd_rn(__fadd_rn(x, nz), b));
}

// shared-memory slot of bias entry j: one padding slot after every L
template <int L>
__device__ __forceinline__ int slot(int j) {
    return j + j / L;
}

// The three lane paths (ops/cuda/lanes.py:epilogue_plan picks one a launch):
// C % L == 0 with a 16-byte aligned bias, where a lane lies in one pixel and
// its bias is one 16-byte load; C >= L, where a lane spans at most two pixels
// and bias comes from the shared-memory table; C < L, value-by-value
// stepping. Each is its own instantiation, so none holds another's registers.
enum Path { kAligned = 0, kWide = 1, kNarrow = 2 };

template <typename T, typename Index, int V, int P>
__global__ void __launch_bounds__(lanes::kMaxThreads)
    fnbl_kernel(const typename T::Elem* __restrict__ x, const typename T::Elem* __restrict__ noise,
                const typename T::Elem* __restrict__ bias, const typename T::Elem* __restrict__ nw,
                typename T::Elem* __restrict__ out, Index n, Index n_lanes, int C, Index hw,
                int bcast, lanes::Divider cdiv, lanes::Divider hwdiv, int vec, int streaming) {
    constexpr int L = T::kLanes;
    extern __shared__ float sbias[];
    const Index first = (Index)blockIdx.x * (Index)(blockDim.x * V) + threadIdx.x;

    // every load of the thread's V lanes before any arithmetic: x, then the
    // noise of the pixels each lane spans (and, aligned, its bias); the bias
    // table is staged after them, so its round trip overlaps theirs
    typename T::Raw xr[V], br[P == kAligned ? V : 1];
    float nv[V][P == kNarrow ? L : 2];
    int c0[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const Index lane = first + (Index)j * blockDim.x;
        if (lane < n_lanes) {
            const Index e = lane * L;
            xr[j] = T::load(x + e, e + L <= n, (long long)(n - e), vec);
        }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const Index lane = first + (Index)j * blockDim.x;
        c0[j] = 0;
        if (lane >= n_lanes) continue;
        const Index e = lane * L;
        const Index pix = lanes::divide(e, (Index)C, cdiv);
        c0[j] = (int)(e - pix * (Index)C);
        Index q = bcast ? pix - lanes::divide(pix, hw, hwdiv) * hw : pix;
        if constexpr (P == kAligned) {
            nv[j][0] = T::widen(__ldg(noise + q));
            br[j] = T::load(bias + c0[j], true, L, true);
        } else if constexpr (P == kWide) {
            // values k < C - c0 in the first pixel, the rest in the next
            const int wrap = C - c0[j];
            Index q1 = q + 1;
            if (bcast && q1 == hw) q1 = 0;
            const float n0 = T::widen(__ldg(noise + q));
            nv[j][0] = n0;
            nv[j][1] = wrap < L && e + wrap < n ? T::widen(__ldg(noise + q1)) : n0;
        } else {
            int c = c0[j];
#pragma unroll
            for (int k = 0; k < L; ++k) {
                nv[j][k] = e + k < n ? T::widen(__ldg(noise + q)) : 0.f;
                if (++c == C) {
                    c = 0;
                    ++q;
                    if (bcast && q == hw) q = 0;
                }
            }
        }
    }
    const float w = T::widen(__ldg(nw));
    if constexpr (P != kAligned) {
        for (int j = threadIdx.x; j < C + L; j += blockDim.x)
            sbias[slot<L>(j)] = T::widen(__ldg(bias + j % C));
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const Index lane = first + (Index)j * blockDim.x;
        if (lane >= n_lanes) continue;
        const Index e = lane * L;
        float r[L];
        if constexpr (P == kAligned) {
            const float nz = __fmul_rn(w, nv[j][0]);
#pragma unroll
            for (int k = 0; k < L; ++k) r[k] = epilogue(T::get(xr[j], k), nz, T::get(br[j], k));
        } else if constexpr (P == kWide) {
            const int wrap = C - c0[j];
            const float nz0 = __fmul_rn(w, nv[j][0]), nz1 = __fmul_rn(w, nv[j][1]);
#pragma unroll
            for (int k = 0; k < L; ++k)
                r[k] = epilogue(T::get(xr[j], k), k < wrap ? nz0 : nz1,
                                sbias[slot<L>(c0[j] + k)]);
        } else {
#pragma unroll
            for (int k = 0; k < L; ++k)
                r[k] = epilogue(T::get(xr[j], k), __fmul_rn(w, nv[j][k]),
                                sbias[slot<L>(c0[j] + k)]);
        }
        T::store(out + e, r, e + L <= n, (long long)(n - e), vec, streaming);
    }
}

template <typename T, typename Index, int V>
void launch_path(int path, long long blocks, int threads, int smem, cudaStream_t s,
                 const void* x, const void* noise, const void* bias, const void* nw, void* out,
                 Index n, int C, Index hw, int bcast, lanes::Divider cdiv, lanes::Divider hwdiv,
                 int vec, int streaming) {
    using E = typename T::Elem;
    const Index n_lanes = (n + T::kLanes - 1) / T::kLanes;
    const dim3 grid((unsigned)blocks);
#define FNBL_ARGS                                                                         \
    (const E*)x, (const E*)noise, (const E*)bias, (const E*)nw, (E*)out, n, n_lanes, C, hw, \
        bcast, cdiv, hwdiv, vec, streaming
    if (path == kAligned) fnbl_kernel<T, Index, V, kAligned><<<grid, threads, 0, s>>>(FNBL_ARGS);
    else if (path == kWide) fnbl_kernel<T, Index, V, kWide><<<grid, threads, smem, s>>>(FNBL_ARGS);
    else fnbl_kernel<T, Index, V, kNarrow><<<grid, threads, smem, s>>>(FNBL_ARGS);
#undef FNBL_ARGS
}

template <typename T, typename Index>
void launch_kernel(int vectors, int path, long long blocks, int threads, int smem,
                   cudaStream_t s, const void* x, const void* noise, const void* bias,
                   const void* nw, void* out, Index n, int C, Index hw, int bcast,
                   lanes::Divider cdiv, lanes::Divider hwdiv, int vec, int streaming) {
#define PATH_ARGS path, blocks, threads, smem, s, x, noise, bias, nw, out, n, C, hw, bcast, cdiv, \
        hwdiv, vec, streaming
    if (vectors == 1) launch_path<T, Index, 1>(PATH_ARGS);
    else if (vectors == 2) launch_path<T, Index, 2>(PATH_ARGS);
    else launch_path<T, Index, 4>(PATH_ARGS);
#undef PATH_ARGS
}

template <typename T>
int forward(const void* x, const void* noise, const void* bias, const void* nw, void* out,
            long long n, int C, long long hw, int bcast, unsigned c_mul, unsigned c_shift,
            unsigned hw_mul, unsigned hw_shift, int vec, int path, int threads, int vectors,
            long long blocks, int wide_index, int smem_bytes, int streaming, int device,
            void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const int L = T::kLanes;
    const int slots = (C + L - 1) + (C + L - 1) / L + 1;
    const bool path_fits = path == kAligned ? C % L == 0 && (size_t)bias % 16 == 0
                           : path == kWide  ? C >= L && smem_bytes >= 4 * slots
                           : path == kNarrow && C < L && smem_bytes >= 4 * slots;
    if (C < 1 || hw < 1 || n % C != 0 || !path_fits || smem_bytes > 48 * 1024 ||
        (!wide_index && n > 0x7fffffffLL) ||
        blocks != ((n + L - 1) / L + (long long)threads * vectors - 1) /
                      ((long long)threads * vectors))
        return (int)cudaErrorInvalidValue;
    const lanes::Divider cdiv{c_mul, c_shift}, hwdiv{hw_mul, hw_shift};
    const cudaStream_t s = (cudaStream_t)stream;
    return lanes::launch_on(device, threads, vectors, blocks, [&] {
        if (wide_index)
            launch_kernel<T, unsigned long long>(vectors, path, blocks, threads, smem_bytes, s, x,
                                                 noise, bias, nw, out, n, C, hw, bcast, cdiv,
                                                 hwdiv, vec, streaming);
        else
            launch_kernel<T, unsigned>(vectors, path, blocks, threads, smem_bytes, s, x, noise,
                                       bias, nw, out, (unsigned)n, C, (unsigned)hw, bcast, cdiv,
                                       hwdiv, vec, streaming);
    });
}

}  // namespace

extern "C" {

// x, out: n elements of [B, H, W, C] contiguous; noise: [B, H, W, 1] or,
// with bcast != 0, [1, H, W, 1] (hw = H * W) contiguous; bias: [C]; nw: 1
// element; all on `device` and all float32 (fused_noise_bias_lrelu_forward)
// or all bfloat16 (fused_noise_bias_lrelu_forward_bf16). The rest is
// ops/cuda/lanes.py:epilogue_plan's: the magic numbers of C and hw, vec != 0
// for 16-byte loads and stores over the full lanes (x and out 16-byte
// aligned, checked by the caller), the lane path (0: C % L == 0 and bias
// 16-byte aligned, 1: C >= L, 2: C < L), threads per block, lanes per thread
// (1, 2 or 4), blocks, 64-bit offsets (needed from n = 2^31), the shared
// memory for bias and streaming stores. Launches on `device` and gives the
// calling thread its current device back. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a plan the kernel does not take.
int fused_noise_bias_lrelu_forward(const void* x, const void* noise, const void* bias,
                                   const void* nw, void* out, long long n, int C, long long hw,
                                   int bcast, unsigned c_mul, unsigned c_shift, unsigned hw_mul,
                                   unsigned hw_shift, int vec, int path, int threads,
                                   int vectors, long long blocks, int wide_index, int smem_bytes,
                                   int streaming, int device, void* stream) {
    return forward<lanes::F32>(x, noise, bias, nw, out, n, C, hw, bcast, c_mul, c_shift,
                               hw_mul, hw_shift, vec, path, threads, vectors, blocks, wide_index,
                               smem_bytes, streaming, device, stream);
}

int fused_noise_bias_lrelu_forward_bf16(const void* x, const void* noise, const void* bias,
                                        const void* nw, void* out, long long n, int C,
                                        long long hw, int bcast, unsigned c_mul,
                                        unsigned c_shift, unsigned hw_mul, unsigned hw_shift,
                                        int vec, int path, int threads, int vectors,
                                        long long blocks, int wide_index, int smem_bytes,
                                        int streaming, int device, void* stream) {
    return forward<lanes::BF16>(x, noise, bias, nw, out, n, C, hw, bcast, c_mul, c_shift,
                                hw_mul, hw_shift, vec, path, threads, vectors, blocks,
                                wide_index, smem_bytes, streaming, device, stream);
}

const char* fused_noise_bias_lrelu_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
