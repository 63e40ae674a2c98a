// 4x4 FIR blur over an NHWC float32 tensor: upfirdn2d(x, k, up=1, down=1,
// pad=(p0, p1)) with k a 4x4 kernel (gain already folded in).
//
// Replaces the TPU kernel content_aware_gan_compression_tpu/ops/pallas/
// upfirdn2d_pallas.py:_blur4_padded, forward and backward: the backward
// (_blur4_bwd) is this kernel again with the taps flipped back and pads
// (3-p0, 3-p1), launched by ops/cuda/blur4.py:Blur4Fn. The TPU version pads
// with an XLA op and runs a valid correlation over row tiles with a halo.
// Here the pad is never materialised: each tap that falls outside the input
// reads 0 through a bounds check, so the kernel moves only the input once and
// the output once.
//
// Bound on an H100: memory. 16 taps of 2 flops per output element against
// 8 bytes per element (one read, one write) is 4 flop/byte, far below the
// card's fp32 ridge point, so the least time is 4 * (|x| + |out|) bytes over
// the memory rate. One thread per output element, C the fastest index, so a
// warp's loads of one tap are 32 neighbouring floats; the 16 taps of
// neighbouring output pixels hit the same lines in L1/L2.
#include <cuda_runtime.h>

namespace {

// Correlation taps (the FIR kernel flipped on both axes), row-major [di][dj],
// passed by value so one binary serves every kernel and gain.
struct Taps {
    float t[16];
};

__global__ void blur4_nhwc_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, Taps taps,
                                  int H, int W, int C, int Ho, int Wo, int p0,
                                  long long total) {
    long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int c = (int)(idx % C);
    long long r = idx / C;
    const int ow = (int)(r % Wo);
    r /= Wo;
    const int oh = (int)(r % Ho);
    const long long b = r / Ho;
    const float* xb = x + b * H * (long long)W * C + c;

    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 4; ++di) {
        const int ih = oh + di - p0;
        if (ih < 0 || ih >= H) continue;
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) {
            const int iw = ow + dj - p0;
            if (iw < 0 || iw >= W) continue;
            acc = fmaf(taps.t[di * 4 + dj],
                       __ldg(xb + ((long long)ih * W + iw) * C), acc);
        }
    }
    out[idx] = acc;
}

}  // namespace

extern "C" {

// x: [B, H, W, C] contiguous; out: [B, H+p0+p1-3, W+p0+p1-3, C] contiguous;
// taps16: host pointer to the 16 correlation taps; stream: a cudaStream_t of
// `device`. Launches on `device` and gives the calling thread its current
// device back. Returns cudaGetLastError() after the launch.
int blur4_forward(const void* x, void* out, const float* taps16, int B, int H,
                  int W, int C, int p0, int p1, int device, void* stream) {
    const int Ho = H + p0 + p1 - 3;
    const int Wo = W + p0 + p1 - 3;
    const long long total = (long long)B * Ho * Wo * C;
    if (total <= 0) return (int)cudaSuccess;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Taps taps;
    for (int i = 0; i < 16; ++i) taps.t[i] = taps16[i];
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    blur4_nhwc_kernel<<<(unsigned int)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, taps, H, W, C, Ho, Wo, p0, total);
    err = cudaGetLastError();
    cudaSetDevice(prev);
    return (int)err;
}

const char* blur4_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
