// Per-pixel K*K local kernel application, forward:
//
//   y[b,h,w,c] = sum_{t < K*K} W[b,h,w,t] * x[b, h+dx-p, w+dy-p, c]
//   (t = dx*K + dy, p = K/2, zero outside the frame)
//
// Replaces the TPU kernel pivp_tpu/ops/pallas/local_apply.py:_fwd_call
// (its pallas_call at :120, whole frame, and :136, H-tiled with a DMA'd
// halo), reached through local_kernel_apply (:425-448). In the CDNA
// predictor it applies the per-pixel kernel that the fused CDNA
// composite collapses the masked mixture into, once per timestep.
//
// What bounds it on an H100: bytes. Each output pixel reads its K*K
// weights (contiguous in NHWC) and C values of each of its K*K
// neighbours and writes C values: 2*K*K*C flops against (K*K + 2C)
// words of compulsory traffic, far below the card's ~20 flop/byte ridge
// in float32. At the CDNA shape x (32,64,64,3), w (32,64,64,25) the
// compulsory traffic is 16.3 MB, 4.9 us at 3.35 TB/s.
//
// Design: one thread per output pixel (b,h,w), nothing staged in shared
// memory. The zero padding is a bounds test on the neighbour, so there
// is no padded copy of x and no transpose (the TPU kernel pads and
// moves to channel-planar layout first). The weights are read once per
// pixel and the neighbours' channels go through L1, which holds the
// overlap between neighbouring threads. Accumulation is in float32;
// the output is stored in x's type (float32 or bfloat16). Any frame
// size and any odd K. Channels go in chunks of 4 so the accumulators
// stay in registers for any C.
#include "common.cuh"

namespace {

constexpr int kChunk = 4;

template <typename T>
__global__ void local_apply_fwd_kernel(const T* __restrict__ x,
                                       const T* __restrict__ w,
                                       T* __restrict__ y, int B, int H,
                                       int W, int C, int K) {
  const int64_t n = int64_t(B) * H * W;
  const int KK = K * K;
  const int pad = K / 2;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t p = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const int wi = int(p % W);
    const int hi = int((p / W) % H);
    const int64_t bi = p / (int64_t(W) * H);
    const T* wp = w + p * KK;
    const T* xb = x + bi * H * W * C;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
      for (int dx = 0; dx < K; ++dx) {
        const int hh = hi + dx - pad;
        if (hh < 0 || hh >= H) continue;
        for (int dy = 0; dy < K; ++dy) {
          const int ww = wi + dy - pad;
          if (ww < 0 || ww >= W) continue;
          const float wt = pivp::to_f32(wp[dx * K + dy]);
          const T* xp = xb + (int64_t(hh) * W + ww) * C + c0;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (c0 + j < C) acc[j] += wt * pivp::to_f32(xp[j]);
          }
        }
      }
      T* yp = y + p * C + c0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < C) yp[j] = pivp::from_f32<T>(acc[j]);
      }
    }
  }
}

}  // namespace

// x (B,H,W,C), w (B,H,W,K*K), y (B,H,W,C): contiguous, all of one type,
// float32 (bf16 == 0) or bfloat16 (bf16 != 0). Launches on `stream` of
// `device` and returns the cudaError_t of the launch.
extern "C" int pivp_local_apply_fwd(const void* x, const void* w, void* y,
                                    int B, int H, int W, int C, int K,
                                    int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int64_t n = int64_t(B) * H * W;
  if (n == 0 || C == 0) return int(cudaGetLastError());
  const unsigned int blocks = pivp::grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    local_apply_fwd_kernel<__nv_bfloat16><<<blocks, pivp::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), B, H, W, C, K);
  } else {
    local_apply_fwd_kernel<float><<<blocks, pivp::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), B, H, W, C, K);
  }
  return int(cudaGetLastError());
}
