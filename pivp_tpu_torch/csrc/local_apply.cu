// Per-pixel K*K local kernel application, forward and backward:
//
//   y[b,h,w,c]  = sum_{t < K*K} W[b,h,w,t] * x[b, h+dx-p, w+dy-p, c]
//   dW[b,h,w,t] = sum_c g[b,h,w,c] * x[b, h+dx-p, w+dy-p, c]
//   dX[b,h,w,c] = sum_t W[b, h-dx+p, w-dy+p, t] * g[b, h-dx+p, w-dy+p, c]
//   (t = dx*K + dy, p = K/2, zero outside the frame)
//
// Replaces the TPU kernels of pivp_tpu/ops/pallas/local_apply.py:
// _fwd_call (:106; its pallas_calls at :120, whole frame, and :136,
// H-tiled with a DMA'd halo) and _bwd_call (:231; _bwd_w_whole /
// _bwd_w_tiled at :247 / :264, _bwd_x_whole / _bwd_x_tiled at :293 /
// :310), reached through local_kernel_apply (:425-448). In the CDNA
// predictor the forward applies the per-pixel kernel that the fused CDNA
// composite collapses the masked mixture into, once per timestep; the
// two backward kernels run once per timestep in training.
//
// What bounds them on an H100: bytes. Each pass does 2*K*K*C flops per
// pixel against (K*K + 2C) words of compulsory traffic, far below the
// card's ~20 flop/byte ridge in float32. At the CDNA shape x, g
// (32,64,64,3), w (32,64,64,25) each pass moves 16.3 MB: 4.85 us at
// 3.35 TB/s. In dW the 25-wide write is 13.1 of the 16.3 MB.
//
// Design: all three are gathers, so no pass needs atomics and every
// result is the same from run to run. The zero padding is a bounds test
// on the neighbour, so there is no padded copy and no transpose (the
// TPU kernels pad, move to a channel-planar layout and tile H above 128
// rows for VMEM; none of that carries over). Accumulation is in
// float32; outputs are stored in the inputs' type (float32 or
// bfloat16). Any frame size, any odd K and any C.
//  * Forward and dX: one thread per pixel (b,h,w). It reads its K*K
//    weights (forward) or one weight of each neighbour (dX) and the
//    neighbours' channels, which L1 shares between neighbouring threads.
//    Channels go in chunks of 4 so the accumulators stay in registers.
//    dX gathers w*g from the K*K pixels whose tap lands on (h,w): the
//    flipped offsets.
//  * dW: one thread per (pixel, tap), a dot over C. Neighbouring threads
//    write neighbouring taps, so the dominant dW write is coalesced; the
//    K*K threads of one pixel share its g row through L1.
//  * dW and dX do their index math in 32 bits when every index fits (it
//    is several divisions per thread, and a 64-bit division is a long
//    emulated sequence), in 64 bits otherwise.
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

// Index type I: uint32_t when every index fits (the division-heavy
// index math is several times cheaper in 32 bits), int64_t otherwise.
template <typename T, typename I>
__global__ void local_apply_bwd_w_kernel(const T* __restrict__ x,
                                         const T* __restrict__ g,
                                         T* __restrict__ dw, int B, int H,
                                         int W, int C, int K) {
  const I KK = I(K) * K;
  const int pad = K / 2;
  const I n = I(B) * H * W * KK;
  const I stride = I(gridDim.x) * blockDim.x;
  for (I idx = I(blockIdx.x) * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const I p = idx / KK;
    const int t = int(idx - p * KK);
    const I row = p / I(W);
    const int wi = int(p - row * I(W));
    const int hi = int(row % I(H));
    const I bi = row / I(H);
    const int hh = hi + t / K - pad;
    const int ww = wi + t % K - pad;
    float acc = 0.0f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
      const T* xp = x + ((bi * H + hh) * W + ww) * C;
      const T* gp = g + p * C;
      for (int ch = 0; ch < C; ++ch) {
        acc += pivp::to_f32(gp[ch]) * pivp::to_f32(xp[ch]);
      }
    }
    dw[idx] = pivp::from_f32<T>(acc);
  }
}

template <typename T, typename I>
__global__ void local_apply_bwd_x_kernel(const T* __restrict__ w,
                                         const T* __restrict__ g,
                                         T* __restrict__ dx, int B, int H,
                                         int W, int C, int K) {
  const I n = I(B) * H * W;
  const int KK = K * K;
  const int pad = K / 2;
  const I stride = I(gridDim.x) * blockDim.x;
  for (I p = I(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const I row = p / I(W);
    const int wi = int(p - row * I(W));
    const int hi = int(row % I(H));
    const I bi = row / I(H);
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
      for (int tx = 0; tx < K; ++tx) {
        const int hq = hi - tx + pad;
        if (hq < 0 || hq >= H) continue;
        for (int ty = 0; ty < K; ++ty) {
          const int wq = wi - ty + pad;
          if (wq < 0 || wq >= W) continue;
          const I q = (bi * H + hq) * W + wq;
          const float wt = pivp::to_f32(w[q * KK + tx * K + ty]);
          const T* gq = g + q * C + c0;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (c0 + j < C) acc[j] += wt * pivp::to_f32(gq[j]);
          }
        }
      }
      T* dp = dx + p * C + c0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < C) dp[j] = pivp::from_f32<T>(acc[j]);
      }
    }
  }
}

// True when every element index of a (B,H,W,max(K*K,C)) tensor, plus a
// grid stride, fits in 31 bits.
inline bool fits_32(int B, int H, int W, int C, int K) {
  const int64_t width = K * K > C ? K * K : C;
  return int64_t(B) * H * W * width < (int64_t(1) << 31);
}

// Launch kernel<T, uint32_t> or kernel<T, int64_t> for these sizes.
#define PIVP_LAUNCH_INDEXED(kernel, T, blocks, s, ...)                   \
  do {                                                                  \
    if (fits_32(B, H, W, C, K)) {                                       \
      kernel<T, uint32_t><<<blocks, pivp::kThreads, 0, s>>>(__VA_ARGS__); \
    } else {                                                            \
      kernel<T, int64_t><<<blocks, pivp::kThreads, 0, s>>>(__VA_ARGS__);  \
    }                                                                   \
  } while (0)

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

// x, g (B,H,W,C), dw (B,H,W,K*K): contiguous, all of one type, float32
// (bf16 == 0) or bfloat16. Launches on `stream` of `device` and returns
// the cudaError_t of the launch.
extern "C" int pivp_local_apply_bwd_w(const void* x, const void* g,
                                      void* dw, int B, int H, int W, int C,
                                      int K, int bf16, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int64_t n = int64_t(B) * H * W * K * K;
  if (n == 0) return int(cudaGetLastError());
  const unsigned int blocks = pivp::grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    PIVP_LAUNCH_INDEXED(local_apply_bwd_w_kernel, T, blocks, s,
                        static_cast<const T*>(x), static_cast<const T*>(g),
                        static_cast<T*>(dw), B, H, W, C, K);
  } else {
    PIVP_LAUNCH_INDEXED(local_apply_bwd_w_kernel, float, blocks, s,
                        static_cast<const float*>(x),
                        static_cast<const float*>(g),
                        static_cast<float*>(dw), B, H, W, C, K);
  }
  return int(cudaGetLastError());
}

// w (B,H,W,K*K), g, dx (B,H,W,C): contiguous, all of one type, float32
// (bf16 == 0) or bfloat16. Launches on `stream` of `device` and returns
// the cudaError_t of the launch.
extern "C" int pivp_local_apply_bwd_x(const void* w, const void* g,
                                      void* dx, int B, int H, int W, int C,
                                      int K, int bf16, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int64_t n = int64_t(B) * H * W;
  if (n == 0 || C == 0) return int(cudaGetLastError());
  const unsigned int blocks = pivp::grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    PIVP_LAUNCH_INDEXED(local_apply_bwd_x_kernel, T, blocks, s,
                        static_cast<const T*>(w), static_cast<const T*>(g),
                        static_cast<T*>(dx), B, H, W, C, K);
  } else {
    PIVP_LAUNCH_INDEXED(local_apply_bwd_x_kernel, float, blocks, s,
                        static_cast<const float*>(w),
                        static_cast<const float*>(g),
                        static_cast<float*>(dx), B, H, W, C, K);
  }
  return int(cudaGetLastError());
}
