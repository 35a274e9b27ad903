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
// 3.35 TB/s. The K*K-wide tensor (w read by the forward, dW written by
// the backward) is 13.1 of the 16.3 MB.
//
// Design: all three are gathers, so no pass needs atomics and every
// result is the same from run to run. Accumulation is in float32;
// outputs are stored in the inputs' type (float32 or bfloat16). Any
// frame size, any odd K up to 15 and any C.
//  * Forward and dW: block tiles in shared memory. A block owns `rows`
//    rows of one sample over a strip of `cols` columns (the full width
//    when W <= 256), one thread per pixel, the block shaped (cols, rows),
//    so it finds its tile from blockIdx once and no thread divides. The
//    tile plan (rows, cols, shared bytes) comes from the wrapper
//    (ops/kernels/local_apply.py:tile_plan): at the main shape one row
//    of 64 pixels, 2,048 blocks, all resident at once. The block stages,
//    in the storage type, its pixels of the input (forward: w, K*K wide;
//    dW: g) and the x rows h0-p to h0+rows+p-1; computes into a shared
//    output tile (forward: y; dW: its K*K results); and stores that.
//  * Every move is a contiguous span where it can be: for a full-width
//    tile the staged x rows, the tile's w or g and its y or dW are one
//    span each (for a column strip, one per row). Global -> shared is
//    cp.async, 16 bytes where both ends are aligned (4 otherwise; plain
//    loads for bfloat16), all issued before one wait; shared -> global
//    goes 16 bytes at a time when aligned (for bfloat16 dW only when
//    W*K*K*2 is a multiple of 16 at the span's start; a scalar path takes
//    the rest). The x halo is not written: the staged rows are the frame's
//    rows, contiguous, so a pixel's left and right halo columns hold the
//    ends of its neighbour rows (or nothing, at the frame's top and
//    bottom), and the compute masks each tap that falls outside the
//    frame: no thread writes shared memory before the copies land.
//  * A thread reads its K*K weights (forward) or writes its K*K results
//    (dW) in shared memory at stride K*K, odd, so a warp's accesses fall
//    in distinct banks; x at stride C (3, odd). The main path's K = 5 and
//    C = 3 are compile-time constants; other sizes take a loop.
//  * Tried on the H100 and left out, as no faster there: a persistent
//    grid that stages the next tile while it computes one (the loads are
//    the forward's limit, but every block's are in flight from the start
//    either way), staging by TMA bulk copies, and storing each warp's
//    results without a block barrier. PERF.md has the measurements.
//  * dX (not yet redesigned): one thread per pixel (b,h,w). It gathers
//    w*g from the K*K pixels whose tap lands on (h,w) (the flipped
//    offsets), reading one weight of each neighbour and the neighbours'
//    channels, which L1 shares between neighbouring threads. Channels go
//    in chunks of 4 so the accumulators stay in registers. Index math in
//    32 bits when every index fits, in 64 bits otherwise.
#include "common.cuh"

namespace {

constexpr int kChunk = 4;
// Largest thread block of the tiled kernels (rows * cols); the wrapper's
// plan keeps to it.
constexpr int kTileThreads = 256;

__host__ __device__ inline int64_t align16(int64_t n) {
  return (n + 15) & ~int64_t(15);
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared-memory layout of a block (ops/kernels/local_apply.py
// tile_smem_bytes mirrors it): the input tile (forward: w, K*K wide;
// dW: g, C wide) at 0, the x tile and the output tile (forward: y, C
// wide; dW: K*K wide), each 16-byte aligned and each rounded up to 16
// bytes, so that both passes take the same bytes. x pixel (r, j), staged
// row r and column j in [-p, cols + p), is at x0 + r * xw + j * C. For a
// full-width tile xw is W * C, so the staged rows are one contiguous
// span of x and a row's halo columns are the ends of its neighbours
// (masked in the compute); for a column strip xw is (cols + 2p) * C.
// x0 is 16-byte aligned.
struct TileLayout {
  int64_t x0, out, bytes;
  int xw;
  __host__ __device__ TileLayout(int rows, int cols, int W, int C, int K,
                                 int item, bool backward) {
    const int p = K / 2, vec = 16 / item;
    xw = (cols == W ? cols : cols + 2 * p) * C;
    const int lead = round_up(p * C, vec);
    const int64_t px = int64_t(rows) * cols;
    const int64_t wide = align16(px * K * K * item);
    const int64_t narrow = align16(px * C * item);
    const int64_t x = backward ? narrow : wide;
    x0 = x + int64_t(lead) * item;
    out = x + align16((lead + int64_t(rows + 2 * p) * xw + p * C) * item);
    bytes = out + (backward ? wide : narrow);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) |
           reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// The block's threads copy n elements from global `src` into shared
// `dst`: with cp.async for 4-byte types (16 bytes at a time when both
// ends are aligned; complete after cp_async_wait_all), with plain loads
// for bfloat16. The block-strided loops here are not unrolled:
// unrolling needs their trip count, a division by the block size, and
// each thread runs only a few iterations.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int tid,
                                      int nthreads) {
  if constexpr (sizeof(T) == 4) {
    int done = 0;
    if (aligned16(dst, src)) {
      const int nv = n / 4;
#pragma unroll 1
      for (int i = tid; i < nv; i += nthreads) {
        cp_async16(dst + 4 * i, src + 4 * i);
      }
      done = 4 * nv;
    }
#pragma unroll 1
    for (int i = done + tid; i < n; i += nthreads) {
      cp_async4(dst + i, src + i);
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < n; i += nthreads) dst[i] = src[i];
  }
}

// The block's threads copy n elements from shared `src` to global `dst`,
// 16 bytes at a time when both ends are aligned.
template <typename T>
__device__ __forceinline__ void store(T* dst, const T* src, int n, int tid,
                                      int nthreads) {
  int done = 0;
  if (aligned16(dst, src)) {
    constexpr int kVec = 16 / sizeof(T);
    const int nv = n / kVec;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll 1
    for (int i = tid; i < nv; i += nthreads) d[i] = s[i];
    done = kVec * nv;
  }
#pragma unroll 1
  for (int i = done + tid; i < n; i += nthreads) dst[i] = src[i];
}

// The block's tile: sample b, rows [h0, h0 + rv), columns [w0, w0 + wv)
// of the frame (rv <= rows and wv <= cols at the edges); the block is
// shaped (cols, rows), one thread per pixel.
struct Tile {
  int b, h0, w0, rv, wv, rows, cols, tid, nthreads;
  __device__ Tile(int H, int W) {
    cols = blockDim.x;
    rows = blockDim.y;
    w0 = blockIdx.x * cols;
    h0 = blockIdx.y * rows;
    b = blockIdx.z;
    wv = min(cols, W - w0);
    rv = min(rows, H - h0);
    tid = threadIdx.y * cols + threadIdx.x;
    nthreads = rows * cols;
  }
  // The element offset of pixel (h, w) of this sample, for a tensor
  // whose pixels are `width` elements wide.
  __device__ int64_t at(int H, int W, int h, int w, int width) const {
    return ((int64_t(b) * H + h) * W + w) * width;
  }
};

// Copies `width`-wide pixels of the tile's rows between global `g` and
// the shared tile `sm` (rows of cols pixels): one span for a full-width
// tile, one per row otherwise. Staging (global -> shared) with cp.async
// or, for the output, storing (shared -> global) after a block barrier.
template <bool kStore, typename T>
__device__ void move_rows(T* g, T* sm, const Tile& t, int H, int W,
                          int width) {
  const bool full = t.cols == W;
  for (int r = 0; r < (full ? 1 : t.rv); ++r) {
    T* gr = g + t.at(H, W, t.h0 + r, t.w0, width);
    T* sr = sm + r * t.cols * width;
    const int n = (full ? t.rv * W : t.wv) * width;
    if constexpr (kStore) {
      store(gr, sr, n, t.tid, t.nthreads);
    } else {
      stage(sr, gr, n, t.tid, t.nthreads);
    }
  }
}

// Stages the frame's part of x rows [h0-p, h0+rv+p) x columns
// [w0-p, w0+cols+p) at x0 (TileLayout); the rest is left as it is and
// masked in the compute. A full-width tile's rows are one span.
template <typename T>
__device__ void stage_x(T* x0, const T* x, const Tile& t, int H, int W,
                        int C, int p, int xw) {
  const int r_lo = max(p - t.h0, 0);             // staged rows in the frame
  const int r_hi = min(t.rv + 2 * p, H - t.h0 + p);
  if (t.cols == W) {
    stage(x0 + r_lo * xw, x + t.at(H, W, t.h0 - p + r_lo, 0, C),
          (r_hi - r_lo) * xw, t.tid, t.nthreads);
    return;
  }
  const int c_lo = max(t.w0 - p, 0), c_hi = min(t.w0 + t.cols + p, W);
  for (int r = r_lo; r < r_hi; ++r) {
    stage(x0 + r * xw + (c_lo - t.w0) * C,
          x + t.at(H, W, t.h0 - p + r, c_lo, C), (c_hi - c_lo) * C, t.tid,
          t.nthreads);
  }
}

enum Pass { kForward, kWeights };

// The forward (y from x and w) and dW (from x and g) on one tile of
// rows x cols pixels a block. KT, CT: K and C fixed at compile time (the
// main path's 5 and 3), or 0 for sizes given at run time.
template <Pass kPass, typename T, int KT, int CT>
__global__ void __launch_bounds__(kTileThreads)
    local_apply_tiled_kernel(const T* __restrict__ x,
                             const T* __restrict__ a, T* __restrict__ out,
                             int H, int W, int c, int k) {
  constexpr bool kBackward = kPass == kWeights;
  const int K = KT > 0 ? KT : k, C = CT > 0 ? CT : c;
  const int KK = K * K, p = K / 2;
  const Tile t(H, W);
  const TileLayout lay(t.rows, t.cols, W, C, K, sizeof(T), kBackward);
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + lay.x0);
  T* os = reinterpret_cast<T*>(smem + lay.out);

  move_rows<false>(const_cast<T*>(a), as, t, H, W, kBackward ? C : KK);
  stage_x(xs, x, t, H, W, C, p, lay.xw);
  cp_async_wait_all();
  __syncthreads();

  const int lr = threadIdx.y, lc = threadIdx.x;
  if (lr < t.rv && lc < t.wv) {
    // Tap (dx, dy) reads frame row h0 + lr + dx - p and column
    // w0 + lc + dy - p; outside the frame it reads zero.
    bool row_in[KT > 0 ? KT : 15], col_in[KT > 0 ? KT : 15];
    for (int d = 0; d < K; ++d) {
      const int h = t.h0 + lr + d - p, w = t.w0 + lc + d - p;
      row_in[d] = h >= 0 && h < H;
      col_in[d] = w >= 0 && w < W;
    }
    const int px = lr * t.cols + lc;
    const T* xp = xs + lr * lay.xw + (lc - p) * C;   // tap (0, 0)
    if constexpr (!kBackward) {
      const T* wp = as + px * KK;
      T* yp = os + px * C;
      for (int c0 = 0; c0 < C; c0 += kChunk) {
        float acc[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
#pragma unroll
          for (int dy = 0; dy < K; ++dy) {
            const bool in = row_in[dx] && col_in[dy];
            const float wt = pivp::to_f32(wp[dx * K + dy]);
            const T* xq = xp + dx * lay.xw + dy * C + c0;
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              if (c0 + j < C) {
                acc[j] += wt * (in ? pivp::to_f32(xq[j]) : 0.0f);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (c0 + j < C) yp[c0 + j] = pivp::from_f32<T>(acc[j]);
        }
      }
    } else {
      const T* gp = as + px * C;
      T* op = os + px * KK;
      // g in registers when C <= kChunk (the main path's C = 3): the
      // stores to `os` would otherwise make the compiler load it again
      // for every tap.
      float gr[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        gr[j] = j < C ? pivp::to_f32(gp[j]) : 0.0f;
      }
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          const T* xq = xp + dx * lay.xw + dy * C;
          float acc = 0.0f;
          if (C <= kChunk) {
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              if (j < C) acc += gr[j] * pivp::to_f32(xq[j]);
            }
          } else {
            for (int ch = 0; ch < C; ++ch) {
              acc += pivp::to_f32(gp[ch]) * pivp::to_f32(xq[ch]);
            }
          }
          op[dx * K + dy] =
              pivp::from_f32<T>(row_in[dx] && col_in[dy] ? acc : 0.0f);
        }
      }
    }
  }
  __syncthreads();
  move_rows<true>(out, os, t, H, W, kBackward ? KK : C);
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

// Launches a tiled kernel with the wrapper's plan, after checking it: a
// block of rows x cols threads, at most kTileThreads; `smem` the bytes
// of TileLayout, at most the 227 KB a block may have; K at most 15.
template <Pass kPass, typename T>
int launch_tiled(const void* x, const void* a, void* out, int B, int H,
                 int W, int C, int K, int rows, int cols, int smem,
                 cudaStream_t s) {
  const TileLayout lay(rows, cols, W, C, K, sizeof(T), kPass == kWeights);
  if (rows < 1 || cols < 1 || rows * cols > kTileThreads || K > 15 ||
      smem != lay.bytes || smem > 232448 || B > 65535 ||
      (H + rows - 1) / rows > 65535) {
    return int(cudaErrorInvalidValue);
  }
  // The main path's K = 5, C = 3 compiled as constants, any other K and
  // C at run time.
  auto kernel = K == 5 && C == 3 ? local_apply_tiled_kernel<kPass, T, 5, 3>
                                 : local_apply_tiled_kernel<kPass, T, 0, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((W + cols - 1) / cols, (H + rows - 1) / rows, B);
  kernel<<<grid, dim3(cols, rows), smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<T*>(out), H, W, C, K);
  return int(cudaGetLastError());
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
// float32 (bf16 == 0) or bfloat16 (bf16 != 0); the tile plan (rows,
// cols, smem) from the wrapper. Launches on `stream` of `device`
// and returns the cudaError_t of the launch.
extern "C" int pivp_local_apply_fwd(const void* x, const void* w, void* y,
                                    int B, int H, int W, int C, int K,
                                    int rows, int cols, int smem, int bf16,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (int64_t(B) * H * W == 0 || C == 0) return int(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_tiled<kForward, __nv_bfloat16>(
                    x, w, y, B, H, W, C, K, rows, cols, smem, s)
              : launch_tiled<kForward, float>(x, w, y, B, H, W, C, K, rows,
                                              cols, smem, s);
}

// x, g (B,H,W,C), dw (B,H,W,K*K): contiguous, all of one type, float32
// (bf16 == 0) or bfloat16; the tile plan (rows, cols, smem) from the
// wrapper. Launches on `stream` of `device` and returns the
// cudaError_t of the launch.
extern "C" int pivp_local_apply_bwd_w(const void* x, const void* g,
                                      void* dw, int B, int H, int W, int C,
                                      int K, int rows, int cols, int smem,
                                      int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (int64_t(B) * H * W == 0) return int(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_tiled<kWeights, __nv_bfloat16>(
                    x, g, dw, B, H, W, C, K, rows, cols, smem, s)
              : launch_tiled<kWeights, float>(x, g, dw, B, H, W, C, K, rows,
                                              cols, smem, s);
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
