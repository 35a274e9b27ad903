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
//  * Tried for the forward and dW on the H100 and left out, as no faster
//    there: a persistent
//    grid that stages the next tile while it computes one (the loads are
//    the forward's limit, but every block's are in flight from the start
//    either way), staging by TMA bulk copies, and storing each warp's
//    results without a block barrier. PERF.md has the measurements.
//  * dX: the same tiles, with the halo on both inputs, since each pixel
//    gathers w*g from the K*K pixels whose flipped tap lands on it. A
//    block stages w (K*K wide) and g (C wide) over rows h0-p to
//    h0+rows+p-1 (and columns w0-p to w0+cols+p-1 for a column strip),
//    computes into a shared dX tile and stores that as one span. A tile
//    of `rows` rows reads (rows+2p)/rows times w's 13.1 MB from L2, so
//    its plan (ops/kernels/local_apply.py:tile_plan_bwd_x) takes taller
//    tiles than the forward's: at the main shape 8 rows of 64 pixels, 256
//    blocks of 256 threads with 92,640 bytes of shared memory, two per SM,
//    all resident at once. A thread takes two rows of a column and reads
//    each neighbour's g once for both; it reads the neighbours' weights
//    at stride K*K and their g at stride C, both odd. A full-width tile's
//    staged rows of w, and of g, are one span each, which one thread
//    hands to the TMA as a bulk copy where both ends are 16-byte aligned:
//    on the H100 that staged them faster than the threads' cp.async
//    copies, warm and cold. What bounds dX there: the staging, near the
//    rate of a device copy with a cold L2, and then the compute, bound by
//    its shared-memory reads (25 weights and 45 g values a pixel), which
//    overlaps the staging only across an SM's two blocks: the second
//    issues its copies a moment after the first.
//  * Tried for dX on the H100 and left out, as no faster there: bands of
//    a tile computed as their rows land (a cp.async group or a barrier
//    for each, all issued at once or two or three ahead), one or four
//    rows a thread, staging only the taps that each halo row feeds (4-byte
//    copies), an L2 prefetch of the spans, staging half of w by the TMA
//    and half by cp.async, and storing dX straight from registers.
#include "common.cuh"

namespace {

constexpr int kChunk = 4;
// Largest thread block of the tiled kernels (rows * cols); the wrapper's
// plan keeps to it.
constexpr int kTileThreads = 256;
// dX's blocks: at most kBwdXThreads threads, a thread a pixel; on the
// main path (K = 5, C = 3) at most kBwdXMainThreads, a thread for
// kBwdXPerThread rows of a column, reading each neighbour's g once for
// all of them. The wrapper's plan keeps to them.
constexpr int kBwdXThreads = 1024;
constexpr int kBwdXMainThreads = 256;
constexpr int kBwdXPerThread = 2;

__host__ __device__ inline int64_t align16(int64_t n) {
  return (n + 15) & ~int64_t(15);
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// An input staged with a halo of p rows and columns (`width`-wide
// pixels, `item`-byte elements): the tile's rows and p more above and
// below, `stride` elements a staged row. Pixel (r, j), staged row r and
// column j in [-p, cols + p), is `lead` + r * stride + j * width elements
// from the region's start, so `lead` (p pixels, rounded up to 16 bytes)
// leaves room for the first row's left halo and the region ends p pixels
// after the last row; `bytes` is the region rounded up to 16. For a
// full-width tile the stride is W * width: the staged rows are one
// contiguous span of the input and a row's halo columns are the ends of
// its neighbours (masked in the compute); for a column strip it is
// (cols + 2p) * width.
struct Halo {
  int lead, stride;
  int64_t bytes;
  __host__ __device__ Halo(int rows, int cols, int W, int width, int p,
                           int item) {
    stride = (cols == W ? cols : cols + 2 * p) * width;
    lead = round_up(p * width, 16 / item);
    bytes = align16((lead + int64_t(rows + 2 * p) * stride + p * width) *
                    item);
  }
};

// Shared-memory layout of a forward or dW block (ops/kernels/
// local_apply.py tile_smem_bytes mirrors it): the input tile (forward:
// w, K*K wide; dW: g, C wide) at 0, the x rows with their halo (Halo),
// and the output tile (forward: y, C wide; dW: K*K wide), each 16-byte
// aligned and each rounded up to 16 bytes, so that both passes take the
// same bytes. x0 is x's pixel (0, 0).
struct TileLayout {
  int64_t x0, out, bytes;
  int xw;
  __host__ __device__ TileLayout(int rows, int cols, int W, int C, int K,
                                 int item, bool backward) {
    const Halo hx(rows, cols, W, C, K / 2, item);
    const int64_t px = int64_t(rows) * cols;
    const int64_t wide = align16(px * K * K * item);
    const int64_t narrow = align16(px * C * item);
    const int64_t x = backward ? narrow : wide;
    xw = hx.stride;
    x0 = x + int64_t(hx.lead) * item;
    out = x + hx.bytes;
    bytes = out + (backward ? wide : narrow);
  }
};

// Shared-memory layout of a dX block (ops/kernels/local_apply.py
// bwd_x_smem_bytes mirrors it): w with its halo at 0, g with its halo,
// then the dX tile (C wide), each rounded up to 16 bytes; w0 and g0 are
// their pixels (0, 0).
struct BwdXLayout {
  Halo w, g;
  int64_t w0, g0, out, bytes;
  __host__ __device__ BwdXLayout(int rows, int cols, int W, int C, int K,
                                 int item)
      : w(rows, cols, W, K * K, K / 2, item),
        g(rows, cols, W, C, K / 2, item) {
    w0 = int64_t(w.lead) * item;
    g0 = w.bytes + int64_t(g.lead) * item;
    out = w.bytes + g.bytes;
    bytes = out + align16(int64_t(rows) * cols * C * item);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
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
// cols threads wide.
struct Tile {
  int b, h0, w0, rv, wv, rows, cols, tid, nthreads;
  __device__ Tile(int H, int W, int tile_rows) {
    cols = blockDim.x;
    rows = tile_rows;
    w0 = blockIdx.x * cols;
    h0 = blockIdx.y * rows;
    b = blockIdx.z;
    wv = min(cols, W - w0);
    rv = min(rows, H - h0);
    tid = threadIdx.y * cols + threadIdx.x;
    nthreads = blockDim.y * cols;
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

// Stages the frame's part of the input's rows [h0-p, h0+rv+p) x columns
// [w0-p, w0+cols+p) (`width`-wide pixels) with its pixel (0, 0) at s0 and
// `stride` elements a staged row (Halo); the rest is left as it is and
// masked in the compute. A full-width tile's rows are one span.
template <typename T>
__device__ void stage_halo(T* s0, const T* src, const Tile& t, int H, int W,
                           int width, int p, int stride) {
  const int r_lo = max(p - t.h0, 0);             // staged rows in the frame
  const int r_hi = min(t.rv + 2 * p, H - t.h0 + p);
  if (t.cols == W) {
    stage(s0 + r_lo * stride, src + t.at(H, W, t.h0 - p + r_lo, 0, width),
          (r_hi - r_lo) * stride, t.tid, t.nthreads);
    return;
  }
  const int c_lo = max(t.w0 - p, 0), c_hi = min(t.w0 + t.cols + p, W);
  for (int r = r_lo; r < r_hi; ++r) {
    stage(s0 + r * stride + (c_lo - t.w0) * width,
          src + t.at(H, W, t.h0 - p + r, c_lo, width),
          (c_hi - c_lo) * width, t.tid, t.nthreads);
  }
}

enum Pass { kForward, kWeights };

// The forward (y from x and w) and dW (from x and g) on one tile of
// rows x cols pixels a block. KT, CT: K and C fixed at compile time (the
// main path's 5 and 3), or 0 for sizes given at run time.
template <Pass kPass, typename T, int KT, int CT>
__device__ __forceinline__ void tiled_pass(const T* __restrict__ x,
                                           const T* __restrict__ a,
                                           T* __restrict__ out, int H, int W,
                                           int c, int k) {
  constexpr bool kBackward = kPass == kWeights;
  const int K = KT > 0 ? KT : k, C = CT > 0 ? CT : c;
  const int KK = K * K, p = K / 2;
  const Tile t(H, W, blockDim.y);
  const TileLayout lay(t.rows, t.cols, W, C, K, sizeof(T), kBackward);
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* xs = reinterpret_cast<T*>(smem + lay.x0);
  T* os = reinterpret_cast<T*>(smem + lay.out);

  move_rows<false>(const_cast<T*>(a), as, t, H, W, kBackward ? C : KK);
  stage_halo(xs, x, t, H, W, C, p, lay.xw);
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

// One kernel name for each pass, so that a profile tells them apart.
template <typename T, int KT, int CT>
__global__ void __launch_bounds__(kTileThreads)
    local_apply_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           T* __restrict__ y, int H, int W, int c, int k,
                           int) {
  tiled_pass<kForward, T, KT, CT>(x, w, y, H, W, c, k);
}

template <typename T, int KT, int CT>
__global__ void __launch_bounds__(kTileThreads)
    local_apply_bwd_w_kernel(const T* __restrict__ x,
                             const T* __restrict__ g, T* __restrict__ dw,
                             int H, int W, int c, int k, int) {
  tiled_pass<kWeights, T, KT, CT>(x, g, dw, H, W, c, k);
}

// A shared-memory barrier that completes its phase 0 once one thread has
// arrived and the bytes it announced have landed.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void barrier_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  } while (!done);
}

// A bulk copy by the Tensor Memory Accelerator of `bytes` (a multiple of
// 16, both ends 16-byte aligned) from global `src` to shared `dst`,
// counted against `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// dX on one tile of `rows` x cols pixels a block (KT, CT as above). Each
// thread sums, for P rows of its column, w*g over the K*K pixels whose
// flipped tap lands on each: it walks the P + 2p staged rows those taps
// come from and reads each neighbour's g once for all P of its pixels.
//
// On the main path a block has 256 threads and an SM holds two, so each
// thread may have up to 128 registers: bounding it so made it faster on
// the H100 than the 64 that a 1024-thread bound leaves.
template <typename T, int KT, int CT, int P>
__global__ void __launch_bounds__(KT > 0 ? kBwdXMainThreads : kBwdXThreads,
                                  KT > 0 ? 2 : 1)
    local_apply_bwd_x_kernel(const T* __restrict__ w,
                             const T* __restrict__ g, T* __restrict__ dx,
                             int H, int W, int c, int k, int rows) {
  const int K = KT > 0 ? KT : k, C = CT > 0 ? CT : c;
  const int KK = K * K, p = K / 2;
  const Tile t(H, W, rows);
  const BwdXLayout lay(t.rows, t.cols, W, C, K, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem + lay.w0);
  T* gs = reinterpret_cast<T*>(smem + lay.g0);
  T* os = reinterpret_cast<T*>(smem + lay.out);

  // A full-width tile's staged rows of w, and of g, are one span each:
  // where both ends are 16-byte aligned, one thread hands them to the
  // TMA as two bulk copies, counted on a barrier. Otherwise the threads
  // stage them (cp.async, or plain loads for bfloat16). The barrier is in
  // static shared memory: at the end of the dynamic layout it made the
  // kernel slower on the H100.
  __shared__ alignas(8) uint64_t landed;
  const bool bulk = t.cols == W && aligned16(w, g) &&
                    (int64_t(W) * KK * sizeof(T)) % 16 == 0 &&
                    (int64_t(W) * C * sizeof(T)) % 16 == 0;
  if (bulk) {
    if (t.tid == 0) {
      barrier_init(&landed);
      barrier_fence_init();
      // Blocks past the first one on each SM issue their copies a moment
      // later, so that the memory serves an SM's first block first and
      // that block computes while the next one's bytes land, which made
      // the kernel faster with a cold L2 on the H100.
      unsigned sms;
      asm volatile("mov.u32 %0, %%nsmid;\n" : "=r"(sms));
      if ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x >=
          sms) {
        __nanosleep(1000);
      }
      const int r_lo = max(p - t.h0, 0);          // staged rows in the frame
      const int r_hi = min(t.rv + 2 * p, H - t.h0 + p);
      const int h = t.h0 - p + r_lo;
      const unsigned wb = (r_hi - r_lo) * lay.w.stride * sizeof(T);
      const unsigned gb = (r_hi - r_lo) * lay.g.stride * sizeof(T);
      barrier_expect(&landed, wb + gb);
      bulk_copy(ws + r_lo * lay.w.stride, w + t.at(H, W, h, 0, KK), wb,
                &landed);
      bulk_copy(gs + r_lo * lay.g.stride, g + t.at(H, W, h, 0, C), gb,
                &landed);
    }
    __syncthreads();                         // the barrier is initialised
    barrier_wait(&landed);
  } else {
    stage_halo(ws, w, t, H, W, KK, p, lay.w.stride);
    stage_halo(gs, g, t, H, W, C, p, lay.g.stride);
    cp_async_wait_all();
  }
  __syncthreads();

  const int lc = threadIdx.x, lr0 = threadIdx.y * P;
  if (lc < t.wv && lr0 < t.rv) {
    // Pixel i of the thread (row lr0 + i) takes tap (tx, ty) from staged
    // row lr0 + j, j = i + 2p - tx, and column lc + p - ty; from outside
    // the frame it takes nothing.
    bool row_in[KT > 0 ? P + KT - 1 : P + 14], col_in[KT > 0 ? KT : 15];
    for (int j = 0; j < P + 2 * p; ++j) {
      const int hq = t.h0 - p + lr0 + j;
      row_in[j] = hq >= 0 && hq < H;
    }
    for (int ty = 0; ty < K; ++ty) {
      const int wq = t.w0 + lc + p - ty;
      col_in[ty] = wq >= 0 && wq < W;
    }
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      float acc[P][kChunk];
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) acc[i][jj] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < P + 2 * p; ++j) {
        const T* wrow = ws + (lr0 + j) * lay.w.stride + (lc + p) * KK;
        const T* grow = gs + (lr0 + j) * lay.g.stride + (lc + p) * C + c0;
#pragma unroll
        for (int ty = 0; ty < K; ++ty) {
          if (!(row_in[j] && col_in[ty])) continue;
          float gv[kChunk];
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            gv[jj] = c0 + jj < C ? pivp::to_f32(grow[jj - ty * C]) : 0.0f;
          }
          const T* wq = wrow - ty * KK + ty;      // tap (0, ty)
#pragma unroll
          for (int tx = 0; tx < K; ++tx) {
            const int i = j + tx - 2 * p;
            if (i < 0 || i >= P) continue;
            const float wt = pivp::to_f32(wq[tx * K]);
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
              acc[P == 1 ? 0 : i][jj] += wt * gv[jj];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        T* op = os + ((lr0 + i) * t.cols + lc) * C + c0;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          if (lr0 + i < t.rv && c0 + jj < C) {
            op[jj] = pivp::from_f32<T>(acc[i][jj]);
          }
        }
      }
    }
  }
  __syncthreads();
  move_rows<true>(dx, os, t, H, W, C);
}

// How a kernel takes its tile: on the main path (K = 5, C = 3) a thread
// for `per_thread` rows of a column in a block of at most `main_threads`,
// elsewhere a thread a pixel in a block of at most `any_threads`; and
// `static_smem` bytes of static shared memory beside its layout.
struct Shape {
  int per_thread, main_threads, any_threads, static_smem;
};

// Launches `fixed` (K = 5 and C = 3 compiled as constants) or `any` (any
// other K and C) with the wrapper's plan, after checking it against the
// kernel's Shape and its own layout (`layout_bytes`): tiles of `rows` x
// cols pixels, at most the 227 KB of shared memory a block may have, K
// at most 15.
template <typename T, typename Kernel>
int launch_plan(Kernel fixed, Kernel any, Shape shape, int64_t layout_bytes,
                const void* a, const void* b, void* out, int B, int H,
                int W, int C, int K, int rows, int cols, int smem,
                cudaStream_t s) {
  const bool main_path = K == 5 && C == 3;
  const int per = main_path ? shape.per_thread : 1;
  const int max_threads = main_path ? shape.main_threads : shape.any_threads;
  if (rows < 1 || cols < 1 || rows % per != 0 ||
      int64_t(rows / per) * cols > max_threads || K > 15 ||
      smem != layout_bytes || smem + shape.static_smem > 232448 ||
      B > 65535 || (H + rows - 1) / rows > 65535) {
    return int(cudaErrorInvalidValue);
  }
  Kernel kernel = main_path ? fixed : any;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((W + cols - 1) / cols, (H + rows - 1) / rows, B);
  kernel<<<grid, dim3(cols, rows / per), smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), H, W, C, K, rows);
  return int(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* y, int B, int H, int W,
               int C, int K, int rows, int cols, int smem, cudaStream_t s) {
  const TileLayout lay(rows, cols, W, C, K, sizeof(T), false);
  return launch_plan<T>(local_apply_fwd_kernel<T, 5, 3>,
                        local_apply_fwd_kernel<T, 0, 0>,
                        Shape{1, kTileThreads, kTileThreads, 0}, lay.bytes, x, w, y, B,
                        H, W, C, K, rows, cols, smem, s);
}

template <typename T>
int launch_bwd_w(const void* x, const void* g, void* dw, int B, int H,
                 int W, int C, int K, int rows, int cols, int smem,
                 cudaStream_t s) {
  const TileLayout lay(rows, cols, W, C, K, sizeof(T), true);
  return launch_plan<T>(local_apply_bwd_w_kernel<T, 5, 3>,
                        local_apply_bwd_w_kernel<T, 0, 0>,
                        Shape{1, kTileThreads, kTileThreads, 0}, lay.bytes, x, g, dw, B,
                        H, W, C, K, rows, cols, smem, s);
}

template <typename T>
int launch_bwd_x(const void* w, const void* g, void* dx, int B, int H,
                 int W, int C, int K, int rows, int cols, int smem,
                 cudaStream_t s) {
  const BwdXLayout lay(rows, cols, W, C, K, sizeof(T));
  return launch_plan<T>(local_apply_bwd_x_kernel<T, 5, 3, kBwdXPerThread>,
                        local_apply_bwd_x_kernel<T, 0, 0, 1>,
                        Shape{kBwdXPerThread, kBwdXMainThreads,
                              kBwdXThreads, 8},
                        lay.bytes, w, g, dx, B, H, W, C, K, rows, cols, smem,
                        s);
}

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
  return bf16 ? launch_fwd<__nv_bfloat16>(x, w, y, B, H, W, C, K, rows,
                                          cols, smem, s)
              : launch_fwd<float>(x, w, y, B, H, W, C, K, rows, cols, smem,
                                  s);
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
  return bf16 ? launch_bwd_w<__nv_bfloat16>(x, g, dw, B, H, W, C, K, rows,
                                            cols, smem, s)
              : launch_bwd_w<float>(x, g, dw, B, H, W, C, K, rows, cols,
                                    smem, s);
}

// w (B,H,W,K*K), g, dx (B,H,W,C): contiguous, all of one type, float32
// (bf16 == 0) or bfloat16; the dX tile plan (rows, cols, smem) from the
// wrapper. Launches on `stream` of `device` and returns the cudaError_t
// of the launch.
extern "C" int pivp_local_apply_bwd_x(const void* w, const void* g,
                                      void* dx, int B, int H, int W, int C,
                                      int K, int rows, int cols, int smem,
                                      int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  if (int64_t(B) * H * W == 0 || C == 0) return int(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd_x<__nv_bfloat16>(w, g, dx, B, H, W, C, K, rows,
                                            cols, smem, s)
              : launch_bwd_x<float>(w, g, dx, B, H, W, C, K, rows, cols,
                                    smem, s);
}
