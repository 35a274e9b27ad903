// Fused ConvLSTM gate update, forward and backward:
//
//   (j, i, f, o) = split(gates, 4, axis=-1)        // (rows, C) each
//   new_c = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)
//   new_h = tanh(new_c) * sigmoid(o)
//
// The backward recomputes the activations from (gates, c), as the TPU
// kernel does, and with g_c, g_h the cotangents of new_c, new_h:
//
//   dct    = g_c + g_h * sigmoid(o) * (1 - tanh(new_c)^2)
//   dgates = [dct * s_i * (1 - t_j^2), dct * t_j * s_i * (1 - s_i),
//             dct * c * s_f * (1 - s_f), g_h * tanh(new_c) * s_o * (1 - s_o)]
//   dc     = dct * s_f
//
// Replaces the TPU kernels pivp_tpu/ops/pallas/lstm_gates.py:_fwd_call
// (its pallas_call at :118) and :_bwd_call (its pallas_call at :150,
// kernel body :84-100), reached through fused_lstm_gates (:177-201). The
// CDNA predictor runs each for each of its 7 ConvLSTM cells at every
// timestep.
//
// What bounds them on an H100: bytes. Per element the forward reads 4
// gate values and c and writes new_c and new_h, 7 words, for ~30 flops
// plus four exponentials: an elementwise pass with no reuse. At batch 32
// the 7 cells of one timestep move 139 MB in float32, 41.6 us at 3.35
// TB/s. The backward reads gates, c, g_c and g_h (7 words) and writes
// dgates and dc (5 words): 239 MB for the 7 cells, 71.4 us.
//
// Design: one thread per (row, channel) of the flattened (B*H*W, C)
// view. Neighbouring threads take neighbouring channels, so every read
// and write is coalesced. The math is float32 (expf / tanhf, no
// fast-math intrinsics) whatever the storage type; outputs are stored
// in the inputs' type. A null cotangent pointer reads as zero (autograd
// passes None for an output that nothing used, such as the last step's
// new_c), which saves its read instead of filling zeros. Written in CUDA
// C++ rather than Triton: the pass has no reuse and no tensor-core work,
// so neither route has an edge, and one library keeps one build.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <typename T>
__global__ void lstm_gates_fwd_kernel(const T* __restrict__ gates,
                                      const T* __restrict__ c,
                                      T* __restrict__ new_c,
                                      T* __restrict__ new_h, int64_t rows,
                                      int C, float forget_bias) {
  const int64_t n = rows * C;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    const int64_t row = idx / C;
    const int ch = int(idx - row * C);
    const T* g = gates + row * 4 * C + ch;
    const float j = pivp::to_f32(g[0]);
    const float i = pivp::to_f32(g[C]);
    const float f = pivp::to_f32(g[2 * C]);
    const float o = pivp::to_f32(g[3 * C]);
    const float cc = pivp::to_f32(c[idx]);
    const float nc = cc * sigmoid(f + forget_bias) + sigmoid(i) * tanhf(j);
    const float nh = tanhf(nc) * sigmoid(o);
    new_c[idx] = pivp::from_f32<T>(nc);
    new_h[idx] = pivp::from_f32<T>(nh);
  }
}

template <typename T>
__global__ void lstm_gates_bwd_kernel(const T* __restrict__ gates,
                                      const T* __restrict__ c,
                                      const T* __restrict__ g_c,
                                      const T* __restrict__ g_h,
                                      T* __restrict__ dgates,
                                      T* __restrict__ dc, int64_t rows,
                                      int C, float forget_bias) {
  const int64_t n = rows * C;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    const int64_t row = idx / C;
    const int ch = int(idx - row * C);
    const T* g = gates + row * 4 * C + ch;
    const float j = pivp::to_f32(g[0]);
    const float i = pivp::to_f32(g[C]);
    const float f = pivp::to_f32(g[2 * C]);
    const float o = pivp::to_f32(g[3 * C]);
    const float cc = pivp::to_f32(c[idx]);
    const float gc = g_c ? pivp::to_f32(g_c[idx]) : 0.0f;
    const float gh = g_h ? pivp::to_f32(g_h[idx]) : 0.0f;
    const float s_i = sigmoid(i);
    const float s_f = sigmoid(f + forget_bias);
    const float s_o = sigmoid(o);
    const float t_j = tanhf(j);
    const float t_c = tanhf(cc * s_f + s_i * t_j);
    const float dct = gc + gh * s_o * (1.0f - t_c * t_c);
    T* dg = dgates + row * 4 * C + ch;
    dg[0] = pivp::from_f32<T>(dct * s_i * (1.0f - t_j * t_j));
    dg[C] = pivp::from_f32<T>(dct * t_j * (s_i * (1.0f - s_i)));
    dg[2 * C] = pivp::from_f32<T>(dct * cc * (s_f * (1.0f - s_f)));
    dg[3 * C] = pivp::from_f32<T>(gh * t_c * (s_o * (1.0f - s_o)));
    dc[idx] = pivp::from_f32<T>(dct * s_f);
  }
}

}  // namespace

// gates (rows, 4C) in (j, i, f, o) block order, c / new_c / new_h
// (rows, C): contiguous, all of one type, float32 (bf16 == 0) or
// bfloat16. Launches on `stream` of `device` and returns the
// cudaError_t of the launch.
extern "C" int pivp_lstm_gates_fwd(const void* gates, const void* c,
                                   void* new_c, void* new_h, int64_t rows,
                                   int C, float forget_bias, int bf16,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int64_t n = rows * C;
  if (n == 0) return int(cudaGetLastError());
  const unsigned int blocks = pivp::grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    lstm_gates_fwd_kernel<__nv_bfloat16><<<blocks, pivp::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(gates),
        static_cast<const __nv_bfloat16*>(c),
        static_cast<__nv_bfloat16*>(new_c),
        static_cast<__nv_bfloat16*>(new_h), rows, C, forget_bias);
  } else {
    lstm_gates_fwd_kernel<float><<<blocks, pivp::kThreads, 0, s>>>(
        static_cast<const float*>(gates), static_cast<const float*>(c),
        static_cast<float*>(new_c), static_cast<float*>(new_h), rows, C,
        forget_bias);
  }
  return int(cudaGetLastError());
}

// gates / dgates (rows, 4C) in (j, i, f, o) block order, c / g_c / g_h /
// dc (rows, C): contiguous, all of one type, float32 (bf16 == 0) or
// bfloat16. g_c or g_h may be null, which reads as a zero cotangent.
// Launches on `stream` of `device` and returns the cudaError_t of the
// launch.
extern "C" int pivp_lstm_gates_bwd(const void* gates, const void* c,
                                   const void* g_c, const void* g_h,
                                   void* dgates, void* dc, int64_t rows,
                                   int C, float forget_bias, int bf16,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int64_t n = rows * C;
  if (n == 0) return int(cudaGetLastError());
  const unsigned int blocks = pivp::grid_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    lstm_gates_bwd_kernel<T><<<blocks, pivp::kThreads, 0, s>>>(
        static_cast<const T*>(gates), static_cast<const T*>(c),
        static_cast<const T*>(g_c), static_cast<const T*>(g_h),
        static_cast<T*>(dgates), static_cast<T*>(dc), rows, C, forget_bias);
  } else {
    lstm_gates_bwd_kernel<float><<<blocks, pivp::kThreads, 0, s>>>(
        static_cast<const float*>(gates), static_cast<const float*>(c),
        static_cast<const float*>(g_c), static_cast<const float*>(g_h),
        static_cast<float*>(dgates), static_cast<float*>(dc), rows, C,
        forget_bias);
  }
  return int(cudaGetLastError());
}
