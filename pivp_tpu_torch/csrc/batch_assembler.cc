// Fused training-batch assembler: index-gather + (B,T)->(T,B) transpose
// + optional uint8 quantization in ONE pass over the gathered bytes.
//
// The port's own copy of the JAX package's native/batch_assembler.cc,
// built by g++ at first use into pivp_tpu_torch/_build/ and bound with
// ctypes by pivp_tpu_torch/data/native.py. The training loop's producer
// (training/loop.py _produce_calls, through data/assembler.py) calls it
// for every dispatch: a numpy gather, swapaxes + ascontiguousarray,
// np.stack over K and a quantization touch the payload ~4 times; this
// routine reads each gathered frame row once and writes the time-major
// payload once.
//
// Reference counterpart: concat_examples' stack+split+roll collation
// (train_model.py:51-71), done there with numpy per batch.
//
// Layouts (all C-contiguous):
//   src: (N, T, R) float32      R = H*W*C floats per frame
//   idx: (K*B,) int64           sequence index per (dispatch step, row)
//   out: (K, T, B, R) uint8 | float32
//
// Quantization matches data/assembler.py quantize_images bit for bit:
// clip(x*255+0.5, 0, 255) in f32, then C-cast (truncation == floor for
// non-negative values, same as numpy astype(uint8) after the clip).
//
// Threading: OpenMP over (k, t) (built with -fopenmp, see
// data/native.py); the output does not depend on the thread count.

#include <cstdint>
#include <cstring>

extern "C" {

void pivp_assemble_f32(const float* src, const int64_t* idx,
                       int64_t K, int64_t B, int64_t T, int64_t R,
                       float* out) {
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
    for (int64_t k = 0; k < K; ++k) {
        for (int64_t t = 0; t < T; ++t) {
            float* dst = out + ((k * T + t) * B) * R;
            for (int64_t b = 0; b < B; ++b) {
                const float* row = src + (idx[k * B + b] * T + t) * R;
                std::memcpy(dst + b * R, row,
                            static_cast<size_t>(R) * sizeof(float));
            }
        }
    }
}

void pivp_assemble_u8(const float* src, const int64_t* idx,
                      int64_t K, int64_t B, int64_t T, int64_t R,
                      uint8_t* out) {
#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
    for (int64_t k = 0; k < K; ++k) {
        for (int64_t t = 0; t < T; ++t) {
            uint8_t* dst = out + ((k * T + t) * B) * R;
            for (int64_t b = 0; b < B; ++b) {
                const float* row = src + (idx[k * B + b] * T + t) * R;
                uint8_t* o = dst + b * R;
                for (int64_t i = 0; i < R; ++i) {
                    float q = row[i] * 255.0f + 0.5f;
                    q = q < 0.0f ? 0.0f : (q > 255.0f ? 255.0f : q);
                    o[i] = static_cast<uint8_t>(q);
                }
            }
        }
    }
}

}  // extern "C"
