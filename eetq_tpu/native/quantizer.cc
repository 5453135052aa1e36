// Host-side weight quantizer + packer (C++17 + OpenMP).
//
// The counterpart of the reference's CPU preprocessing library
// (`csrc/cutlass_kernels/cutlass_preprocessors.cc:581-678` symmetric_quantize
// and `:497-534` preprocess_weights_for_mixed_gemm): quantizes HF checkpoint
// weights on the host CPU — where they arrive from safetensors as numpy
// arrays — before the int8 buffers are shipped to device memory. The
// reference needs ~700 lines of layout choreography (row permutes, subbyte
// transpose, column interleave, sign bias) because its kernel consumes an
// ldmatrix-specific layout; the matmuls here read plain row-major tiles,
// so the native library is exactly the two hot loops:
//
//  - eetq_quantize_*: per-column (or per-K-group) absmax scales + round +
//    clip, O(K*N) over every linear in the model — the reference's hot
//    loop #1 (SURVEY.md §3.1), OpenMP across output columns;
//  - eetq_pack_int4: split-half nibble packing matching
//    eetq_tpu/layout/tiling.py (low nibble = row i, high = row i + Kp/2).
//
// Numerics are BIT-IDENTICAL to the JAX quantizer (quant/quantizer.py):
// f32 absmax, scale = absmax / 2^(bits-1), q = trunc(w/s + copysign(.5, w))
// (C round() half-away-from-zero semantics, like the reference's
// `cutlass_preprocessors.cc:649`), clip to [-2^(b-1), 2^(b-1)-1].
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

inline float half_to_float(uint16_t h) {
  // IEEE fp16 -> fp32 (no F16C dependency)
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      int shift = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3FF;
      bits = sign | ((127 - 15 - shift) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

inline float bf16_to_float(uint16_t h) {
  uint32_t bits = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &bits, sizeof(f));
  return f;
}

// Templated on an element loader so f32/f16/bf16 share one loop nest.
template <typename LoadFn>
void quantize_impl(LoadFn load, int64_t experts, int64_t k, int64_t n,
                   int bits, int64_t group_size, int8_t* q_out,
                   float* scales_out) {
  const float qrange = (float)(1 << (bits - 1));  // 128 or 8
  const float qmax = qrange - 1.0f;
  const float qmin = -qrange;
  const int64_t groups = group_size > 0 ? k / group_size : 1;
  const int64_t g = group_size > 0 ? group_size : k;

  for (int64_t e = 0; e < experts; ++e) {
    const int64_t w_off = e * k * n;
    const int64_t s_off = e * groups * n;
#pragma omp parallel for schedule(static)
    for (int64_t col = 0; col < n; ++col) {
      for (int64_t gi = 0; gi < groups; ++gi) {
        float absmax = 0.0f;
        const int64_t row0 = gi * g;
        for (int64_t r = row0; r < row0 + g; ++r) {
          float v = std::fabs(load(w_off + r * n + col));
          absmax = std::max(absmax, v);
        }
        const float scale = absmax * (1.0f / qrange);
        // divide (not multiply-by-reciprocal): one rounding, bit-identical
        // to the JAX quantizer at exact .5 ties
        const float safe = scale == 0.0f ? 1.0f : scale;
        scales_out[s_off + gi * n + col] = scale;
        for (int64_t r = row0; r < row0 + g; ++r) {
          float x = load(w_off + r * n + col) / safe;
          // trunc(x + copysign(0.5, x)): C round() half-away semantics,
          // formula-identical to the JAX quantizer for bit-exactness
          float q = std::trunc(x + std::copysign(0.5f, x));
          q = std::min(std::max(q, qmin), qmax);
          q_out[w_off + r * n + col] = (int8_t)q;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// weight layouts are [experts, k, n] row-major (experts=1 for 2-D).
// scales_out: [experts, k/group_size (or 1), n] f32.

void eetq_quantize_f32(const float* w, int64_t experts, int64_t k, int64_t n,
                       int bits, int64_t group_size, int8_t* q_out,
                       float* scales_out) {
  quantize_impl([w](int64_t i) { return w[i]; }, experts, k, n, bits,
                group_size, q_out, scales_out);
}

void eetq_quantize_f16(const uint16_t* w, int64_t experts, int64_t k,
                       int64_t n, int bits, int64_t group_size, int8_t* q_out,
                       float* scales_out) {
  quantize_impl([w](int64_t i) { return half_to_float(w[i]); }, experts, k, n,
                bits, group_size, q_out, scales_out);
}

void eetq_quantize_bf16(const uint16_t* w, int64_t experts, int64_t k,
                        int64_t n, int bits, int64_t group_size, int8_t* q_out,
                        float* scales_out) {
  quantize_impl([w](int64_t i) { return bf16_to_float(w[i]); }, experts, k, n,
                bits, group_size, q_out, scales_out);
}

// Split-half int4 nibble packing (layout/tiling.py pack_weights bits=4):
// q: [kp, n] int8 values in [-8, 7], kp even; out: [kp/2, n] int8 where
// out[i, c] = (q[i, c] & 0xF) | (q[i + kp/2, c] << 4).
void eetq_pack_int4(const int8_t* q, int64_t kp, int64_t n, int8_t* out) {
  const int64_t half = kp / 2;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < half; ++i) {
    const int8_t* lo = q + i * n;
    const int8_t* hi = q + (half + i) * n;
    int8_t* dst = out + i * n;
    for (int64_t c = 0; c < n; ++c) {
      dst[c] = (int8_t)(((uint8_t)lo[c] & 0x0F) | ((uint8_t)hi[c] << 4));
    }
  }
}

// Transpose [rows, cols] -> [cols, rows] for int8 (checkpoint [out, in] ->
// kernel [in, out]), cache-tiled like the reference's subbyte_transpose
// (`cutlass_preprocessors.cc:201-335`) but without the subbyte cases.
void eetq_transpose_i8(const int8_t* src, int64_t rows, int64_t cols,
                       int8_t* dst) {
  constexpr int64_t T = 64;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t rb = 0; rb < rows; rb += T) {
    for (int64_t cb = 0; cb < cols; cb += T) {
      const int64_t rend = std::min(rb + T, rows);
      const int64_t cend = std::min(cb + T, cols);
      for (int64_t r = rb; r < rend; ++r) {
        for (int64_t c = cb; c < cend; ++c) {
          dst[c * rows + r] = src[r * cols + c];
        }
      }
    }
  }
}

int eetq_native_version() { return 1; }

}  // extern "C"
