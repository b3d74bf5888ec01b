// The feature-major panel x [T, F, N] as the panel kernels read it, shared
// by sdf_ffn.cu, sdf_ffn_bwd.cu, sdf_ffn_dx.cu and cond_em.cu: float32, or
// bfloat16 (ExecutionConfig.bf16_panel, the JAX package's default on the
// kernel route: models/gan.py prepare_batch stores individual_t in bf16),
// which halves the panel's bytes.
//
// A bf16 value widens to f32 exactly (its 16 bits become the high half of
// the f32 word), so a kernel that widens a bf16 panel into the f32 shared
// tiles or registers its f32 form reads computes from there exactly what it
// computes on the f32 panel x.bfloat16().float(): every product, chain,
// dropout hash and launch plan downstream is the f32 panel's, and the
// compute dtype's rounding of x (round to nearest even) is idempotent.
//
// Each kernel is a template on the panel's element type PX (float, or
// __nv_bfloat16 for the bf16 panel): the float instance is the f32 panel's
// kernel as it was, and the bf16 instance its bf16-panel form, each with
// its own registers and so its own launch plan (the wrappers plan by the
// panel's dtype). The f32 panel keeps each kernel's own copies (cp.async
// into the stages, or __ldg into registers). The bf16 panel is read with
// ordinary loads and stored widened: 16 bytes (8 values) a load where
// every row of the slab starts 16-byte aligned (N a multiple of 8, the
// panel 16-byte aligned and the slab's first stock a multiple of 8), else 2
// bytes a load (an odd N, or a stock shard's span of 2,500 stocks, whose
// rows lie 5,000 bytes apart). Where a kernel stages through cp.async,
// these loads land before the stage is read, not while the period before
// it computes: overlapping them is later work.
//
// The panel cotangents (sdf_ffn_dx, cond_em_dx) write dx in the panel's
// dtype: accumulated in f32 and rounded once to bf16, to nearest even, as
// the JAX kernels' `.astype(dx_ref.dtype)` does.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace panel {

// a bf16 value's bits, widened exactly to f32
__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float((uint32_t)b << 16);
}

// is PX the bf16 panel's element type
template <typename PX>
constexpr bool kBf16 = sizeof(PX) == 2;

// one panel value, read through the read-only cache, as f32
__device__ __forceinline__ float ldx(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldx(const __nv_bfloat16* p) {
  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Stage `rows` rows of `cols` stocks of a bf16 panel into the f32 shared
// tile dst (rows `dst_stride` floats apart), widened: row r's stocks start
// at src + r·row_len; stocks at or past `left` are stored as 0 and never
// read. Every thread of the block takes part; the caller synchronises the
// block before the tile is read.
__device__ __forceinline__ void stage_bf16(float* dst, int dst_stride,
                                           const __nv_bfloat16* panel,
                                           size_t row_len, int rows, int cols,
                                           int left) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(panel);
  const bool vec = (cols & 7) == 0 && (row_len & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int q = cols >> 3;
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
      const int r = i / q, c = (i - r * q) << 3;
      const unsigned short* p = src + (size_t)r * row_len + c;
      float* o = dst + (size_t)r * dst_stride + c;
      if (left - c >= 8) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
        o[0] = __uint_as_float(u.x << 16);
        o[1] = __uint_as_float(u.x & 0xffff0000u);
        o[2] = __uint_as_float(u.y << 16);
        o[3] = __uint_as_float(u.y & 0xffff0000u);
        o[4] = __uint_as_float(u.z << 16);
        o[5] = __uint_as_float(u.z & 0xffff0000u);
        o[6] = __uint_as_float(u.w << 16);
        o[7] = __uint_as_float(u.w & 0xffff0000u);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = c + e < left ? widen(__ldg(p + e)) : 0.f;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    dst[(size_t)r * dst_stride + c] =
        c < left ? widen(__ldg(src + (size_t)r * row_len + c)) : 0.f;
  }
}

// one value of a panel cotangent, in the panel's dtype: f32, or rounded
// once to bf16 (to nearest even)
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace panel
