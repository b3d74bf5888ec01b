// Shared by sdf_ffn.cu (forward), sdf_ffn_bwd.cu (recompute backward),
// sdf_ffn_dx.cu (panel cotangent) and sdf_ffn_stream.cu (the streamed-weight
// route of all three): the packed-layout dimensions, the bf16 operand
// rounding, the dropout mask, and the tensor-core and cp.async primitives.
//
// Dropout: a counter-based hash of (member base, period t, stock n, layer l,
// unit j) only, so a mask does not depend on the block size or the launch
// shape, and the backward regenerates the forward's masks exactly. n is the
// GLOBAL stock index: a launch over a stock shard passes its span's first
// stock as `offset`, and hashes offset + its local index, so rank r draws
// exactly the masks of an unsharded launch over its span. Member
// s's base is fmix32(fmix32(seed_s ^ golden) ^ index_s), computed on the
// host (ops/sdf_ffn.py::member_bases) and read from a small [S] array: with
// S seeds, index_s = 0 and member s draws exactly the masks of a one-member
// launch with seed_s; with one seed, index_s = s. The plain PyTorch version
// (ops/sdf_ffn.py::_row_hash, _unit_bits) computes the same bits. The rule
// is the JAX kernel's (pallas_ffn._dropout_mask): keep if bits >=
// round(rate * 2^32), scale the kept value by 1 / (1 - rate), after the
// ReLU of every hidden layer.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sdf_ffn {

constexpr int kMaxLayers = 8;
constexpr int kUnsupported = -1;  // returned for shapes a kernel refuses

struct FfnDims {
  int n_hidden;          // hidden layers, >= 1
  int F;                 // features
  int P;                 // packed floats per member
  int off_kout;
  int off_bout;
  int h[kMaxLayers];     // hidden widths
  int hp[kMaxLayers];    // widths padded to a multiple of 4
  int off_w[kMaxLayers]; // offsets of W_l (l >= 1)
  int off_b[kMaxLayers]; // offsets of b_l (l >= 1)
};

struct Dropout {
  int on;                        // 0: no dropout
  const uint32_t* member_base;   // [S] per-member hash bases (device)
  uint32_t threshold;  // keep iff bits >= threshold
  float scale;         // 1 / (1 - rate), as float32
  uint32_t offset;     // global index of the launch's first stock
};

// layout: [n_hidden, F, P, off_kout, off_bout,
//          h[0..n), hp[0..n), off_w[0..n), off_b[0..n)]  (host ints)
inline int read_dims(const int* layout, FfnDims* d, int* maxw) {
  *d = FfnDims{};
  d->n_hidden = layout[0];
  d->F = layout[1];
  d->P = layout[2];
  d->off_kout = layout[3];
  d->off_bout = layout[4];
  if (d->n_hidden < 1 || d->n_hidden > kMaxLayers) return kUnsupported;
  *maxw = 0;
  for (int l = 0; l < d->n_hidden; ++l) {
    d->h[l] = layout[5 + l];
    d->hp[l] = layout[5 + d->n_hidden + l];
    d->off_w[l] = layout[5 + 2 * d->n_hidden + l];
    d->off_b[l] = layout[5 + 3 * d->n_hidden + l];
    if (d->hp[l] > *maxw) *maxw = d->hp[l];
  }
  return 0;
}

// The streamed kernels' view of the packed layout: the same ints
// (ops/sdf_ffn.py FfnLayout.as_ints) copied to device memory, so a stack of
// any depth is described (the resident kernels' FfnDims holds kMaxLayers),
// read through the read-only cache where a layer starts.
struct LayoutTable {
  const int* v;  // [n_hidden, F, P, off_kout, off_bout, h[n], hp[n],
                 //  off_w[n], off_b[n]] in device memory
  __device__ __forceinline__ int n() const { return __ldg(v); }
  __device__ __forceinline__ int F() const { return __ldg(v + 1); }
  __device__ __forceinline__ int P() const { return __ldg(v + 2); }
  __device__ __forceinline__ int off_kout() const { return __ldg(v + 3); }
  __device__ __forceinline__ int off_bout() const { return __ldg(v + 4); }
  __device__ __forceinline__ int h(int l) const { return __ldg(v + 5 + l); }
  __device__ __forceinline__ int hp(int l) const {
    return __ldg(v + 5 + n() + l);
  }
  __device__ __forceinline__ int off_w(int l) const {
    return __ldg(v + 5 + 2 * n() + l);
  }
  __device__ __forceinline__ int off_b(int l) const {
    return __ldg(v + 5 + 3 * n() + l);
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the per-(member, period, stock) base of every unit's bits, from the
// member's base
__device__ __forceinline__ uint32_t row_hash(uint32_t base, uint32_t t,
                                             uint32_t n) {
  return fmix32(fmix32(base ^ t) ^ n);
}

__device__ __forceinline__ bool keep_unit(uint32_t row, int l, int j,
                                          uint32_t threshold) {
  const uint32_t key = (uint32_t)((l << 8) | j) * 0x9E3779B9u;
  return fmix32(row ^ key) >= threshold;
}

// -- tensor cores and asynchronous copies ------------------------------------

// c += a · b: one warp's m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16, lo in the low half (the lower k)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes of which the first `bytes` are copied, the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same four 8 × 8 matrices, transposed: a lane gets elements (2·(lane %
// 4), lane / 4) and (2·(lane % 4) + 1, lane / 4) of each
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint32_t* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint32_t* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

}  // namespace sdf_ffn
