// Recompute backward of the fused SDF-FFN for Hopper (sm_90a). The panel
// cotangent, sdf_ffn_dx, is in sdf_ffn_dx.cu.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/pallas_ffn.py
// _bwd_kernel (:205, one member) and, through the explicit member axis S,
// _bwd_kernel_members (:591). Given the cotangent g [S, T, N] of the raw
// weights, it recomputes the forward tile by tile from (x, zp, weights,
// dropout member bases), keeps the ReLU and dropout masks, stores no
// activations in device memory, and emits, per member, the gradients of
// every packed parameter (dK1 [F][hp0], dW_l, db_l, dkout, dbout, in the
// forward's packed layout) and dzp [T, H1].
//
// Rounding points are the JAX kernel's (pallas_ffn._dot): with bf16 both
// operands of every product are rounded (kout·g, Wᵀ·dh_pre, dh_pre·aᵀ,
// dh1_pre·xᵀ), while the dkout and dzp contractions and the bias sums stay
// f32 on unrounded values.
//
// What bounds it on this card: about 2.6× the forward's multiply-adds, f32
// FMAs on the CUDA cores, so operations (67 TFLOP/s), not bytes.
//
// Design. The launch plan (stock tile = threads per block, shared-memory
// bytes, resident blocks per SM, blocks per member G, and where the
// gradient accumulators live) is arithmetic in ops/sdf_ffn.py::bwd_plan;
// this file recomputes it from the layout and refuses (-1) a plan that
// disagrees or that the card cannot hold resident. A block owns a fixed,
// strided set of (period, stock-tile) cells of one member; shared memory
// holds only the member's packed weights and the cell's stock-major tiles
// (x, then one activation tile per layer). Per cell:
//
// * one thread per stock recomputes the forward in registers (as
//   sdf_ffn.cu does, four output units per step so four FMA chains run
//   side by side) and stores its x and activation rows as float4s;
// * walking the layers backwards, each thread turns its row of layer l's
//   activations into dh_pre_l in place (a post-dropout activation is > 0
//   exactly where both masks keep the unit) and carries dh down in
//   registers;
// * after each layer the block forms that layer's cross-stock products.
//   A thread owns fixed 4 × 4 tiles of dW_l / dK1 and 4-wide tiles of
//   db_l, dkout and dbout: per stock it loads one float4 of each operand
//   (rounded once in bf16) for 16 FMAs. Row strides are 4·odd floats, so
//   float4 stores of a quarter-warp's own rows and the products' loads of
//   one row hit distinct banks.
//
// The accumulators: with NT > 0 (the w32 and w64 libraries, when the
// layout's tiles fit NT per thread) they stay in registers for the block's
// whole life and are written once to grad_part [S, G, P] at the end; with
// NT = 0 (every w128 layout, and deep w64 stacks) each block read-adds-
// writes its own grad_part slice per cell, which stays in L2. Every
// gradient element belongs to one thread of one block and is summed over
// the stocks in ascending order and over the cells in the block's order;
// the wrapper sums the G partials in a fixed order (torch.sum over the
// partial axis). No float atomics: two calls give bitwise-equal gradients.
// Stock lanes past N read x = 0 and g = 0, so they add nothing. The
// kernel has a float and a bf16-panel instance (panel.cuh); the latter
// reads 2 bytes a value and widens it as it loads the thread's x row,
// from which the f32 panel's arithmetic runs unchanged. Only the
// inner loops are unrolled (the outer loops over units are not), which
// keeps the build to seconds.

#include "panel.cuh"
#include "sdf_ffn_common.cuh"

#ifndef SDF_FFN_MAXW
#define SDF_FFN_MAXW 64
#endif

namespace {

using sdf_ffn::Dropout;
using sdf_ffn::FfnDims;
using sdf_ffn::kMaxLayers;
using sdf_ffn::kUnsupported;
using sdf_ffn::round_bf16;

constexpr int kMaxTile = 128;  // stocks per cell = threads per block
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kVecTiles = 4;   // 4-wide register tiles per thread (NT > 0)

// a stock-major tile's row stride for `w` columns: a multiple of 4 floats
// (16-byte rows) whose quarter is odd, so the 8 threads of a quarter-warp
// storing a float4 each to their own rows hit 8 distinct bank groups
inline int row_stride(int w) {
  const int s = (w + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}

// shared-memory offsets (floats; the packed weights at 0), strides, and the
// tiles of each product, numbered in the order the layers are reached
struct BwdSmem {
  int zp, g, x, acts[kMaxLayers], total;
  int fp, sx, sa[kMaxLayers];  // x's width (F padded to 4); row strides
  int outer_lo[kMaxLayers], outer_n[kMaxLayers], outer_total;  // dW_l, dK1
  int vec_lo[kMaxLayers], vec_total;  // db_l; dkout then dbout first
};

inline BwdSmem smem_plan(const FfnDims& d, int bn) {
  BwdSmem m{};
  const int L = d.n_hidden;
  int o = d.P;
  m.zp = o;
  o += d.hp[0];
  m.g = o;
  o += bn;
  m.fp = (d.F + 3) / 4 * 4;
  m.sx = row_stride(d.F);
  m.x = o;
  o += bn * m.sx;
  for (int l = 0; l < L; ++l) {
    m.sa[l] = row_stride(d.hp[l]);
    m.acts[l] = o;
    o += bn * m.sa[l];
  }
  m.total = o;
  int t = 0;
  for (int l = L - 1; l >= 0; --l) {
    m.outer_lo[l] = t;
    m.outer_n[l] = l ? d.hp[l] / 4 * (d.hp[l - 1] / 4)
                     : m.fp / 4 * (d.hp[0] / 4);
    t += m.outer_n[l];
  }
  m.outer_total = t;
  int v = d.hp[L - 1] / 4 + 1;
  for (int l = L - 1; l >= 1; --l) {
    m.vec_lo[l] = v;
    v += d.hp[l] / 4;
  }
  m.vec_total = v;
  return m;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

// one 4 × 4 tile of a cross-stock product: c[r][q] += Σ_k A[k][r]·B[k][q]
struct Outer {
  const float* A;
  const float* B;
  int sA, sB, out, ostride, rows;  // rows of the tile in the packed layout
};

// tile i of layer l: dW_l [h_l][hp_{l-1}] = Σ dh_pre_l ⊗ a_{l-1}, or
// (l = 0) dK1 [F][hp0] = Σ x ⊗ dh_pre_0
__device__ __forceinline__ Outer outer_at(const float* sm, const FfnDims& d,
                                          const BwdSmem& m, int l, int i) {
  const int nb = d.hp[l > 0 ? l - 1 : 0] / 4;
  const int ra = 4 * (i / nb), cb = 4 * (i % nb);
  Outer o;
  if (l > 0) {
    o.A = sm + m.acts[l] + ra;
    o.sA = m.sa[l];
    o.B = sm + m.acts[l - 1] + cb;
    o.sB = m.sa[l - 1];
    o.ostride = d.hp[l - 1];
    o.out = d.off_w[l] + ra * o.ostride + cb;
    o.rows = d.h[l] - ra;
  } else {
    o.A = sm + m.x + ra;
    o.sA = m.sx;
    o.B = sm + m.acts[0] + cb;
    o.sB = m.sa[0];
    o.ostride = d.hp[0];
    o.out = ra * o.ostride + cb;
    o.rows = d.F - ra;
  }
  return o;
}

__device__ __forceinline__ void outer_sum(float (&c)[16], const Outer& o,
                                          int kmax, int bf16) {
#pragma unroll 2
  for (int k = 0; k < kmax; ++k) {
    float4 a = ld4(o.A + k * o.sA), b = ld4(o.B + k * o.sB);
    if (bf16) {
      a = round4(a);
      b = round4(b);
    }
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        c[r * 4 + q] = fmaf(av[r], bv[q], c[r * 4 + q]);
  }
}

__device__ __forceinline__ void outer_load(float (&c)[16], const float* gp,
                                           const Outer& o) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 v = r < o.rows ? ld4(gp + o.out + r * o.ostride)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    c[r * 4] = v.x;
    c[r * 4 + 1] = v.y;
    c[r * 4 + 2] = v.z;
    c[r * 4 + 3] = v.w;
  }
}

__device__ __forceinline__ void outer_store(float* gp, const Outer& o,
                                            const float (&c)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r < o.rows)
      st4(gp + o.out + r * o.ostride, c[r * 4], c[r * 4 + 1], c[r * 4 + 2],
          c[r * 4 + 3]);
}

// one 4-wide tile of a per-unit sum over the stocks: kind 0 Σ A[k] (db_l),
// 1 Σ A[k]·g[k] (dkout), 2 Σ g[k] (dbout, one element)
struct Vec {
  const float* A;
  int sA, kind, out, n;
};

// vector tile id of step l (l = L: the output projection's dkout, dbout)
__device__ __forceinline__ Vec vec_at(const float* sm, const FfnDims& d,
                                      const BwdSmem& m, int id) {
  const int L = d.n_hidden, nk = d.hp[L - 1] / 4;
  Vec v;
  if (id < nk) {
    v = Vec{sm + m.acts[L - 1] + 4 * id, m.sa[L - 1], 1,
            d.off_kout + 4 * id, 4};
  } else if (id == nk) {
    v = Vec{nullptr, 0, 2, d.off_bout, 1};
  } else {
    int l = L - 1;
    while (l > 1 && id >= m.vec_lo[l - 1]) --l;
    const int j = 4 * (id - m.vec_lo[l]);
    v = Vec{sm + m.acts[l] + j, m.sa[l], 0, d.off_b[l] + j, 4};
  }
  return v;
}

__device__ __forceinline__ void vec_sum(float (&c)[4], const Vec& v,
                                        const float* gs, int kmax) {
  if (v.kind == 2) {
    for (int k = 0; k < kmax; ++k) c[0] += gs[k];
    return;
  }
  for (int k = 0; k < kmax; ++k) {
    const float4 a = ld4(v.A + k * v.sA);
    if (v.kind == 1) {
      const float gk = gs[k];
      c[0] = fmaf(a.x, gk, c[0]);
      c[1] = fmaf(a.y, gk, c[1]);
      c[2] = fmaf(a.z, gk, c[2]);
      c[3] = fmaf(a.w, gk, c[3]);
    } else {
      c[0] += a.x;
      c[1] += a.y;
      c[2] += a.z;
      c[3] += a.w;
    }
  }
}

__device__ __forceinline__ void vec_load(float (&c)[4], const float* gp,
                                         const Vec& v) {
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = q < v.n ? gp[v.out + q] : 0.f;
}

__device__ __forceinline__ void vec_store(float* gp, const Vec& v,
                                          const float (&c)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < v.n) gp[v.out + q] = c[q];
}

template <int MAXW, int NT, typename PX>
__global__ void __launch_bounds__(kMaxTile)
sdf_ffn_bwd_kernel(const PX* __restrict__ x, const float* __restrict__ zp,
                   const float* __restrict__ params,
                   const float* __restrict__ g, float* __restrict__ grad_part,
                   float* __restrict__ dzp_part, int T, int N, FfnDims d,
                   BwdSmem m, int bf16, Dropout drop) {
  constexpr int NR = NT > 0 ? NT : 1;
  constexpr int NV = NT > 0 ? kVecTiles : 1;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.y;
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int bn = blockDim.x;
  const int F = d.F, L = d.n_hidden, hp0 = d.hp[0], h0 = d.h[0];
  const float* W = sm;
  float* zps = sm + m.zp;
  float* gs = sm + m.g;
  float* gp = grad_part + ((size_t)s * G + b) * d.P;
  float* dzp_blk = dzp_part + ((size_t)s * G + b) * T * h0;

  // stage member s's packed weights
  const float4* src =
      reinterpret_cast<const float4*>(params + (size_t)s * d.P);
  for (int i = tid; i < d.P / 4; i += bn) smem4[i] = src[i];

  float acc[NR][16], vac[NV][4];
#pragma unroll
  for (int q = 0; q < NR; ++q)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[q][e] = 0.f;
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) vac[q][e] = 0.f;

  const int ntiles = (N + bn - 1) / bn;
  const long long cells = (long long)T * ntiles;
  const float dscale = drop.on ? drop.scale : 1.f;
  const uint32_t base = drop.on ? drop.member_base[s] : 0u;

  for (long long c = b; c < cells; c += G) {
    const int t = (int)(c / ntiles);
    const int n0 = (int)(c % ntiles) * bn, n = n0 + tid;
    const int kmax = min(bn, N - n0);
    const bool valid = n < N;
    __syncthreads();  // the previous cell is done with the shared tiles
    for (int j = tid; j < hp0; j += bn)
      zps[j] = j < h0 ? zp[((size_t)s * T + t) * h0 + j] : 0.f;
    __syncthreads();

    // -- per stock: recompute the forward, keep the rows -------------------
    float dh[MAXW];
    {
      const float gv = valid ? g[((size_t)s * T + t) * N + n] : 0.f;
      gs[tid] = gv;
      const uint32_t row =
          drop.on ? sdf_ffn::row_hash(base, t, drop.offset + n) : 0u;
      const PX* xt = x + (size_t)t * F * N + n;
      float* xrow = sm + m.x + tid * m.sx;
      float cur[MAXW];
#pragma unroll
      for (int j = 0; j < MAXW; ++j) cur[j] = 0.f;
#pragma unroll 1
      for (int f = 0; f < m.fp; f += 4) {
        float xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xv[r] = valid && f + r < F ? panel::ldx(xt + (size_t)(f + r) * N)
                                     : 0.f;
        st4(xrow + f, xv[0], xv[1], xv[2], xv[3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (f + r < F) {
            const float xf = bf16 ? round_bf16(xv[r]) : xv[r];
            const float* wrow = W + (f + r) * hp0;
#pragma unroll
            for (int j = 0; j < MAXW; j += 4) {
              if (j < hp0) {
                const float4 w = ld4(wrow + j);
                cur[j] = fmaf(w.x, xf, cur[j]);
                cur[j + 1] = fmaf(w.y, xf, cur[j + 1]);
                cur[j + 2] = fmaf(w.z, xf, cur[j + 2]);
                cur[j + 3] = fmaf(w.w, xf, cur[j + 3]);
              }
            }
          }
        }
      }
      float* a0 = sm + m.acts[0] + tid * m.sa[0];
#pragma unroll
      for (int j = 0; j < MAXW; j += 4) {
        if (j < hp0) {
          float a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = fmaxf(cur[j + q] + zps[j + q], 0.f);
            if (drop.on && j + q < h0)
              v = sdf_ffn::keep_unit(row, 0, j + q, drop.threshold)
                      ? v * drop.scale : 0.f;
            a[q] = v;
            cur[j + q] = bf16 ? round_bf16(v) : v;
          }
          st4(a0 + j, a[0], a[1], a[2], a[3]);
        }
      }
      for (int l = 1; l < L; ++l) {
        const int hin = d.hp[l - 1], hout = d.h[l], hpl = d.hp[l];
        const float* Wl = W + d.off_w[l];
        const float* bl = W + d.off_b[l];
        float* al = sm + m.acts[l] + tid * m.sa[l];
        // four output units per step (four FMA chains side by side), not
        // unrolled; rows past h_l read the last real row and are zeroed
#pragma unroll 1
        for (int k = 0; k < hpl; k += 4) {
          const float* w0 = Wl + min(k, hout - 1) * hin;
          const float* w1 = Wl + min(k + 1, hout - 1) * hin;
          const float* w2 = Wl + min(k + 2, hout - 1) * hin;
          const float* w3 = Wl + min(k + 3, hout - 1) * hin;
          float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
#pragma unroll
          for (int j = 0; j < MAXW; j += 4) {
            if (j < hin) {
              const float4 p = ld4(w0 + j), q = ld4(w1 + j);
              const float4 r = ld4(w2 + j), e = ld4(w3 + j);
              u0 = fmaf(p.x, cur[j], u0);
              u1 = fmaf(q.x, cur[j], u1);
              u2 = fmaf(r.x, cur[j], u2);
              u3 = fmaf(e.x, cur[j], u3);
              u0 = fmaf(p.y, cur[j + 1], u0);
              u1 = fmaf(q.y, cur[j + 1], u1);
              u2 = fmaf(r.y, cur[j + 1], u2);
              u3 = fmaf(e.y, cur[j + 1], u3);
              u0 = fmaf(p.z, cur[j + 2], u0);
              u1 = fmaf(q.z, cur[j + 2], u1);
              u2 = fmaf(r.z, cur[j + 2], u2);
              u3 = fmaf(e.z, cur[j + 2], u3);
              u0 = fmaf(p.w, cur[j + 3], u0);
              u1 = fmaf(q.w, cur[j + 3], u1);
              u2 = fmaf(r.w, cur[j + 3], u2);
              u3 = fmaf(e.w, cur[j + 3], u3);
            }
          }
          float a[4] = {u0, u1, u2, u3};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int u = k + q;
            float v = 0.f;  // padded units stay exactly 0
            if (u < hout) {
              v = fmaxf(a[q] + bl[u], 0.f);
              if (drop.on)
                v = sdf_ffn::keep_unit(row, l, u, drop.threshold)
                        ? v * drop.scale : 0.f;
            }
            a[q] = v;
          }
          st4(al + k, a[0], a[1], a[2], a[3]);
        }
#pragma unroll
        for (int k = 0; k < MAXW; k += 4) {
          float4 a = k < hpl ? ld4(al + k) : make_float4(0.f, 0.f, 0.f, 0.f);
          if (bf16) a = round4(a);
          cur[k] = a.x;
          cur[k + 1] = a.y;
          cur[k + 2] = a.z;
          cur[k + 3] = a.w;
        }
      }
      // the output projection's cotangent: dh = round(kout) · round(g)
      const float gr = bf16 ? round_bf16(gv) : gv;
      const float* ko = W + d.off_kout;
      const int hpl = d.hp[L - 1];
#pragma unroll
      for (int j = 0; j < MAXW; ++j) dh[j] = j < hpl ? ko[j] * gr : 0.f;
    }
    __syncthreads();

    // -- block: dkout (f32, unrounded) and dbout -----------------------------
    {
      const int hi = d.hp[L - 1] / 4 + 1;
      if (NT > 0) {
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const int id = tid + q * bn;
          if (id < hi) vec_sum(vac[q], vec_at(sm, d, m, id), gs, kmax);
        }
      } else {
        for (int id = tid; id < hi; id += bn) {
          const Vec v = vec_at(sm, d, m, id);
          float cv[4];
          vec_load(cv, gp, v);
          vec_sum(cv, v, gs, kmax);
          vec_store(gp, v, cv);
        }
      }
    }
    __syncthreads();  // a_L is read; it becomes dh_pre_L below

    // -- the layers, last to first ------------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      {
        // dh_pre = dh · dropout scale · relu mask, in place of the row of
        // post-dropout activations (> 0 exactly where both masks keep)
        float* al = sm + m.acts[l] + tid * m.sa[l];
        const int hpl = d.hp[l];
#pragma unroll
        for (int j = 0; j < MAXW; j += 4) {
          if (j < hpl) {
            const float4 a = ld4(al + j);
            st4(al + j, a.x > 0.f ? dh[j] * dscale : 0.f,
                a.y > 0.f ? dh[j + 1] * dscale : 0.f,
                a.z > 0.f ? dh[j + 2] * dscale : 0.f,
                a.w > 0.f ? dh[j + 3] * dscale : 0.f);
          }
        }
        if (l > 0) {
          // dh_{l-1} = round(W_l)ᵀ · round(dh_pre): four units j per step
          // (read back from this thread's row), not unrolled; rows past
          // h_l read the last real row against a dh_pre of exactly 0
          const int hin = d.hp[l - 1], hout = d.h[l];
          const float* Wl = W + d.off_w[l];
#pragma unroll
          for (int i = 0; i < MAXW; ++i) dh[i] = 0.f;
#pragma unroll 1
          for (int j = 0; j < hpl; j += 4) {
            float4 p = ld4(al + j);
            if (bf16) p = round4(p);
            const float* w0 = Wl + min(j, hout - 1) * hin;
            const float* w1 = Wl + min(j + 1, hout - 1) * hin;
            const float* w2 = Wl + min(j + 2, hout - 1) * hin;
            const float* w3 = Wl + min(j + 3, hout - 1) * hin;
#pragma unroll
            for (int i = 0; i < MAXW; i += 4) {
              if (i < hin) {
                const float4 a = ld4(w0 + i), bq = ld4(w1 + i);
                const float4 cq = ld4(w2 + i), e = ld4(w3 + i);
                dh[i] = fmaf(a.x, p.x, dh[i]);
                dh[i + 1] = fmaf(a.y, p.x, dh[i + 1]);
                dh[i + 2] = fmaf(a.z, p.x, dh[i + 2]);
                dh[i + 3] = fmaf(a.w, p.x, dh[i + 3]);
                dh[i] = fmaf(bq.x, p.y, dh[i]);
                dh[i + 1] = fmaf(bq.y, p.y, dh[i + 1]);
                dh[i + 2] = fmaf(bq.z, p.y, dh[i + 2]);
                dh[i + 3] = fmaf(bq.w, p.y, dh[i + 3]);
                dh[i] = fmaf(cq.x, p.z, dh[i]);
                dh[i + 1] = fmaf(cq.y, p.z, dh[i + 1]);
                dh[i + 2] = fmaf(cq.z, p.z, dh[i + 2]);
                dh[i + 3] = fmaf(cq.w, p.z, dh[i + 3]);
                dh[i] = fmaf(e.x, p.w, dh[i]);
                dh[i + 1] = fmaf(e.y, p.w, dh[i + 1]);
                dh[i + 2] = fmaf(e.z, p.w, dh[i + 2]);
                dh[i + 3] = fmaf(e.w, p.w, dh[i + 3]);
              }
            }
          }
        }
      }
      __syncthreads();

      // -- block: layer l's cross-stock products ----------------------------
      const int lo = m.outer_lo[l], hi = lo + m.outer_n[l];
      if (NT > 0) {
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          const int id = tid + q * bn;
          if (id >= lo && id < hi)
            outer_sum(acc[q], outer_at(sm, d, m, l, id - lo), kmax, bf16);
        }
      } else {
        for (int id = lo + tid; id < hi; id += bn) {
          const Outer o = outer_at(sm, d, m, l, id - lo);
          float co[16];
          outer_load(co, gp, o);
          outer_sum(co, o, kmax, bf16);
          outer_store(gp, o, co);
        }
      }
      if (l > 0) {
        // db_l = Σ_n dh_pre_l
        const int vlo = m.vec_lo[l], vhi = vlo + d.hp[l] / 4;
        if (NT > 0) {
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const int id = tid + q * bn;
            if (id >= vlo && id < vhi)
              vec_sum(vac[q], vec_at(sm, d, m, id), gs, kmax);
          }
        } else {
          for (int id = vlo + tid; id < vhi; id += bn) {
            const Vec v = vec_at(sm, d, m, id);
            float cv[4];
            vec_load(cv, gp, v);
            vec_sum(cv, v, gs, kmax);
            vec_store(gp, v, cv);
          }
        }
        __syncthreads();  // a_{l-1} is read; it becomes dh_pre_{l-1}
      } else {
        // dzp[t] += Σ_n dh1_pre (f32, unrounded)
        const float* a0 = sm + m.acts[0];
        for (int v = tid; v < hp0 / 4; v += bn) {
          float cv[4] = {0.f, 0.f, 0.f, 0.f};
          const Vec vv{a0 + 4 * v, m.sa[0], 0, 0, 4};
          vec_sum(cv, vv, gs, kmax);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * v + q < h0) dzp_blk[(size_t)t * h0 + 4 * v + q] += cv[q];
        }
      }
    }
  }

  if (NT > 0) {
    // the register tiles, written once
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int id = tid + q * bn;
      if (id < m.outer_total) {
        int l = 0;
        while (id < m.outer_lo[l]) ++l;
        outer_store(gp, outer_at(sm, d, m, l, id - m.outer_lo[l]), acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int id = tid + q * bn;
      if (id < m.vec_total) vec_store(gp, vec_at(sm, d, m, id), vac[q]);
    }
  }
}

// every plan is checked against this file's own arithmetic: 0 if the card
// takes it, else kUnsupported (or a cudaError_t value)
template <int NT, typename PX>
int bwd_kernel_info(size_t smem, int bn, int* blocks, int* regs,
                    int* local_bytes) {
  auto kern = sdf_ffn_bwd_kernel<SDF_FFN_MAXW, NT, PX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, bn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// the register instances: none at w128 (128-wide rows leave no registers
// for the accumulators)
template <typename PX>
int instance_info(int nt, size_t smem, int bn, int* blocks, int* regs,
                  int* local_bytes) {
  switch (nt) {
    case 0:
      return bwd_kernel_info<0, PX>(smem, bn, blocks, regs, local_bytes);
#if SDF_FFN_MAXW <= 64
    case 4:
      return bwd_kernel_info<4, PX>(smem, bn, blocks, regs, local_bytes);
    case 6:
      return bwd_kernel_info<6, PX>(smem, bn, blocks, regs, local_bytes);
#endif
    default:
      return kUnsupported;
  }
}

// ... of the instance for an f32 (xb16 0) or bf16 (1) panel
int kernel_info(int nt, int xb16, size_t smem, int bn, int* blocks,
                int* regs, int* local_bytes) {
  return xb16 ? instance_info<__nv_bfloat16>(nt, smem, bn, blocks, regs,
                                             local_bytes)
              : instance_info<float>(nt, smem, bn, blocks, regs, local_bytes);
}

// 0 and the plan's smem plan if (layout, tile bn, threads, nt, smem bytes)
// is a plan this file takes, else kUnsupported
int check_plan(const int* layout, int bn, int threads, int nt,
               long long smem_bytes, FfnDims* d, BwdSmem* m) {
  int maxw = 0;
  if (sdf_ffn::read_dims(layout, d, &maxw) != 0) return kUnsupported;
  if (maxw > SDF_FFN_MAXW) return kUnsupported;
  if (bn % 32 || bn < 32 || bn > kMaxTile || threads != bn)
    return kUnsupported;
  *m = smem_plan(*d, bn);
  const long long smem = (long long)sizeof(float) * m->total;
  if (smem != smem_bytes || smem > (long long)kMaxSmem) return kUnsupported;
  if (nt > 0 && (m->outer_total > nt * bn || m->vec_total > kVecTiles * bn))
    return kUnsupported;
  return 0;
}

template <int NT>
int launch_bwd(dim3 grid, int bn, size_t smem, cudaStream_t stream,
               const void* x, int xb16, const float* zp, const float* params,
               const float* g, float* grad_part, float* dzp_part, int T,
               int N, const FfnDims& d, const BwdSmem& m, int bf16,
               const Dropout& drop) {
  if (xb16)
    sdf_ffn_bwd_kernel<SDF_FFN_MAXW, NT, __nv_bfloat16>
        <<<grid, bn, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                     zp, params, g, grad_part, dzp_part, T, N,
                                     d, m, bf16, drop);
  else
    sdf_ffn_bwd_kernel<SDF_FFN_MAXW, NT, float><<<grid, bn, smem, stream>>>(
        static_cast<const float*>(x), zp, params, g, grad_part, dzp_part, T,
        N, d, m, bf16, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// Registers per thread of the kernel instance with `nt` register tiles per
// thread (0: accumulators in grad_part) for an f32 (xb16 0) or bf16 (1)
// panel, or -1 for an instance this library lacks.
extern "C" int sdf_ffn_bwd_registers(int nt, int xb16) {
  int info[3] = {0, 0, 0};
  if (kernel_info(nt, xb16, 0, kMaxTile, &info[0], &info[1], &info[2]) != 0)
    return kUnsupported;
  return info[1];
}

// What the card makes of a plan: out = [resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
// local-memory bytes per thread] of its instance for an f32 (xb16 0) or
// bf16 (1) panel. Returns 0, a cudaError_t value, or -1 for a plan this
// file refuses.
extern "C" int sdf_ffn_bwd_plan_info(const int* layout, int bn, int threads,
                                     int nt, long long smem_bytes, int xb16,
                                     int* out) {
  FfnDims d;
  BwdSmem m;
  const int rc = check_plan(layout, bn, threads, nt, smem_bytes, &d, &m);
  if (rc != 0) return rc;
  return kernel_info(nt, xb16, (size_t)smem_bytes, bn, &out[0], &out[1],
                     &out[2]);
}

// x: the panel [T, F, N], f32, or bf16 where xb16 is 1 (panel.cuh).
// grad_part [S, G, P] and dzp_part [S, G, T, H1], both zeroed by the
// caller; dropout (and its global stock `offset`) as in sdf_ffn_fwd. The
// plan (stock tile bn = threads per block, nt register tiles
// per thread or 0 for accumulators in grad_part, shared-memory bytes, the
// resident blocks per SM it counts on, G blocks per member) comes from
// ops/sdf_ffn.py::bwd_plan; a plan that disagrees with this file's
// arithmetic, or that the card does not hold resident, is refused. Returns
// 0, a cudaError_t value, or -1 for an unsupported shape or plan.
extern "C" int sdf_ffn_bwd(const void* x, int xb16, const float* zp,
                           const float* params, const float* g,
                           float* grad_part, float* dzp_part, int S, int T,
                           int N, const int* layout, int bf16, int dropout,
                           const unsigned int* member_base,
                           unsigned int threshold, float scale,
                           unsigned int offset, int G, int bn,
                           int threads, int nt, long long smem_bytes,
                           int blocks_per_sm, void* stream) {
  if (S < 1 || T < 1 || N < 1 || S > 65535 || G < 1 || blocks_per_sm < 1)
    return kUnsupported;
  FfnDims d;
  BwdSmem m;
  int rc = check_plan(layout, bn, threads, nt, smem_bytes, &d, &m);
  if (rc != 0) return rc;
  int info[3] = {0, 0, 0};
  rc = kernel_info(nt, xb16, (size_t)smem_bytes, bn, &info[0], &info[1],
                   &info[2]);
  if (rc != 0) return rc;
  if (info[0] < blocks_per_sm) return kUnsupported;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const dim3 grid((unsigned)G, (unsigned)S);
  const size_t smem = (size_t)smem_bytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 0:
      return launch_bwd<0>(grid, bn, smem, st, x, xb16, zp, params, g,
                           grad_part, dzp_part, T, N, d, m, bf16, drop);
#if SDF_FFN_MAXW <= 64
    case 4:
      return launch_bwd<4>(grid, bn, smem, st, x, xb16, zp, params, g,
                           grad_part, dzp_part, T, N, d, m, bf16, drop);
    case 6:
      return launch_bwd<6>(grid, bn, smem, st, x, xb16, zp, params, g,
                           grad_part, dzp_part, T, N, d, m, bf16, drop);
#endif
    default:
      return kUnsupported;
  }
}
