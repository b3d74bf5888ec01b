// Recompute backward and panel cotangent of the fused SDF-FFN for Hopper
// (sm_90a). The panel cotangent, sdf_ffn_dx, is the second entry of this
// file, below.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/pallas_ffn.py
// _bwd_kernel (:205, one member) and, through the explicit member axis S,
// _bwd_kernel_members (:591). Given the cotangent g [S, T, N] of the raw
// weights, it recomputes the forward tile by tile from (x, zp, weights,
// dropout member bases), keeps the ReLU and dropout masks, stores no activations in
// device memory, and emits, per member, the gradients of every packed
// parameter (dK1 [F][hp0], dW_l, db_l, dkout, dbout, in the forward's packed
// layout) and dzp [T, H1].
//
// Rounding points are the JAX kernel's (pallas_ffn._dot): with bf16 both
// operands of every product are rounded (kout·g, Wᵀ·dh_pre, dh_pre·aᵀ,
// dh1_pre·xᵀ), while the dkout and dzp contractions and the bias sums stay
// f32 on unrounded values.
//
// What bounds it on this card: about 2.6× the forward's multiply-adds, f32
// FMAs on the CUDA cores, so operations (67 TFLOP/s), not bytes. This first
// version is simple rather than fast: the cross-stock products run out of
// shared memory, and the ~180 KB working set of the paper's widths leaves
// one block of 4 warps per SM.
//
// Design: a block owns a fixed, strided set of (period, 128-stock tile)
// cells of one member. Per cell, one thread per stock recomputes the
// forward in registers (as sdf_ffn.cu does) and writes its post-dropout
// activations, stock-major, into shared memory; it then walks the layers
// backwards, keeping dh in registers and writing dh_pre to shared memory.
// Only the inner loop of each layer's product is unrolled (the outer loop
// over output units reads its operand back from shared memory), which
// keeps the build to seconds instead of minutes.
// After each layer the whole block forms that layer's weight gradient as a
// sum over the tile's stocks into a block-private accumulator in shared
// memory; every accumulator element always belongs to one thread, so the
// sums are taken in a fixed order. Each block writes one partial, and the
// wrapper sums the partials in a fixed order (torch.sum over the partial
// axis): two calls with the same inputs give bitwise-equal gradients. No
// float atomics. Stock lanes past N read x = 0 and g = 0, so they add
// nothing.

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

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 227 * 1024;

// offsets (floats) of the shared-memory regions, and their row strides
// (odd, so a warp writing one column of a stock-major tile hits 32 banks)
struct BwdSmem {
  int w, zp, x, acts[kMaxLayers], dh, g, acc, total;
  int sx, sa[kMaxLayers], sd;
};

inline int odd(int v) { return v | 1; }

inline BwdSmem smem_plan(const FfnDims& d, int bn) {
  BwdSmem m{};
  int o = 0, maxhp = 0;
  m.w = o;
  o += d.P;
  m.zp = o;
  o += d.hp[0];
  m.sx = odd(d.F);
  m.x = o;
  o += bn * m.sx;
  for (int l = 0; l < d.n_hidden; ++l) {
    m.sa[l] = odd(d.hp[l]);
    m.acts[l] = o;
    o += bn * m.sa[l];
    if (d.hp[l] > maxhp) maxhp = d.hp[l];
  }
  m.sd = odd(maxhp);
  m.dh = o;
  o += bn * m.sd;
  m.g = o;
  o += bn;
  m.acc = o;
  o += d.P;
  m.total = o;
  return m;
}

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
sdf_ffn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ zp,
                   const float* __restrict__ params,
                   const float* __restrict__ g, float* __restrict__ grad_part,
                   float* __restrict__ dzp_part, int T, int N, FfnDims d,
                   BwdSmem m, int bn, int bf16, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.y;
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int F = d.F, L = d.n_hidden, hp0 = d.hp[0], h0 = d.h[0];
  float* W = sm + m.w;
  float* zps = sm + m.zp;
  float* xs = sm + m.x;
  float* dhs = sm + m.dh;
  float* gs = sm + m.g;
  float* acc = sm + m.acc;

  // stage member s's packed weights; zero the block's accumulators
  const float4* src =
      reinterpret_cast<const float4*>(params + (size_t)s * d.P);
  for (int i = tid; i < d.P / 4; i += blockDim.x) smem4[i] = src[i];
  for (int i = tid; i < d.P; i += blockDim.x) acc[i] = 0.f;

  const int ntiles = (N + bn - 1) / bn;
  const long long cells = (long long)T * ntiles;
  const float dscale = drop.on ? drop.scale : 1.f;
  const uint32_t base = drop.on ? drop.member_base[s] : 0u;
  float* dzp_blk = dzp_part + ((size_t)s * G + b) * T * h0;

  for (long long c = b; c < cells; c += G) {
    const int t = (int)(c / ntiles);
    const int n = (int)(c % ntiles) * bn + tid;
    const bool lane = tid < bn;
    const bool valid = lane && n < N;
    __syncthreads();  // the previous cell is done with the shared tiles
    for (int j = tid; j < hp0; j += blockDim.x)
      zps[j] = j < h0 ? zp[((size_t)s * T + t) * h0 + j] : 0.f;
    __syncthreads();

    // -- per stock: recompute the forward, keep the activations ------------
    float dh[MAXW];
    if (lane) {
      const float gv = valid ? g[((size_t)s * T + t) * N + n] : 0.f;
      gs[tid] = gv;
      const uint32_t row = drop.on ? sdf_ffn::row_hash(base, t, n) : 0u;
      const float* xt = x + (size_t)t * F * N;
      float* xrow = xs + tid * m.sx;
      float cur[MAXW];
#pragma unroll
      for (int j = 0; j < MAXW; ++j) cur[j] = 0.f;
      for (int f = 0; f < F; ++f) {
        float xf = valid ? __ldg(xt + (size_t)f * N + n) : 0.f;
        xrow[f] = xf;
        if (bf16) xf = round_bf16(xf);
        const float4* wrow = reinterpret_cast<const float4*>(W + f * hp0);
#pragma unroll
        for (int j = 0; j < MAXW; j += 4) {
          if (j < hp0) {
            const float4 w = wrow[j / 4];
            cur[j] = fmaf(w.x, xf, cur[j]);
            cur[j + 1] = fmaf(w.y, xf, cur[j + 1]);
            cur[j + 2] = fmaf(w.z, xf, cur[j + 2]);
            cur[j + 3] = fmaf(w.w, xf, cur[j + 3]);
          }
        }
      }
      float* a0 = sm + m.acts[0] + tid * m.sa[0];
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        if (j < hp0) {
          float a = fmaxf(cur[j] + zps[j], 0.f);
          if (drop.on && j < h0)
            a = sdf_ffn::keep_unit(row, 0, j, drop.threshold) ? a * drop.scale
                                                               : 0.f;
          a0[j] = a;
          cur[j] = bf16 ? round_bf16(a) : a;
        }
      }
      for (int l = 1; l < L; ++l) {
        const int hin = d.hp[l - 1], hout = d.h[l], hpl = d.hp[l];
        const float* Wl = W + d.off_w[l];
        const float* bl = W + d.off_b[l];
        float* al = sm + m.acts[l] + tid * m.sa[l];
        // one output unit per iteration, not unrolled (only the inner
        // loop over the register-held inputs is): the build stays small
#pragma unroll 1
        for (int k = 0; k < hpl; ++k) {
          float a = 0.f;
          if (k < hout) {
            const float4* wrow =
                reinterpret_cast<const float4*>(Wl + k * hin);
#pragma unroll
            for (int j = 0; j < MAXW; j += 4) {
              if (j < hin) {
                const float4 w = wrow[j / 4];
                a = fmaf(w.x, cur[j], a);
                a = fmaf(w.y, cur[j + 1], a);
                a = fmaf(w.z, cur[j + 2], a);
                a = fmaf(w.w, cur[j + 3], a);
              }
            }
            a = fmaxf(a + bl[k], 0.f);
            if (drop.on)
              a = sdf_ffn::keep_unit(row, l, k, drop.threshold)
                      ? a * drop.scale : 0.f;
          }
          al[k] = a;  // padded lanes stay exactly 0
        }
#pragma unroll
        for (int k = 0; k < MAXW; ++k) {
          const float a = k < hpl ? al[k] : 0.f;
          cur[k] = bf16 ? round_bf16(a) : a;
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
      const int hpl = d.hp[L - 1], sa = m.sa[L - 1];
      const float* aL = sm + m.acts[L - 1];
      for (int j = tid; j < hpl; j += blockDim.x) {
        float v = 0.f;
        for (int k = 0; k < bn; ++k) v = fmaf(aL[k * sa + j], gs[k], v);
        acc[d.off_kout + j] += v;
      }
      if (tid == 0) {
        float v = 0.f;
        for (int k = 0; k < bn; ++k) v += gs[k];
        acc[d.off_bout] += v;
      }
    }

    // -- the layers, last to first ------------------------------------------
    for (int l = L - 1; l >= 0; --l) {
      if (lane) {
        const float* al = sm + m.acts[l] + tid * m.sa[l];
        float* drow = dhs + tid * m.sd;
        const int hpl = d.hp[l];
        // dh_pre = dh · dropout scale · relu mask; a post-dropout
        // activation is > 0 exactly where both masks keep the unit
#pragma unroll
        for (int j = 0; j < MAXW; ++j)
          if (j < hpl) drow[j] = al[j] > 0.f ? dh[j] * dscale : 0.f;
        if (l > 0) {
          // dh_{l-1} = round(W_l)ᵀ · round(dh_pre): one output unit j per
          // iteration (read back from this thread's shared-memory row),
          // not unrolled; the inner loop over the register-held dh is
          const int hin = d.hp[l - 1], hout = d.h[l];
          const float* Wl = W + d.off_w[l];
#pragma unroll
          for (int i = 0; i < MAXW; ++i) dh[i] = 0.f;
#pragma unroll 1
          for (int j = 0; j < hout; ++j) {
            const float dj = bf16 ? round_bf16(drow[j]) : drow[j];
            const float4* wrow =
                reinterpret_cast<const float4*>(Wl + j * hin);
#pragma unroll
            for (int i = 0; i < MAXW; i += 4) {
              if (i < hin) {
                const float4 w = wrow[i / 4];
                dh[i] = fmaf(w.x, dj, dh[i]);
                dh[i + 1] = fmaf(w.y, dj, dh[i + 1]);
                dh[i + 2] = fmaf(w.z, dj, dh[i + 2]);
                dh[i + 3] = fmaf(w.w, dj, dh[i + 3]);
              }
            }
          }
        }
      }
      __syncthreads();

      if (l > 0) {
        // dW_l = Σ_n round(dh_pre) ⊗ round(a_{l-1}); db_l = Σ_n dh_pre
        const int hin = d.hp[l - 1], hout = d.h[l], sa = m.sa[l - 1];
        const float* ain = sm + m.acts[l - 1];
        float* dW = acc + d.off_w[l];
        float* db = acc + d.off_b[l];
        for (int e = tid; e < hout * hin; e += blockDim.x) {
          const int j = e / hin, i = e % hin;
          float v = 0.f;
          for (int k = 0; k < bn; ++k) {
            float dp = dhs[k * m.sd + j], av = ain[k * sa + i];
            if (bf16) {
              dp = round_bf16(dp);
              av = round_bf16(av);
            }
            v = fmaf(dp, av, v);
          }
          dW[e] += v;
        }
        for (int j = tid; j < hout; j += blockDim.x) {
          float v = 0.f;
          for (int k = 0; k < bn; ++k) v += dhs[k * m.sd + j];
          db[j] += v;
        }
      } else {
        // dK1 [F][hp0] = Σ_n round(x) ⊗ round(dh1_pre); dzp[t] = Σ_n dh1_pre
        for (int e = tid; e < F * hp0; e += blockDim.x) {
          const int f = e / hp0, j = e % hp0;
          float v = 0.f;
          for (int k = 0; k < bn; ++k) {
            float dp = dhs[k * m.sd + j], xv = xs[k * m.sx + f];
            if (bf16) {
              dp = round_bf16(dp);
              xv = round_bf16(xv);
            }
            v = fmaf(dp, xv, v);
          }
          acc[e] += v;
        }
        for (int j = tid; j < h0; j += blockDim.x) {
          float v = 0.f;
          for (int k = 0; k < bn; ++k) v += dhs[k * m.sd + j];
          dzp_blk[(size_t)t * h0 + j] += v;
        }
      }
      __syncthreads();
    }
  }

  __syncthreads();
  float* out = grad_part + ((size_t)s * G + b) * d.P;
  for (int i = tid; i < d.P; i += blockDim.x) out[i] = acc[i];
}

// -- the panel cotangent --------------------------------------------------------
//
// Replaces pallas_ffn.py _dx_kernel (:300). Given g [S, T, N], it recomputes
// each member's forward with the same dropout masks, walks the dh chain down
// to the first layer (sdf_ffn_bwd_reference's rounding points) and emits
//
//   dx[t, :, n] = Σ_s round(K1_s) · round(dh1_pre_s[t, :, n])      [T, F, N]
//
// summed over the members because they share the panel.
//
// What bounds it on this card: operations, about twice the forward's f32
// FMAs (recompute, the dh chain, then F·H1 for dx) against the panel read
// once and dx written once (~4 FLOP per byte per member at the paper's
// widths, so compute from S = 1 up).
//
// Design: one thread per (period, stock); a block owns one period and 128
// stocks and walks the members in ascending order, staging each member's
// packed weights (≈29 KB at the paper's widths, so nine do not fit at once)
// and its zp row in shared memory in turn. Per member a thread recomputes
// the forward with the activations in registers and keeps each layer's
// derivative factor as one bit per unit (ReLU active and the unit kept: the
// factor is then the dropout scale); it then carries dh in registers down
// the layers, staging dh_pre in its own shared-memory column for the
// product with W_lᵀ, and adds K1·dh1_pre into its own dx column in shared
// memory. Every shared column belongs to one thread, and the members are
// added in a fixed order: no atomics, so two calls give bitwise-equal dx.
// Stock lanes past N read x = 0 and g = 0 and write nothing.

constexpr int kDxThreads = 128;

// offsets (floats) of the dx kernel's shared-memory regions; each per-thread
// region is [rows][kDxThreads], so a warp touching one row hits 32 banks
struct DxSmem {
  int zp, scratch, masks, dx, mwords, total;  // member weights at offset 0
};

inline DxSmem dx_plan(const FfnDims& d) {
  DxSmem m{};
  int maxhp = 0;
  for (int l = 0; l < d.n_hidden; ++l)
    if (d.hp[l] > maxhp) maxhp = d.hp[l];
  m.mwords = (maxhp + 31) / 32;
  int o = d.P;
  m.zp = o;
  o += d.hp[0];
  m.scratch = o;
  o += maxhp * kDxThreads;
  m.masks = o;
  o += d.n_hidden * m.mwords * kDxThreads;
  m.dx = o;
  o += d.F * kDxThreads;
  m.total = o;
  return m;
}

template <int MAXW>
__global__ void __launch_bounds__(kDxThreads)
sdf_ffn_dx_kernel(const float* __restrict__ x, const float* __restrict__ zp,
                  const float* __restrict__ params,
                  const float* __restrict__ g, float* __restrict__ dx, int S,
                  int T, int N, FfnDims d, DxSmem m, int bf16, Dropout drop) {
  constexpr int MW = (MAXW + 31) / 32;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.y, tid = threadIdx.x;
  const int n = blockIdx.x * kDxThreads + tid;
  const bool valid = n < N;
  const int F = d.F, L = d.n_hidden, h0 = d.h[0], hp0 = d.hp[0];
  const float* W = sm;  // the current member's packed weights
  float* zps = sm + m.zp;
  float* scr = sm + m.scratch + tid;  // this thread's column, [maxhp]
  uint32_t* msk = reinterpret_cast<uint32_t*>(sm + m.masks) + tid;
  float* dxs = sm + m.dx + tid;  // this thread's dx column, [F]
  const float* xt = x + (size_t)t * F * N + n;
  const float dscale = drop.on ? drop.scale : 1.f;
  for (int f = 0; f < F; ++f) dxs[f * kDxThreads] = 0.f;

  for (int s = 0; s < S; ++s) {
    __syncthreads();  // every thread is done with member s - 1's weights
    const float4* src =
        reinterpret_cast<const float4*>(params + (size_t)s * d.P);
    for (int i = tid; i < d.P / 4; i += kDxThreads) smem4[i] = src[i];
    for (int j = tid; j < hp0; j += kDxThreads)
      zps[j] = j < h0 ? zp[((size_t)s * T + t) * h0 + j] : 0.f;
    __syncthreads();
    const uint32_t row =
        drop.on ? sdf_ffn::row_hash(drop.member_base[s], t, n) : 0u;

    // -- recompute the forward: pre-activations in registers, one factor
    //    bit per unit (ReLU active and the dropout mask keeps the unit) --
    float cur[MAXW];
#pragma unroll
    for (int j = 0; j < MAXW; ++j) cur[j] = 0.f;
    for (int f = 0; f < F; ++f) {
      float xf = valid ? __ldg(xt + (size_t)f * N) : 0.f;
      if (bf16) xf = round_bf16(xf);
      const float4* wrow = reinterpret_cast<const float4*>(W + f * hp0);
#pragma unroll
      for (int j = 0; j < MAXW; j += 4) {
        if (j < hp0) {
          const float4 w = wrow[j / 4];
          cur[j] = fmaf(w.x, xf, cur[j]);
          cur[j + 1] = fmaf(w.y, xf, cur[j + 1]);
          cur[j + 2] = fmaf(w.z, xf, cur[j + 2]);
          cur[j + 3] = fmaf(w.w, xf, cur[j + 3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAXW; ++j) cur[j] += j < hp0 ? zps[j] : 0.f;
    for (int l = 0; l < L; ++l) {
      if (l > 0) {
        // h_pre = W_l · round(a_{l-1}) + b_l: one output unit per
        // iteration (not unrolled), staged in this thread's column
        const int hin = d.hp[l - 1], hout = d.h[l], hpl = d.hp[l];
        const float* Wl = W + d.off_w[l];
        const float* bl = W + d.off_b[l];
#pragma unroll 1
        for (int k = 0; k < hpl; ++k) {
          float a = 0.f;
          if (k < hout) {
            const float4* wrow =
                reinterpret_cast<const float4*>(Wl + k * hin);
#pragma unroll
            for (int j = 0; j < MAXW; j += 4) {
              if (j < hin) {
                const float4 w = wrow[j / 4];
                a = fmaf(w.x, cur[j], a);
                a = fmaf(w.y, cur[j + 1], a);
                a = fmaf(w.z, cur[j + 2], a);
                a = fmaf(w.w, cur[j + 3], a);
              }
            }
            a += bl[k];
          }
          scr[k * kDxThreads] = a;  // padded units stay exactly 0
        }
#pragma unroll
        for (int k = 0; k < MAXW; ++k)
          cur[k] = k < hpl ? scr[k * kDxThreads] : 0.f;
      }
      // cur holds layer l's pre-activations: its factor bits, then its
      // post-dropout activations, rounded as the next product sees them
      const int hpl = d.hp[l];
      uint32_t bits[MW];
#pragma unroll
      for (int w = 0; w < MW; ++w) bits[w] = 0u;
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        if (j < hpl) {
          const bool on = cur[j] > 0.f &&
              (!drop.on || sdf_ffn::keep_unit(row, l, j, drop.threshold));
          bits[j >> 5] |= (uint32_t)on << (j & 31);
          const float a = on ? cur[j] * dscale : 0.f;
          cur[j] = bf16 ? round_bf16(a) : a;
        }
      }
#pragma unroll
      for (int w = 0; w < MW; ++w)
        if (w < m.mwords) msk[(l * m.mwords + w) * kDxThreads] = bits[w];
    }

    // -- the dh chain: dh = round(kout)·round(g), then per layer dh_pre =
    //    dh · factor and dh_{l-1} = round(W_l)ᵀ · round(dh_pre) -------------
    const float gv = valid ? g[((size_t)s * T + t) * N + n] : 0.f;
    const float gr = bf16 ? round_bf16(gv) : gv;
    const float* ko = W + d.off_kout;
    float dh[MAXW];
#pragma unroll
    for (int j = 0; j < MAXW; ++j) dh[j] = j < d.hp[L - 1] ? ko[j] * gr : 0.f;
    for (int l = L - 1; l >= 0; --l) {
      const int hpl = d.hp[l];
      uint32_t bits[MW];
#pragma unroll
      for (int w = 0; w < MW; ++w)
        bits[w] = w < m.mwords ? msk[(l * m.mwords + w) * kDxThreads] : 0u;
#pragma unroll
      for (int j = 0; j < MAXW; ++j) {
        float dp = 0.f;
        if (j < hpl && ((bits[j >> 5] >> (j & 31)) & 1u)) dp = dh[j] * dscale;
        dh[j] = bf16 ? round_bf16(dp) : dp;  // round(dh_pre)
      }
      if (l == 0) break;  // dh now holds round(dh1_pre)
      const int hin = d.hp[l - 1], hout = d.h[l];
      const float* Wl = W + d.off_w[l];
#pragma unroll
      for (int j = 0; j < MAXW; ++j)
        if (j < hpl) scr[j * kDxThreads] = dh[j];
#pragma unroll
      for (int i = 0; i < MAXW; ++i) dh[i] = 0.f;
#pragma unroll 1
      for (int j = 0; j < hout; ++j) {
        const float dj = scr[j * kDxThreads];
        const float4* wrow = reinterpret_cast<const float4*>(Wl + j * hin);
#pragma unroll
        for (int i = 0; i < MAXW; i += 4) {
          if (i < hin) {
            const float4 w = wrow[i / 4];
            dh[i] = fmaf(w.x, dj, dh[i]);
            dh[i + 1] = fmaf(w.y, dj, dh[i + 1]);
            dh[i + 2] = fmaf(w.z, dj, dh[i + 2]);
            dh[i + 3] = fmaf(w.w, dj, dh[i + 3]);
          }
        }
      }
    }

    // -- dx[f] += K1[f, :] · round(dh1_pre), one feature per iteration -----
#pragma unroll 1
    for (int f = 0; f < F; ++f) {
      const float4* wrow = reinterpret_cast<const float4*>(W + f * hp0);
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < MAXW; j += 4) {
        if (j < hp0) {
          const float4 w = wrow[j / 4];
          v = fmaf(w.x, dh[j], v);
          v = fmaf(w.y, dh[j + 1], v);
          v = fmaf(w.z, dh[j + 2], v);
          v = fmaf(w.w, dh[j + 3], v);
        }
      }
      dxs[f * kDxThreads] += v;
    }
  }

  if (valid)
    for (int f = 0; f < F; ++f)
      dx[(size_t)t * F * N + (size_t)f * N + n] = dxs[f * kDxThreads];
}

}  // namespace

// Shared memory (bytes) the kernel needs at stock tile `bn`, or 0 for a
// layout it refuses; the wrapper picks the largest tile that fits.
extern "C" long long sdf_ffn_bwd_smem_bytes(const int* layout, int bn) {
  FfnDims d;
  int maxw = 0;
  if (sdf_ffn::read_dims(layout, &d, &maxw) != 0 || maxw > SDF_FFN_MAXW)
    return 0;
  return (long long)sizeof(float) * smem_plan(d, bn).total;
}

// grad_part [S, G, P] (fully written), dzp_part [S, G, T, H1] (zeroed by
// the caller, accumulated in place). G blocks per member, bn stocks per
// tile (32, 64 or 128). Returns 0, a cudaError_t value, or -1 for an
// unsupported shape.
extern "C" int sdf_ffn_bwd(const float* x, const float* zp,
                           const float* params, const float* g,
                           float* grad_part, float* dzp_part, int S, int T,
                           int N, const int* layout, int bf16, int dropout,
                           const unsigned int* member_base,
                           unsigned int threshold, float scale, int G, int bn,
                           void* stream) {
  FfnDims d;
  int maxw = 0;
  if (sdf_ffn::read_dims(layout, &d, &maxw) != 0) return kUnsupported;
  if (maxw > SDF_FFN_MAXW) return kUnsupported;
  if (S < 1 || T < 1 || N < 1 || S > 65535 || G < 1) return kUnsupported;
  if (bn != 32 && bn != 64 && bn != 128) return kUnsupported;
  const BwdSmem m = smem_plan(d, bn);
  const size_t smem = sizeof(float) * (size_t)m.total;
  if (smem > kMaxSmem) return kUnsupported;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sdf_ffn_bwd_kernel<SDF_FFN_MAXW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Dropout drop{dropout, member_base, threshold, scale};
  dim3 grid((unsigned)G, (unsigned)S);
  sdf_ffn_bwd_kernel<SDF_FFN_MAXW>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, zp, params, g, grad_part, dzp_part, T, N, d, m, bn, bf16, drop);
  return (int)cudaGetLastError();
}

// dx [T, F, N] (fully written). One block per (128-stock tile, period),
// walking the S members in order. Returns 0, a cudaError_t value, or -1 for
// an unsupported shape.
extern "C" int sdf_ffn_dx(const float* x, const float* zp, const float* params,
                          const float* g, float* dx, int S, int T, int N,
                          const int* layout, int bf16, int dropout,
                          const unsigned int* member_base,
                          unsigned int threshold, float scale, void* stream) {
  FfnDims d;
  int maxw = 0;
  if (sdf_ffn::read_dims(layout, &d, &maxw) != 0) return kUnsupported;
  if (maxw > SDF_FFN_MAXW) return kUnsupported;
  if (S < 1 || T < 1 || N < 1 || T > 65535) return kUnsupported;
  const DxSmem m = dx_plan(d);
  const size_t smem = sizeof(float) * (size_t)m.total;
  if (smem > kMaxSmem) return kUnsupported;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdf_ffn_dx_kernel<SDF_FFN_MAXW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Dropout drop{dropout, member_base, threshold, scale};
  dim3 grid((unsigned)((N + kDxThreads - 1) / kDxThreads), (unsigned)T);
  sdf_ffn_dx_kernel<SDF_FFN_MAXW>
      <<<grid, kDxThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          x, zp, params, g, dx, S, T, N, d, m, bf16, drop);
  return (int)cudaGetLastError();
}
