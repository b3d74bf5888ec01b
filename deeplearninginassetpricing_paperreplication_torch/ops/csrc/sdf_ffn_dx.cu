// Panel cotangent of the fused SDF-FFN for Hopper (sm_90a).
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/pallas_ffn.py
// _dx_kernel (:300). Given g [S, T, N], the cotangent of the raw weights, it
// recomputes each member's forward with the same dropout masks, walks the dh
// chain down to the first layer (sdf_ffn_dx_reference's rounding points) and
// emits
//
//   dx[t, :, n] = Σ_s round(K1_s) · round(dh1_pre_s[t, :, n])      [T, F, N]
//
// summed over the members because they share the panel.
//
// What bounds it on this card: operations. A (member, period, stock) costs
// 2·F·H1 + 2·Σ H_{l-1}·H_l + H_L multiply-adds (14,080 at F = 46, hidden
// [64, 64]) against the panel read and dx written once for all members: in
// f32 on the CUDA cores (67 TFLOP/s); in bf16 partly on the tensor cores,
// where the layers below the top stay on the CUDA cores (see route 1).
//
// Design:
//
// * The launch plan (route, stock tile, threads, weight buffers, shared
//   memory, resident blocks) is Python arithmetic in
//   ops/sdf_ffn.py::dx_plan, checked on the card once per plan; this file
//   recomputes the shared-memory plan at each launch and refuses one that
//   disagrees. The grid is persistent: G resident blocks walk the (period,
//   stock tile) cells, and per cell a block walks the S members in ascending
//   order (one step each), so the member sum stays in the block: no float
//   atomics and no partial buffers.
// * The cell's panel tile [F][tile] arrives once by cp.async (16 bytes a copy
//   where N is a multiple of 4, else 4), and every member reads it from
//   shared memory: into one of two buffers while the previous cell computes,
//   or, with one buffer, once the cell's last member has read its tile. The
//   members' weights stay resident across the block's cells where they fit
//   with the tiles; else step k + 1's weights arrive by cp.async into the
//   second of two buffers while step k computes, or, with one buffer, at the
//   start of step k + 1. Each step's zp row, g row and dropout row hashes are
//   staged a step ahead. One buffer of each lets more blocks share an SM
//   (f32 at the paper's widths: three of 4 warps, not two), and the other
//   blocks compute while one waits for its weights; the plan weighs it.
// * Route 0 (f32, and bf16 where pad16(F) > 64): every product in register
//   tiles of 8 units × 4 stocks per thread, activations and dh_pre in
//   shared-memory tiles [units][tile]: a loaded float4 of weights feeds 16
//   FMAs. Where a product reads its weights along the reduction (W_l in the
//   forward, K1 in dx), a thread loads four reduction steps' weights for
//   each of its 8 units, then the 4 operand float4s, keeping the order of
//   every chain. The dh chain runs in place: dh_pre of layer l overwrites its
//   activation tile (a post-dropout activation is > 0 exactly where the
//   factor is on), and the last layer's epilogue writes dh_pre directly. A
//   thread's dx tile (6 features × 4 stocks) stays in registers across all
//   S members.
//   Every f32 output keeps the chain of the one-thread-per-stock kernel this
//   replaced, so it is bit for bit the same: the first layer is an fmaf chain
//   over f = 0..F-1 from 0, then + zp; a later layer one over its padded
//   inputs j = 0..hp-1 from 0, then + b; dh = kout·g; dh_{l-1}[i] one over the
//   units j = 0..h_l-1 from 0; each member's dx[f] one over j = 0..hp0-1
//   from 0, added to the running dx in member order. Only the thread that
//   computes a chain moved.
// * Route 1 (bf16, pad16(F) ≤ 64). The backward uses ReLU's derivative, a
//   step: a pre-activation that a sum in another order moves across 0 by an
//   ulp flips its factor and moves a whole term of dx (5% of max|dx| in a
//   CPU experiment at S = 3, T = 8, N = 10,007). So the decisions are the
//   plain version's, bit for bit: the layers below the top run on the CUDA
//   cores as route 0 does (the same chains on bf16 operands, the weights
//   read from bf16 rows), and their tiles hold the exact activations. The
//   rest runs per warp of 16 stocks on mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators): the top layer W·round(a) with its A fragments built from
//   the tile, each decision certified (where |h| is within kCertify of the
//   sum's magnitude bound of 0, the lane recomputes the exact chain, about
//   3 in 10,000 elements), then W_lᵀ·dh_pre and K1·dh1_pre. A prologue
//   kernel turns each member's packed weights into the image a block
//   stages: K1 [pad16(F)][W] and each W_l [W][W] as bf16 rows, every layer
//   padded to the library's width bound W; ldmatrix reads the B fragments
//   of one product from a row set, ldmatrix.trans those of its transpose.
//   kout·g is a per-stock scale in the top layer's epilogue, each product's
//   C fragments are repacked as the next one's A fragments, the factors
//   below the top come from the exact tiles, and the dx fragments stay in
//   registers across the members. Sums run in a fixed order, so two calls
//   give bitwise-equal dx.
//
// The audit build (-DSDF_FFN_DX_AUDIT, its own library) is this file with
// one addition: route 1 also computes the exact chain of EVERY top-layer
// element and counts, per launch, in a small device buffer: the elements,
// those certified (recomputed), those whose mma sum and exact chain differ
// in sign, how many of those lie outside the certified window, and the
// largest |mma − chain| / (max|a|·Σ|W| + |b|). Its dx is the main
// library's, bit for bit: the audit only reads.
//
// compute_dtype bfloat16 rounds both operands of every product (kout·g,
// Wᵀ·dh_pre, K1·dh1_pre, the forward's); the weights arrive rounded.
// Stocks past N read x = 0 and g = 0 and write nothing.
//
// Each kernel has a float and a bf16-panel instance (panel.cuh): the latter
// stores its panel tiles widened into the same f32 tiles, with ordinary
// loads in place of the cp.async copies, and writes dx in bf16, the f32
// sum of the members rounded once.

#include <limits.h>

#include "panel.cuh"
#include "sdf_ffn_common.cuh"

#ifndef SDF_FFN_MAXW
#define SDF_FFN_MAXW 64
#endif

namespace {

using sdf_ffn::cp_async16;
using sdf_ffn::cp_async4;
using sdf_ffn::cp_async_commit;
using sdf_ffn::cp_async_wait;
using sdf_ffn::Dropout;
using sdf_ffn::FfnDims;
using sdf_ffn::kMaxLayers;
using sdf_ffn::kUnsupported;
using sdf_ffn::ldsm_x4;
using sdf_ffn::ldsm_x4_t;
using sdf_ffn::mma_bf16;
using sdf_ffn::pack_bf16;
using sdf_ffn::round_bf16;

constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kRouteCores = 0, kRouteMma = 1;
constexpr int kTu = 8, kTs = 4;  // CUDA-core register tile: units × stocks
constexpr int kDf = 6;  // route 0's dx tile: features × kTs stocks
constexpr int kMaxThreads = 256;
constexpr int kMmaMaxF = 64;  // route 1: a warp's dx fragments in registers
// route 1 recomputes a top-layer pre-activation as the exact chain where
// |h| ≤ kCertify·(max|a|·Σ|W| + |b|) + kCertifyFloor: at least eight times
// what an mma accumulation can move it from the chain (about 2^-19 of that
// magnitude over a 64-deep sum, the chain's own rounding included)
constexpr float kCertify = 1.0f / 65536.0f;
constexpr float kCertifyFloor = 1e-30f;

__host__ __device__ inline int pad4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int pad8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// the 32-bit-word stride of a shared row of kp bf16 values (kp a multiple
// of 16): kp/2 + 4 ≡ 4 (mod 8), so 8 rows × 4 words of a fragment hit 32
// distinct banks, straight or transposed
__host__ __device__ constexpr int row_words(int kp) { return kp / 2 + 4; }

// Shared-memory plan (32-bit words) of one block.
struct DxSmem {
  int x, xbufs;               // xbufs panel tiles [F][tile]
  int act, acts, hrows, ast;  // `acts` activation tiles [hrows][ast]
  int zp, zw;                 // two zp rows of zw words
  int g, rowh;                // two g rows, two rows of dropout row hashes
  int w, wwords, wbufs;       // weight buffers: wbufs of wwords words
  // route 1, offsets in a member's image: K1 and W_l as bf16 rows of rw
  // words; the f32 rows b_l, kout and Σ_i |W_top[k][i]|
  int rw, k1, wl[kMaxLayers], bl[kMaxLayers], kout, wabs;
  int total;
};

// route 0: a weight buffer's words, the packed layout plus what the register
// tiles read past it (their rows padded to kDf features in dx, to 8 units
// elsewhere): K1 as rows f < F padded to kDf (dx) and as columns <
// pad8(hp0) (layer 0), each W_l as rows < pad8(h_l) (the
// forward) and columns < pad8(hp_{l-1}) (dh). What they read there lands in
// outputs that are never stored.
int core_wwords(const FfnDims& d) {
  const int hp0 = d.hp[0];
  int end = d.P;
  end = imax(end, cdiv(d.F, kDf) * kDf * hp0);
  end = imax(end, (d.F - 1) * hp0 + pad8(hp0));
  for (int l = 1; l < d.n_hidden; ++l) {
    const int hin = d.hp[l - 1];
    end = imax(end, d.off_w[l] + pad8(d.h[l]) * hin);
    end = imax(end, d.off_w[l] + (d.h[l] - 1) * hin + pad8(hin));
  }
  return pad4(end);
}

DxSmem smem_plan(const FfnDims& d, int route, int tile, int wbufs,
                 int xbufs) {
  DxSmem m{};
  const int L = d.n_hidden;
  constexpr int W = SDF_FFN_MAXW;
  if (route == kRouteCores) {
    m.wwords = core_wwords(d);
    m.acts = L;
    m.hrows = 0;
    for (int l = 0; l < L; ++l) m.hrows = imax(m.hrows, pad8(d.hp[l]));
    m.ast = tile;
    m.zw = pad8(d.hp[0]);
  } else {
    // every layer padded to the library's width bound W
    m.rw = row_words(W);
    int mo = 0;
    m.k1 = 0;
    mo += pad16(d.F) * m.rw;
    for (int l = 1; l < L; ++l) {
      m.wl[l] = mo;
      mo += W * m.rw;
    }
    for (int l = 1; l < L; ++l) {
      m.bl[l] = mo;
      mo += W;
    }
    m.kout = mo;
    mo += W;
    m.wabs = mo;
    mo += W;
    m.wwords = pad4(mo);
    m.acts = L > 1 ? L - 1 : 1;  // the layers below the top (L = 1: dh_pre)
    m.hrows = W;
    m.ast = tile + 4;  // rows 4 banks apart: conflict-free A fragments
    m.zw = W;
  }
  int o = 0;
  m.x = o;
  m.xbufs = xbufs;
  o += xbufs * d.F * tile;
  m.act = o;
  o += m.acts * m.hrows * m.ast;
  m.zp = o;
  o += 2 * m.zw;
  m.g = o;
  o += 2 * tile;
  m.rowh = o;
  o += 2 * tile;
  m.wbufs = wbufs;
  m.w = o;
  o += wbufs * m.wwords;
  m.total = o;
  return m;
}

// -- staging -----------------------------------------------------------------

struct Cell {
  int t, n0;
};

__device__ __forceinline__ Cell cell_at(int c, int tiles, int tile) {
  return Cell{c / tiles, c % tiles * tile};
}

// start copying `words` words (a multiple of 4, 16-byte aligned at both
// ends) from global to shared memory, 16 bytes a copy
__device__ __forceinline__ void copy_words(float* dst, const float* src,
                                           int words) {
  for (int i = 4 * threadIdx.x; i < words; i += 4 * blockDim.x)
    cp_async16(dst + i, src + i, 16);
}

// start the copies of `rows` rows of stocks n0 .. n0 + tile (row r at src +
// r·N) into dst (rows `tile` words apart), stocks past N zero-filled: 16
// bytes a copy where N is a multiple of 4 (every row then starts 16-byte
// aligned), else 4
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int n0, int N, int tile) {
  if ((N & 3) == 0) {
    const int q = tile / 4;
    for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      const int left = N - n0 - c;
      cp_async16(dst + r * tile + c,
                 left > 0 ? src + (size_t)r * N + n0 + c : src,
                 left >= 4 ? 16 : left > 0 ? 4 * left : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * tile; i += blockDim.x) {
    const int r = i / tile, c = i % tile;
    const bool ok = n0 + c < N;
    cp_async4(dst + r * tile + c, ok ? src + (size_t)r * N + n0 + c : src,
              ok);
  }
}

// start the copies of period t's panel tile [F][tile] (stocks n0 ..) into
// dst: cp.async from an f32 panel; from a bf16 one, stored widened now
template <typename PX>
__device__ __forceinline__ void load_panel(float* dst, const PX* x, int t,
                                           int F, int n0, int N, int tile) {
  const PX* xt = x + (size_t)t * F * N;
  if constexpr (panel::kBf16<PX>)
    panel::stage_bf16(dst, tile, xt + n0, N, F, tile, N - n0);
  else
    load_rows(dst, xt, F, n0, N, tile);
}

// Stage step (c, s), member s of cell c, into parity p: the member's
// weights (when streamed), its zp row, its g row and (with dropout) the
// row hashes of the cell's stocks.
__device__ __forceinline__ void stage_step(float* sm, const DxSmem& m,
                                           const float* weights, int wwords,
                                           const float* zp, const float* g,
                                           int c, int s, int p, int T, int N,
                                           int h0, int tile, bool resident,
                                           const Dropout& drop) {
  const Cell cl = cell_at(c, (N + tile - 1) / tile, tile);
  if (!resident)
    copy_words(sm + m.w + p * m.wwords, weights + (size_t)s * wwords, wwords);
  const float* zs = zp + ((size_t)s * T + cl.t) * h0;
  float* zd = sm + m.zp + p * m.zw;
  for (int i = threadIdx.x; i < m.zw; i += blockDim.x)
    cp_async4(zd + i, i < h0 ? zs + i : zp, i < h0);
  load_rows(sm + m.g + p * tile, g + ((size_t)s * T + cl.t) * N, 1, cl.n0, N,
            tile);
  if (drop.on) {
    uint32_t* rh = reinterpret_cast<uint32_t*>(sm + m.rowh + p * tile);
    const uint32_t base = drop.member_base[s];
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
      rh[i] = sdf_ffn::row_hash(base, cl.t, drop.offset + cl.n0 + i);
  }
}

// -- the CUDA-core products ---------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[kTs]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <bool RND>
__device__ __forceinline__ void in4(float (&v)[kTs], const float* p) {
  const float4 a = ld4(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  if constexpr (RND) {
#pragma unroll
    for (int s = 0; s < kTs; ++s) v[s] = round_bf16(v[s]);
  }
}

// two bf16 values of a word as f32 (exact): the lower index in the low half
__device__ __forceinline__ void unpack2(uint32_t v, float& lo, float& hi) {
  lo = __uint_as_float(v << 16);
  hi = __uint_as_float(v & 0xffff0000u);
}

// 8 and 4 consecutive weights as f32, from f32 or bf16 rows
__device__ __forceinline__ void w8(float (&w)[8], const float* p) {
  const float4 a = ld4(p), b = ld4(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void w8(float (&w)[8], const __nv_bfloat16* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  unpack2(q.x, w[0], w[1]);
  unpack2(q.y, w[2], w[3]);
  unpack2(q.z, w[4], w[5]);
  unpack2(q.w, w[6], w[7]);
}
__device__ __forceinline__ void w4(float (&w)[4], const float* p) {
  const float4 a = ld4(p);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
}
__device__ __forceinline__ void w4(float (&w)[4], const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  unpack2(q.x, w[0], w[1]);
  unpack2(q.y, w[2], w[3]);
}

// acc[u][s] = Σ_r A(u, r)·in[r][s] for r = 0..R-1 in order, each an fmaf
// chain from 0, for TU rows u. OR: A(u, r) = A[u·as + r] (rows along the
// reduction; R a multiple of 4: four steps' weights per row, then four
// operand float4s); else A(u, r) = A[r·as + u] (8 units' weights per step,
// TU = 8). `in` rows are `is` words apart; RND rounds its values to bf16.
template <bool OR, bool RND, typename WT, int TU = kTu>
__device__ __forceinline__ void tile_prod(float (&acc)[TU][kTs],
                                          const WT* __restrict__ A, int as,
                                          const float* __restrict__ in,
                                          int is, int R) {
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int s = 0; s < kTs; ++s) acc[u][s] = 0.f;
  if constexpr (OR) {
#pragma unroll 1
    for (int r = 0; r < R; r += 4) {
      float w[TU][4];
#pragma unroll
      for (int u = 0; u < TU; ++u) w4(w[u], A + u * as + r);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[kTs];
        in4<RND>(v, in + (r + q) * is);
#pragma unroll
        for (int u = 0; u < TU; ++u)
#pragma unroll
          for (int s = 0; s < kTs; ++s)
            acc[u][s] = fmaf(w[u][q], v[s], acc[u][s]);
      }
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float wv[kTu];
      w8(wv, A + r * as);
      float v[kTs];
      in4<RND>(v, in + r * is);
#pragma unroll
      for (int u = 0; u < kTu; ++u)
#pragma unroll
        for (int s = 0; s < kTs; ++s) acc[u][s] = fmaf(wv[u], v[s], acc[u][s]);
    }
  }
}

// One forward layer l on the CUDA cores: out[k][s] (rows `os` words apart)
// for the tile's units k < units8, in 8 × 4 register tiles: h = Σ +
// bias[k] (0 past hl), then the post-dropout activation on ? h·dscale : 0,
// unrounded (a > 0 exactly where the factor is on), or, in the last layer
// (top), its dh_pre on ? (kout[k]·g[s])·dscale : 0, rounded to bf16 with RB
// (bf16 operands, g among them). OR, the A layout and RND (round `in`) as in
// tile_prod; A points at unit 0, reduction step 0; `in` rows are `is` words
// apart.
template <bool OR, bool RND, bool RB, typename WT>
__device__ void core_layer(const WT* __restrict__ A, int as,
                           const float* __restrict__ in, int is, int R,
                           float* __restrict__ out, int os, int tile,
                           int units8, int hl, const float* __restrict__ bias,
                           int l, bool top, const float* __restrict__ ko,
                           const float* __restrict__ gs,
                           const uint32_t* __restrict__ rowh,
                           const Dropout& drop, float dscale) {
  const int groups = tile / kTs;
  const int ntile = units8 / kTu * groups;
  for (int it = threadIdx.x; it < ntile; it += blockDim.x) {
    const int k0 = it / groups * kTu, s0 = it % groups * kTs;
    float acc[kTu][kTs];
    tile_prod<OR, RND>(acc, A + (OR ? k0 * as : k0), as, in + s0, is, R);
    uint32_t rows[kTs] = {0u, 0u, 0u, 0u};
    if (drop.on) {
      const uint4 r = *reinterpret_cast<const uint4*>(rowh + s0);
      rows[0] = r.x;
      rows[1] = r.y;
      rows[2] = r.z;
      rows[3] = r.w;
    }
    float gv[kTs] = {0.f, 0.f, 0.f, 0.f};
    if (top) in4<RB>(gv, gs + s0);
#pragma unroll
    for (int u = 0; u < kTu; ++u) {
      const int k = k0 + u;
      const float bk = k < hl ? bias[k] : 0.f;
      float v[kTs];
#pragma unroll
      for (int s = 0; s < kTs; ++s) {
        const float h = k < hl ? acc[u][s] + bk : 0.f;
        const bool on =
            h > 0.f && (!drop.on ||
                        sdf_ffn::keep_unit(rows[s], l, k, drop.threshold));
        if (top) {
          const float dp = on ? ko[k] * gv[s] * dscale : 0.f;
          v[s] = RB ? round_bf16(dp) : dp;
        } else {
          v[s] = on ? h * dscale : 0.f;
        }
      }
      st4(out + k * os + s0, v);
    }
  }
}

// -- route 0: CUDA cores ------------------------------------------------------

// One step of the dh chain, l → l - 1, in place: io[i][s] holds layer
// l - 1's activations and receives its dh_pre = (a > 0) ? (Σ_{j < hl}
// W_l[j][i]·in[j][s])·dscale : 0 (rounded to bf16 with RB); `in` holds layer
// l's dh_pre.
template <bool RB>
__device__ void core_back(const float* __restrict__ Wl, int hin, int hl,
                          const float* __restrict__ in, float* io, int tile,
                          float dscale) {
  const int groups = tile / kTs;
  const int ntile = pad8(hin) / kTu * groups;
  for (int it = threadIdx.x; it < ntile; it += blockDim.x) {
    const int i0 = it / groups * kTu, s0 = it % groups * kTs;
    float acc[kTu][kTs];
    tile_prod<false, false>(acc, Wl + i0, hin, in + s0, tile, hl);
#pragma unroll
    for (int u = 0; u < kTu; ++u) {
      float* p = io + (i0 + u) * tile + s0;
      float a[kTs];
      in4<false>(a, p);
      float v[kTs];
#pragma unroll
      for (int s = 0; s < kTs; ++s) {
        const float dp = a[s] > 0.f ? acc[u][s] * dscale : 0.f;
        v[s] = RB ? round_bf16(dp) : dp;
      }
      st4(p, v);
    }
  }
}

// RB: bf16 operands (the panel, the activations, g) on the CUDA cores, for F
// beyond the tensor-core route
template <bool RB, typename PX>
__global__ void __launch_bounds__(kMaxThreads, 1)
sdf_ffn_dx_cores_kernel(const PX* __restrict__ x,
                        const float* __restrict__ zp,
                        const float* __restrict__ params,
                        const float* __restrict__ g, PX* __restrict__ dx,
                        int S, int T, int N, int tile, int cells, FfnDims d,
                        DxSmem m, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int F = d.F, L = d.n_hidden, h0 = d.h[0], hp0 = d.hp[0];
  const int tiles = (N + tile - 1) / tile;
  const int groups = tile / kTs;
  const int G = gridDim.x;
  const bool resident = m.wbufs == S;
  const bool single = !resident && m.wbufs == 1;  // refilled every step
  const float dscale = drop.on ? drop.scale : 1.f;
  const int tsize = m.hrows * tile;  // one activation tile
  float* const act = sm + m.act;
  // this thread's dx tile (kDf features df0 .., stocks ds0 ..), if it has
  // one: 6 rows, so that at F = 46 every thread of a 4-warp block has one
  const bool has_dx = tid < cdiv(F, kDf) * groups;
  const int df0 = tid / groups * kDf, ds0 = tid % groups * kTs;
  auto load_x = [&](int c, int b) {
    const Cell cl = cell_at(c, tiles, tile);
    load_panel(sm + m.x + b * F * tile, x, cl.t, F, cl.n0, N, tile);
  };

  int c = blockIdx.x;
  if (resident)
    for (int s = 0; s < S; ++s)
      copy_words(sm + m.w + s * m.wwords, params + (size_t)s * d.P, d.P);
  stage_step(sm, m, params, d.P, zp, g, c, 0, 0, T, N, h0, tile,
             resident || single, drop);
  load_x(c, 0);
  cp_async_commit();
  int k = 0;  // the block's steps so far
  for (int it = 0; c < cells; c += G, ++it) {
    const Cell cl = cell_at(c, tiles, tile);
    float* const xs = sm + m.x + (m.xbufs == 2 ? it & 1 : 0) * F * tile;
    float dxa[kDf][kTs];
#pragma unroll
    for (int u = 0; u < kDf; ++u)
#pragma unroll
      for (int s = 0; s < kTs; ++s) dxa[u][s] = 0.f;
    for (int s = 0; s < S; ++s, ++k) {
      const int p = k & 1;
      cp_async_wait<0>();
      __syncthreads();  // step k's copies landed; step k - 1 is done
      if (single) {
        copy_words(sm + m.w, params + (size_t)s * d.P, d.P);
        cp_async_commit();
      }
      // stage step k + 1 and, at a cell's first member, the next cell's
      // panel tile, into the buffers step k - 1 used
      {
        const bool last = s + 1 == S;
        if (!last || c + G < cells)
          stage_step(sm, m, params, d.P, zp, g, last ? c + G : c,
                     last ? 0 : s + 1, p ^ 1, T, N, h0, tile,
                     resident || single, drop);
        if (m.xbufs == 2 && s == 0 && c + G < cells)
          load_x(c + G, (it + 1) & 1);
        cp_async_commit();
      }
      if (single) {
        cp_async_wait<1>();  // member s's weights (step k + 1's may fly)
        __syncthreads();
      }
      const float* W = sm + m.w + (resident ? s : single ? 0 : p) * m.wwords;
      const float* gs = sm + m.g + p * tile;
      const uint32_t* rh = reinterpret_cast<const uint32_t*>(
          sm + m.rowh + p * tile);

      // -- the forward, layer 0 from the panel tile ----------------------
      core_layer<false, RB, RB>(W, hp0, xs, tile, F, act, tile, tile,
                                pad8(hp0), h0, sm + m.zp + p * m.zw, 0,
                                L == 1, W + d.off_kout, gs, rh, drop,
                                dscale);
      __syncthreads();
      if (m.xbufs == 1 && s == S - 1 && c + G < cells) {  // the tile is read
        load_x(c + G, 0);
        cp_async_commit();
      }
      for (int l = 1; l < L; ++l) {
        core_layer<true, RB, RB>(W + d.off_w[l], d.hp[l - 1],
                                 act + (l - 1) * tsize, tile, d.hp[l - 1],
                                 act + l * tsize, tile, tile, pad8(d.hp[l]),
                                 d.h[l], W + d.off_b[l], l, l == L - 1,
                                 W + d.off_kout, gs, rh, drop, dscale);
        __syncthreads();
      }
      // -- the dh chain, in place over the activation tiles --------------
      for (int l = L - 1; l >= 1; --l) {
        core_back<RB>(W + d.off_w[l], d.hp[l - 1], d.h[l], act + l * tsize,
                      act + (l - 1) * tsize, tile, dscale);
        __syncthreads();
      }
      // -- dx += K1 · dh1_pre ------------------------------------------------
      if (has_dx) {
        float acc[kDf][kTs];
        tile_prod<true, false, float, kDf>(acc, W + df0 * hp0, hp0, act + ds0,
                                           tile, hp0);
#pragma unroll
        for (int u = 0; u < kDf; ++u)
#pragma unroll
          for (int s2 = 0; s2 < kTs; ++s2) dxa[u][s2] += acc[u][s2];
      }
    }
    if (has_dx) {
      const int n = cl.n0 + ds0;
#pragma unroll
      for (int u = 0; u < kDf; ++u) {
        const int f = df0 + u;
        if (f >= F) continue;
        PX* o = dx + ((size_t)cl.t * F + f) * N + n;
        if (!panel::kBf16<PX> && (N & 3) == 0 && n + kTs <= N) {
          st4(reinterpret_cast<float*>(o), dxa[u]);
        } else {
#pragma unroll
          for (int s = 0; s < kTs; ++s)
            if (n + s < N) panel::st(o + s, dxa[u][s]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// -- route 1: tensor cores ----------------------------------------------------

// k step kk's A fragments (16 stocks × 16 units, rounded to bf16) from an f32
// tile [unit][stock] (rows st words apart; t at this thread's stock r0);
// am0, am1 take the largest |value| seen of stocks r0 and r0 + 8
__device__ __forceinline__ void tile_frag(uint32_t (&a)[4], const float* t,
                                          int kk, int tig, int st, float& am0,
                                          float& am1) {
  const float* p = t + (16 * kk + 2 * tig) * st;
  const float v0 = p[0], v1 = p[st], v2 = p[8], v3 = p[st + 8];
  const float v4 = p[8 * st], v5 = p[9 * st], v6 = p[8 * st + 8],
              v7 = p[9 * st + 8];
  a[0] = pack_bf16(v0, v1);  // stock r0, units 2·tig, + 1
  a[1] = pack_bf16(v2, v3);  // stock r0 + 8
  a[2] = pack_bf16(v4, v5);  // units 2·tig + 8, + 9
  a[3] = pack_bf16(v6, v7);
  am0 = fmaxf(am0, fmaxf(fmaxf(fabsf(v0), fabsf(v1)),
                         fmaxf(fabsf(v4), fabsf(v5))));
  am1 = fmaxf(am1, fmaxf(fmaxf(fabsf(v2), fabsf(v3)),
                         fmaxf(fabsf(v6), fabsf(v7))));
}

// acc[j] += A · B over tile pairs, B stored with its n as rows (k along a
// row; rows RW words apart): one ldmatrix.x4 gives the B fragments of tiles
// j and j + 1 at one k step (lane l addresses row 8·(l / 16) + l % 8 of the
// pair, k half (l / 8) % 2); b points at this lane's row and k half of
// tile 0
template <int NT, int RW>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4],
                                        const uint32_t (&a)[4],
                                        const uint32_t* b) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t q[4];
    ldsm_x4(q, b + 8 * j * RW);
    mma_bf16(acc[j], a, q[0], q[1]);
    mma_bf16(acc[j + 1], a, q[2], q[3]);
  }
}

// the same with B stored with its k as rows (n along a row), read through
// ldmatrix.trans: lane l addresses k row 8·((l / 8) % 2) + l % 8 of the k
// step and the 8 columns of tile j + l / 16; b points there for tile 0
template <int NT>
__device__ __forceinline__ void mma_row_t(float (&acc)[NT][4],
                                          const uint32_t (&a)[4],
                                          const uint32_t* b) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t q[4];
    ldsm_x4_t(q, b + 4 * j);
    mma_bf16(acc[j], a, q[0], q[1]);
    mma_bf16(acc[j + 1], a, q[2], q[3]);
  }
}

// k step kk's A fragments from packed C fragments (tiles 2kk and 2kk + 1)
template <int NT>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const uint32_t (&pk)[NT][2], int kk) {
  a[0] = pk[2 * kk][0];
  a[1] = pk[2 * kk][1];
  a[2] = pk[2 * kk + 1][0];
  a[3] = pk[2 * kk + 1][1];
}

// the top layer's dh_pre of one element from its ReLU decision: round(kout)
// · round(g) · the dropout scale where the unit is on and kept, else 0
__device__ __forceinline__ float top_dh(bool pos, uint32_t row, int l,
                                       int unit, float ko, float gr,
                                       const Dropout& drop, float dscale) {
  const bool on = pos && (!drop.on || sdf_ffn::keep_unit(row, l, unit,
                                                         drop.threshold));
  return on ? ko * gr * dscale : 0.f;
}

// the plain version's pre-activation sum of one unit and stock, less its
// bias: an fmaf chain over the inputs i = 0..hin-1 from 0, on the unit's
// bf16 weight row and the stock's activations (rows ast words apart),
// rounded to bf16 as the product sees them
__device__ __forceinline__ float exact_chain(const __nv_bfloat16* w,
                                            const float* a, int ast,
                                            int hin) {
  float h = 0.f;
#pragma unroll 4
  for (int i = 0; i < hin; ++i)
    h = fmaf(__bfloat162float(w[i]), round_bf16(a[i * ast]), h);
  return h;
}

#ifdef SDF_FFN_DX_AUDIT
// the audit's counters of the current launch (sdf_ffn_dx_audit_reset before
// it, sdf_ffn_dx_audit_read after): elements, certified, sign flips, flips
// outside the window, and the largest ratio as float bits (non-negative
// floats order as their bits)
__device__ unsigned long long g_dx_audit[5];

__device__ __forceinline__ void audit_add(unsigned seen, unsigned certified,
                                          unsigned flips, unsigned outside,
                                          float worst) {
  seen = __reduce_add_sync(0xffffffffu, seen);
  certified = __reduce_add_sync(0xffffffffu, certified);
  flips = __reduce_add_sync(0xffffffffu, flips);
  outside = __reduce_add_sync(0xffffffffu, outside);
  const unsigned wbits = __reduce_max_sync(0xffffffffu, __float_as_uint(worst));
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_dx_audit[0], (unsigned long long)seen);
    atomicAdd(&g_dx_audit[1], (unsigned long long)certified);
    atomicAdd(&g_dx_audit[2], (unsigned long long)flips);
    atomicAdd(&g_dx_audit[3], (unsigned long long)outside);
    atomicMax(&g_dx_audit[4], (unsigned long long)wbits);
  }
}
#endif

// member s's image from its packed weights (bf16-exact already, so the
// conversion is exact): K1 as rows f of units j, each W_l as rows of its
// units j holding their inputs i, zero wherever a layer is narrower than W;
// then b_l, kout and the top layer's Σ_i |W[k][i]| in f32
__global__ void sdf_ffn_dx_image_kernel(const float* __restrict__ params,
                                        uint32_t* __restrict__ img, FfnDims d,
                                        DxSmem m) {
  const int tid = threadIdx.x, nth = blockDim.x, L = d.n_hidden;
  const float* p = params + (size_t)blockIdx.x * d.P;
  uint32_t* out = img + (size_t)blockIdx.x * m.wwords;
  float* fo = reinterpret_cast<float*>(out);
  for (int i = tid; i < m.wwords; i += nth) out[i] = 0u;
  __syncthreads();
  const int h0 = d.h[0];
  __nv_bfloat16* k1 = reinterpret_cast<__nv_bfloat16*>(out + m.k1);
  for (int i = tid; i < d.F * h0; i += nth) {
    const int f = i / h0, j = i % h0;
    k1[f * 2 * m.rw + j] = __float2bfloat16_rn(p[f * d.hp[0] + j]);
  }
  for (int l = 1; l < L; ++l) {
    const int hin = d.h[l - 1];
    __nv_bfloat16* wl = reinterpret_cast<__nv_bfloat16*>(out + m.wl[l]);
    for (int i = tid; i < d.h[l] * hin; i += nth) {
      const int j = i / hin, ii = i % hin;
      wl[j * 2 * m.rw + ii] =
          __float2bfloat16_rn(p[d.off_w[l] + j * d.hp[l - 1] + ii]);
    }
    for (int u = tid; u < d.h[l]; u += nth) fo[m.bl[l] + u] = p[d.off_b[l] + u];
    if (l == L - 1)
      for (int u = tid; u < d.h[l]; u += nth) {
        float a = 0.f;
        for (int i = 0; i < hin; ++i)
          a += fabsf(p[d.off_w[l] + u * d.hp[l - 1] + i]);
        fo[m.wabs + u] = a;
      }
  }
  for (int u = tid; u < d.h[L - 1]; u += nth)
    fo[m.kout + u] = p[d.off_kout + u];
}

// Route 1. The layers below the top run on the CUDA cores as route 0 does
// (exact f32 chains on bf16 operands, weights read from the image's bf16
// rows): their ReLU and rounding decisions are then the plain version's,
// bit for bit, which a sum in another order cannot promise (a factor that
// flips moves a whole term of dx). Then each warp takes 16 stocks through
// the tensor cores: the top layer's product, its decisions certified
// against the exact chain, the dh chain and dx. KX: pad16(F) / 16 (≤ 4),
// so dx has 2·KX n tiles of 8 features.
template <int MAXW, int KX, typename PX>
__global__ void __launch_bounds__(kMaxThreads, 1)
sdf_ffn_dx_mma_kernel(const PX* __restrict__ x,
                      const float* __restrict__ zp,
                      const uint32_t* __restrict__ img,
                      const float* __restrict__ g, PX* __restrict__ dx,
                      int S, int T, int N, int tile, int cells, FfnDims d,
                      DxSmem m, Dropout drop) {
  constexpr int NT = MAXW / 8;   // accumulator tiles of 8 units
  constexpr int KT = MAXW / 16;  // 16-deep k steps over a hidden layer
  constexpr int NF = 2 * KX;     // dx tiles of 8 features
  constexpr int rw = row_words(MAXW);  // = m.rw
  extern __shared__ float4 smem4[];
  float* smf = reinterpret_cast<float*>(smem4);
  uint32_t* smw = reinterpret_cast<uint32_t*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int F = d.F, L = d.n_hidden, h0 = d.h[0], hp0 = d.hp[0];
  const int tiles = (N + tile - 1) / tile;
  const int G = gridDim.x;
  const bool resident = m.wbufs == S;
  const bool single = !resident && m.wbufs == 1;  // refilled every step
  const float dscale = drop.on ? drop.scale : 1.f;
  const int ast = m.ast, tsize = m.hrows * ast;
  float* const act = smf + m.act;
  // units past a layer's width stay 0 in every activation tile
  for (int i = tid; i < m.acts * tsize; i += blockDim.x) act[i] = 0.f;
  const float* imgf = reinterpret_cast<const float*>(img);
  auto load_x = [&](int c, int b) {
    const Cell cl = cell_at(c, tiles, tile);
    load_panel(smf + m.x + b * F * tile, x, cl.t, F, cl.n0, N, tile);
  };

  int c = blockIdx.x;
  if (resident)
    for (int s = 0; s < S; ++s)
      copy_words(smf + m.w + s * m.wwords, imgf + (size_t)s * m.wwords,
                 m.wwords);
  stage_step(smf, m, imgf, m.wwords, zp, g, c, 0, 0, T, N, h0, tile,
             resident || single, drop);
  load_x(c, 0);
  cp_async_commit();
  const int r0 = warp * 16 + gid;  // this thread's stocks: r0, r0 + 8
  // the lane's ldmatrix row and k half (mma_row), and k row and column
  // block (mma_row_t)
  const int lrow = 8 * (lane >> 4) + (lane & 7), lk = 4 * ((lane >> 3) & 1);
  const int trow = 8 * ((lane >> 3) & 1) + (lane & 7), tcol = 4 * (lane >> 4);
  int k = 0;
  for (int it = 0; c < cells; c += G, ++it) {
    const Cell cl = cell_at(c, tiles, tile);
    float* const xs = smf + m.x + (m.xbufs == 2 ? it & 1 : 0) * F * tile;
    float dxa[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[j][e] = 0.f;
    for (int s = 0; s < S; ++s, ++k) {
      const int p = k & 1;
      cp_async_wait<0>();
      __syncthreads();  // step k's copies landed; step k - 1 is done
      if (single) {
        copy_words(smf + m.w, imgf + (size_t)s * m.wwords, m.wwords);
        cp_async_commit();
      }
      {
        const bool last = s + 1 == S;
        if (!last || c + G < cells)
          stage_step(smf, m, imgf, m.wwords, zp, g, last ? c + G : c,
                     last ? 0 : s + 1, p ^ 1, T, N, h0, tile,
                     resident || single, drop);
        if (m.xbufs == 2 && s == 0 && c + G < cells)
          load_x(c + G, (it + 1) & 1);
        cp_async_commit();
      }
      if (single) {
        cp_async_wait<1>();  // member s's image (step k + 1's rows may fly)
        __syncthreads();
      }
      const uint32_t* wm =
          smw + m.w + (resident ? s : single ? 0 : p) * m.wwords;
      const float* fm = reinterpret_cast<const float*>(wm);
      const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(wm);
      const float* gs = smf + m.g + p * tile;
      const uint32_t* rh = reinterpret_cast<const uint32_t*>(
          smf + m.rowh + p * tile);

      if (s == 0) {  // the cell's panel tile, rounded once for its members
        for (int i = tid; i < F * tile; i += blockDim.x)
          xs[i] = round_bf16(xs[i]);
        __syncthreads();
      }
      // -- the layers below the top, exact, on the CUDA cores -------------
      core_layer<false, false, true>(wb + 2 * m.k1, 2 * rw, xs, tile, F,
                                     act, ast, tile, pad8(hp0), h0,
                                     smf + m.zp + p * m.zw, 0, L == 1,
                                     fm + m.kout, gs, rh, drop, dscale);
      for (int l = 1; l < L - 1; ++l) {
        __syncthreads();
        core_layer<true, true, true>(wb + 2 * m.wl[l], 2 * rw,
                                     act + (l - 1) * tsize, ast, d.hp[l - 1],
                                     act + l * tsize, ast, tile,
                                     pad8(d.hp[l]), d.h[l], fm + m.bl[l], l,
                                     false, fm + m.kout, gs, rh, drop,
                                     dscale);
      }
      __syncthreads();
      if (m.xbufs == 1 && s == S - 1 && c + G < cells) {  // the tile is read
        load_x(c + G, 0);
        cp_async_commit();
      }

      // -- the rest per warp, on the tensor cores --------------------------
      const float gr[2] = {round_bf16(gs[r0]), round_bf16(gs[r0 + 8])};
      float acc[NT][4];
      uint32_t pk[NT][2];
      if (L > 1) {
        // the top layer: h = b + W·round(a) by mma; where |h| is within
        // the bound of 0, the exact chain decides
        const int lt = L - 1;
        const float* ain = act + (lt - 1) * tsize + r0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              fm + m.bl[lt] + 8 * j + 2 * tig);
          acc[j][0] = acc[j][2] = b.x;
          acc[j][1] = acc[j][3] = b.y;
        }
        float am[2] = {0.f, 0.f};
        const uint32_t* bt = wm + m.wl[lt] + lrow * rw + lk;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t a[4];
          tile_frag(a, ain, kk, tig, ast, am[0], am[1]);
          mma_row<NT, rw>(acc, a, bt + 8 * kk);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the quad's lanes share the stocks
          am[h] = fmaxf(am[h], __shfl_xor_sync(0xffffffffu, am[h], 1));
          am[h] = fmaxf(am[h], __shfl_xor_sync(0xffffffffu, am[h], 2));
        }
        uint32_t rows[2] = {0u, 0u};
        if (drop.on) {
          rows[0] = rh[r0];
          rows[1] = rh[r0 + 8];
        }
        // each factor by the sign of its mma sum; bit 4j + e of `need`
        // marks element e of tile j, whose sum is within the bound of 0
        constexpr int MW = (4 * NT + 31) / 32;
        uint32_t on[MW], need[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) on[w] = need[w] = 0u;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int unit = 8 * j + 2 * tig + (e & 1), bit = 4 * j + e;
            const float h = acc[j][e];
            const float bound =
                kCertify * (am[e >> 1] * fm[m.wabs + unit] +
                            fabsf(fm[m.bl[lt] + unit])) + kCertifyFloor;
            on[bit >> 5] |= (uint32_t)(h > 0.f) << (bit & 31);
            need[bit >> 5] |= (uint32_t)(fabsf(h) <= bound) << (bit & 31);
            v[e] = top_dh(h > 0.f, rows[e >> 1], lt, unit, fm[m.kout + unit],
                          gr[e >> 1], drop, dscale);
          }
          pk[j][0] = pack_bf16(v[0], v[1]);
          pk[j][1] = pack_bf16(v[2], v[3]);
        }
        const int hin = d.hp[lt - 1];
#ifdef SDF_FFN_DX_AUDIT
        {  // every element's exact chain beside its mma sum
          unsigned seen = 0, certified = 0, flips = 0, outside = 0;
          float worst = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int unit = 8 * j + 2 * tig + (e & 1), bit = 4 * j + e;
              if (unit >= d.h[lt] || cl.n0 + r0 + 8 * (e >> 1) >= N) continue;
              const float b = fm[m.bl[lt] + unit];
              const float exact =
                  exact_chain(wb + 2 * (m.wl[lt] + unit * rw),
                              ain + 8 * (e >> 1), ast, hin) + b;
              const float mag = am[e >> 1] * fm[m.wabs + unit] + fabsf(b);
              const bool flagged = (need[bit >> 5] >> (bit & 31)) & 1u;
              const bool flip = (acc[j][e] > 0.f) != (exact > 0.f);
              ++seen;
              certified += flagged;
              flips += flip;
              outside += flip && !flagged;
              if (mag > 0.f) worst = fmaxf(worst, fabsf(acc[j][e] - exact) / mag);
            }
          audit_add(seen, certified, flips, outside, worst);
        }
#endif
        // the exact chain decides the flagged elements; a decision it turns
        // round rewrites the element's bf16 half of its A fragment
#pragma unroll
        for (int w = 0; w < MW; ++w)
          for (uint32_t q = need[w]; q; q &= q - 1) {
            const int bit = 32 * w + __ffs(q) - 1, jt = bit >> 2, e = bit & 3;
            const int unit = 8 * jt + 2 * tig + (e & 1);
            const float h =
                exact_chain(wb + 2 * (m.wl[lt] + unit * rw),
                            ain + 8 * (e >> 1), ast, hin) +
                fm[m.bl[lt] + unit];
            if ((h > 0.f) == (((on[w] >> (bit & 31)) & 1u) != 0u)) continue;
            const bool hi = e >> 1;  // selected, not indexed: no local memory
            const __nv_bfloat16 b = __float2bfloat16_rn(
                top_dh(h > 0.f, hi ? rows[1] : rows[0], lt, unit,
                       fm[m.kout + unit], hi ? gr[1] : gr[0], drop, dscale));
            const uint32_t hb = __bfloat16_as_ushort(b);
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                if (j == jt && r == e >> 1)
                  pk[j][r] = e & 1 ? (pk[j][r] & 0xffffu) | hb << 16
                                   : (pk[j][r] & 0xffff0000u) | hb;
          }
      }
      // -- the dh chain: pk holds round(dh_pre) of layer l; W_l read
      //    transposed; the factors of layer l - 1 from its exact tile -------
      for (int l = L - 1; l >= 1; --l) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        const uint32_t* bt = wm + m.wl[l] + trow * rw + tcol;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t a[4];
          a_frag<NT>(a, pk, kk);
          mma_row_t<NT>(acc, a, bt + 16 * kk * rw);
        }
        const float* fac = act + (l - 1) * tsize + r0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int unit = 8 * j + 2 * tig + (e & 1);
            v[e] = fac[unit * ast + 8 * (e >> 1)] > 0.f ? acc[j][e] * dscale
                                                       : 0.f;
          }
          pk[j][0] = pack_bf16(v[0], v[1]);
          pk[j][1] = pack_bf16(v[2], v[3]);
        }
      }
      // -- dx += K1 · round(dh1_pre), K1 read straight; at L = 1 dh1_pre is
      //    in the tile the CUDA cores wrote ---------------------------------
      const uint32_t* bk1 = wm + m.k1 + lrow * rw + lk;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        if (L > 1) {
          a_frag<NT>(a, pk, kk);
        } else {
          float am0 = 0.f, am1 = 0.f;
          tile_frag(a, act + r0, kk, tig, ast, am0, am1);
        }
        mma_row<NF, rw>(dxa, a, bk1 + 8 * kk);
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 8 * j + 2 * tig + (e & 1);
        const int n = cl.n0 + r0 + 8 * (e >> 1);
        if (f < F && n < N)
          panel::st(dx + ((size_t)cl.t * F + f) * N + n, dxa[j][e]);
      }
  }
  cp_async_wait<0>();
}

// -- plans --------------------------------------------------------------------

// the kernel of `route` for F features (route 0's bf16-operand instance,
// route 1's by its dx tiles)
template <typename PX>
const void* kernel_of(int route, int bf16, int F) {
  if (route == kRouteCores)
    return bf16 ? (const void*)sdf_ffn_dx_cores_kernel<true, PX>
                : (const void*)sdf_ffn_dx_cores_kernel<false, PX>;
  switch (pad16(F) / 16) {
    case 1: return (const void*)sdf_ffn_dx_mma_kernel<SDF_FFN_MAXW, 1, PX>;
    case 2: return (const void*)sdf_ffn_dx_mma_kernel<SDF_FFN_MAXW, 2, PX>;
    case 3: return (const void*)sdf_ffn_dx_mma_kernel<SDF_FFN_MAXW, 3, PX>;
    default: return (const void*)sdf_ffn_dx_mma_kernel<SDF_FFN_MAXW, 4, PX>;
  }
}

// ... on an f32 (xb16 0) or bf16 (1) panel
const void* kernel_of(int route, int bf16, int F, int xb16) {
  return xb16 ? kernel_of<__nv_bfloat16>(route, bf16, F)
              : kernel_of<float>(route, bf16, F);
}

// 0 if the card takes `kern` at `threads` and `smem` bytes: resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers
// and local-memory bytes per thread; else a cudaError_t value. It opens the
// kernel to the block's full shared memory, which every launch of a plan
// checked here relies on.
int kernel_info(const void* kern, int threads, size_t smem, int* blocks,
                int* regs, int* local_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// 0 and the smem plan if (layout, route, tile, threads, weight buffers,
// smem bytes) is a plan this file takes for S members, else kUnsupported
int check_plan(const int* layout, int S, int bf16, int route, int tile,
               int threads, int wbufs, int xbufs, long long smem_bytes,
               FfnDims* d, DxSmem* m) {
  int maxw = 0;
  if (sdf_ffn::read_dims(layout, d, &maxw) != 0) return kUnsupported;
  if (maxw > SDF_FFN_MAXW || S < 1) return kUnsupported;
  if (!(wbufs == S || (wbufs == 2 && S > 2) || (wbufs == 1 && S > 1)) ||
      (xbufs != 1 && xbufs != 2))
    return kUnsupported;
  if (route == kRouteCores) {
    if ((tile != 32 && tile != 64 && tile != 128) ||
        (threads != 64 && threads != 128 && threads != 256) ||
        cdiv(d->F, kDf) * (tile / kTs) > threads)
      return kUnsupported;
  } else if (route == kRouteMma) {
    // warps of 16 stocks; the CUDA-core layers' 8 × 4 tiles fill them
    if (!bf16 || (tile != 32 && tile != 64 && tile != 128) ||
        threads != 2 * tile || pad16(d->F) > kMmaMaxF)
      return kUnsupported;
  } else {
    return kUnsupported;
  }
  *m = smem_plan(*d, route, tile, wbufs, xbufs);
  const long long smem = (long long)sizeof(float) * m->total;
  if (smem != smem_bytes || smem > (long long)kMaxSmem) return kUnsupported;
  return 0;
}

}  // namespace

// Registers per thread of the kernel `route` runs for F features (route 0
// with bf16 operands where `bf16`) on an f32 (xb16 0) or bf16 (1) panel.
extern "C" int sdf_ffn_dx_registers(int route, int bf16, int F, int xb16) {
  if ((route != kRouteCores && route != kRouteMma) || F < 1 ||
      (route == kRouteMma && pad16(F) > kMmaMaxF))
    return kUnsupported;
  int info[3] = {0, 0, 0};
  if (kernel_info(kernel_of(route, bf16, F, xb16), 128, 0, &info[0],
                  &info[1], &info[2]) != 0)
    return kUnsupported;
  return info[1];
}

// What the card makes of a plan: out = [resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
// local-memory bytes per thread] of its instance for an f32 (xb16 0) or
// bf16 (1) panel. Returns 0, a cudaError_t value, or -1 for a plan this
// file refuses.
extern "C" int sdf_ffn_dx_plan_info(const int* layout, int S, int bf16,
                                    int route, int tile, int threads,
                                    int wbufs, int xbufs,
                                    long long smem_bytes, int xb16,
                                    int* out) {
  FfnDims d;
  DxSmem m;
  const int rc = check_plan(layout, S, bf16, route, tile, threads, wbufs,
                            xbufs, smem_bytes, &d, &m);
  if (rc != 0) return rc;
  return kernel_info(kernel_of(route, bf16, d.F, xb16), threads,
                     (size_t)smem_bytes, &out[0], &out[1], &out[2]);
}

// dx [T, F, N] (fully written; bf16 where the panel is, xb16 1, else f32)
// from x [T, F, N], zp [S, T, H1], the packed
// params [S, P] and g [S, T, N]. img: route 1's member images, S ×
// wwords words of device scratch (unused by route 0). layout: see
// sdf_ffn::read_dims; dropout as in sdf_ffn_fwd. The plan (route, stock
// tile, threads, weight buffers (S: resident; 2 or 1: streamed), panel tile
// buffers (2 or 1), shared-memory bytes, G blocks) comes from
// ops/sdf_ffn.py::dx_plan, whose resident
// blocks the wrapper has checked on the card once (sdf_ffn_dx_plan_info,
// which also opens the kernel to the shared memory the launch takes); a
// plan that disagrees with this file is refused. Returns 0, a cudaError_t
// value, or -1 for an unsupported shape or plan.
extern "C" int sdf_ffn_dx(const void* x, int xb16, const float* zp,
                          const float* params, const float* g, void* dx,
                          unsigned int* img, int S,
                          int T, int N, const int* layout, int bf16,
                          int dropout, const unsigned int* member_base,
                          unsigned int threshold, float scale,
                          unsigned int offset, int route,
                          int tile, int threads, int wbufs, int xbufs,
                          long long smem_bytes, int G, void* stream) {
  if (T < 1 || N < 1 || G < 1) return kUnsupported;
  if (route == kRouteMma && !bf16) return kUnsupported;
  FfnDims d;
  DxSmem m;
  const int rc = check_plan(layout, S, bf16, route, tile, threads, wbufs,
                            xbufs, smem_bytes, &d, &m);
  if (rc != 0) return rc;
  const long long ncells = (long long)T * ((N + tile - 1) / tile);
  if (G > ncells || ncells > INT_MAX) return kUnsupported;
  const int cells = (int)ncells;
  const void* kern = kernel_of(route, bf16, d.F, xb16);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  if (route == kRouteMma) {
    sdf_ffn_dx_image_kernel<<<S, 256, 0, st>>>(params, img, d, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const uint32_t* cimg = img;
    void* args[] = {&x, &zp, (void*)&cimg, &g, &dx, &S, &T, &N, &tile,
                    (void*)&cells, &d, &m, (void*)&drop};
    return (int)cudaLaunchKernel(kern, dim3(G), dim3(threads), args,
                                 (size_t)smem_bytes, st);
  }
  void* args[] = {&x, &zp, &params, &g, &dx, &S, &T, &N, &tile,
                  (void*)&cells, &d, &m, (void*)&drop};
  return (int)cudaLaunchKernel(kern, dim3(G), dim3(threads), args,
                               (size_t)smem_bytes, st);
}

#ifdef SDF_FFN_DX_AUDIT
// Zero the audit's counters on `stream` (before a launch). Returns 0 or a
// cudaError_t value.
extern "C" int sdf_ffn_dx_audit_reset(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_dx_audit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemsetAsync(p, 0, sizeof(g_dx_audit),
                              static_cast<cudaStream_t>(stream));
}

// The counters after the launches on `stream` since the last reset, into
// out[5] (waits for the stream). Returns 0 or a cudaError_t value.
extern "C" int sdf_ffn_dx_audit_read(unsigned long long* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      out, g_dx_audit, sizeof(g_dx_audit), 0, cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(st);
}
#endif
