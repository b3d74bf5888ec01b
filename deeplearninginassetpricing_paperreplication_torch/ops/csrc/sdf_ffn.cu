// Fused SDF-FFN forward for Hopper (sm_90a): the panel MLP of every ensemble
// member in one launch.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/pallas_ffn.py
// _fwd_kernel (:188, one member) and _fwd_kernel_members (:561, S members
// over one panel read). It computes, for member s, period t and stock n,
//
//   w[s,t,n] = kout_s . relu(W_L,s ... relu(K1_s^T x[t,:,n] + zp[s,t]) ... + b) + bout_s
//
// over the feature-major panel x [T, F, N] (f32, or bf16: panel.cuh; each
// kernel below has a float and a bf16-panel instance). The output is the
// raw weight [S, T, N] in f32, before masking.
//
// What bounds it on this card: operations. At the paper's widths (F = 46,
// hidden [64, 64]) a (member, period, stock) row costs
// 2*(F*H1 + H1*H2 + H2) = 14.2 kFLOP against 184 bytes of panel read once
// for all members. In f32 the products run on the CUDA cores (67 TFLOP/s);
// in bf16 on the tensor cores, where at S = 9 with dropout the counter-based
// mask hash (one fmix32 per unit and layer) is the larger cost.
//
// Two routes, one launch plan each (ops/sdf_ffn.py::fwd_plan, recomputed
// and checked here: a plan that disagrees with this file or that the card
// cannot keep resident is refused). Both grids are persistent: G resident
// blocks walk the cells (member group, period, stock tile) in that order,
// so a block stages its members' weights in shared memory once and keeps
// them over the many cells it walks, and no wave runs part-full.
//
// * f32 (compute_dtype float32): one member per cell. The period's x tile
//   [F][tile] and each layer's activations [H][tile] live in shared memory;
//   each thread computes a register tile of 8 units × 8 stocks per layer,
//   two float4 of weights and two of activations feeding 64 FMAs, and
//   loads the next cell's panel values into registers while this one
//   computes. Every (stock, unit) sum keeps the chain of the
//   one-thread-per-stock kernel this replaced: f = 0..F-1 in the first
//   layer and j = 0..hp-1 after it, each an fmaf from 0, then + bias, so
//   its outputs are bit for bit the same. The output projection is a
//   per-stock chain over k in order.
// * bf16 (compute_dtype bfloat16): the layer products are warp-level
//   mma.sync.m16n8k16 (bf16 operands, f32 accumulators). A block holds the
//   bf16 weights of a group of members (all S where they fit) and, per
//   cell, the f32 panel tile and the members' zp rows, copied with
//   cp.async into one of two buffers while the other cell computes. Each
//   warp owns 16 stocks and converts their panel fragments to bf16 once
//   per cell for all its members. The accumulators start at the layer's
//   bias (zp for the first); ReLU, the dropout mask, the scale and the
//   bf16 rounding run on the accumulator fragments in registers, which are
//   repacked as the next layer's A fragments without a trip through shared
//   memory. The output projection is one more product, n = 8 with kout as
//   its only nonzero column.
//
// compute_dtype bfloat16: both operands of every product are rounded to
// bf16 (the weights when the wrapper packs them, the panel and the
// activations here) and accumulated in f32, as pallas_ffn._dot does; the
// biases stay f32. A product of two bf16 values is exact in f32, so only
// the summation order differs from the plain version.
//
// Training-mode dropout (pallas_ffn._dropout_mask, applied after the ReLU of
// every hidden layer) draws its mask from the counter-based hash in
// sdf_ffn_common.cuh, so the backward kernel regenerates it exactly.
//
// The packed parameter layout (floats, every segment a multiple of 4) is
// defined once, in ops/sdf_ffn.py::ffn_layout, and passed in as offsets:
//   k1   [F][hp0]         first layer, feature-major rows
//   W_l  [h_l][hp_{l-1}]  each later hidden layer, row-major
//   b_l  [hp_l]
//   kout [hp_L]
//   bout [4]              (element 0)

#include "panel.cuh"
#include "sdf_ffn_common.cuh"

// One library per width bound: the build passes -DSDF_FFN_MAXW=32|64|128
// (the widest padded hidden layer it serves), so each is compiled alone and
// only the one a model needs is built at first use.
#ifndef SDF_FFN_MAXW
#define SDF_FFN_MAXW 64
#endif

namespace {

using sdf_ffn::cp_async4;
using sdf_ffn::cp_async_commit;
using sdf_ffn::cp_async_wait;
using sdf_ffn::Dropout;
using sdf_ffn::FfnDims;
using sdf_ffn::kMaxLayers;
using sdf_ffn::kUnsupported;
using sdf_ffn::ldsm_x2;
using sdf_ffn::ldsm_x4;
using sdf_ffn::mma_bf16;
using sdf_ffn::pack_bf16;

constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kRouteF32 = 0, kRouteMma = 1;
constexpr int kTu = 8, kTs = 8;  // f32 register tile: units × stocks
constexpr int kMaxThreads = 256;
// panel values each f32 thread prefetches into registers for its next cell
// (tile · F / threads at the plan's tile for the paper's F = 46)
constexpr int kPre = SDF_FFN_MAXW <= 64 ? 48 : 24;
// the tensor-core route: 8 warps of 16 stocks per 128-stock tile, times 1
// or 2 member phases (the second phase's 8 warps run the odd members);
// registers keep the w128 library at one phase
constexpr int kMmaTile = 128;
constexpr int kMmaMaxThreads = SDF_FFN_MAXW <= 64 ? 512 : 256;

__host__ __device__ inline int pad4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int pad8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }
// the 32-bit-word stride of a shared row of kp bf16 values (kp a multiple
// of 16): kp/2 + 4 ≡ 4 (mod 8), so a fragment's 8 rows × 4 words hit 32
// distinct banks
__host__ __device__ inline int row_words(int kp) { return kp / 2 + 4; }

// Shared-memory plan (32-bit words) of one block.
struct FwdSmem {
  int x, x_rows, x_stride;  // the panel tile(s): x_rows rows of x_stride
  int w;                    // the weights (f32: one member; mma: a group)
  int member;               // mma: words per member
  int wl[kMaxLayers];       // f32: k1 / W_l^T [hp_{l-1}][hp_l]; mma: B rows
  int rw[kMaxLayers];       // mma: row words of layer l's B rows
  int bl[kMaxLayers];       // biases of layers l >= 1
  int kout, bout;
  int zp;                   // f32: zp [hp0]; mma: zp [2][members][MAXW]
  int rowh, act;            // f32: row hashes; the second activation tile
  int total;
};

FwdSmem smem_plan(const FfnDims& d, int route, int tile, int members) {
  FwdSmem m{};
  const int L = d.n_hidden;
  int off = 0;
  if (route == kRouteF32) {
    // the units of every layer padded to 8 (a register tile's width): k1
    // [F][pad8(hp0)], W_l^T [hp_{l-1}][pad8(hp_l)], b_l [pad8(hp_l)]; then
    // kout, bout, zp, the row hashes, and two activation tiles: the x tile
    // (which odd layers overwrite once layer 0 has read it) and the tile of
    // even layers
    m.w = 0;
    m.wl[0] = 0;
    off = d.F * pad8(d.hp[0]);
    int hmax = pad8(d.hp[0]);
    for (int l = 1; l < L; ++l) {
      m.wl[l] = off;
      off += d.hp[l - 1] * pad8(d.hp[l]);
      m.bl[l] = off;
      off += pad8(d.hp[l]);
      hmax = pad8(d.hp[l]) > hmax ? pad8(d.hp[l]) : hmax;
    }
    m.kout = off;
    off += d.hp[L - 1];
    m.bout = off;
    off += 4;
    m.zp = off;
    off += pad8(d.hp[0]);
    m.rowh = off;
    off += tile;
    m.x = off;
    m.x_rows = d.F;
    m.x_stride = tile;
    off += (d.F > hmax ? d.F : hmax) * tile;
    m.act = off;
    off += hmax * tile;
  } else {
    // every layer padded to the library's width bound W (zero weights and
    // biases), so the fragment loops have no runtime bounds; the sweep's
    // widths fill their bound exactly
    constexpr int W = SDF_FFN_MAXW;
    m.x = 0;
    m.x_rows = pad16(d.F);
    m.x_stride = tile + 4;  // rows 4 banks apart: conflict-free A loads
    off = 2 * m.x_rows * m.x_stride;
    m.zp = off;
    off += 2 * members * W;
    m.w = off;
    int mo = 0;
    for (int l = 0; l < L; ++l) {
      m.wl[l] = mo;
      m.rw[l] = row_words(l == 0 ? pad16(d.F) : W);
      mo += W * m.rw[l];
    }
    for (int l = 1; l < L; ++l) {
      m.bl[l] = mo;
      mo += W;
    }
    m.kout = mo;  // 8 B rows: kout, then 7 of zeros (an n = 8 product)
    mo += 8 * row_words(W);
    m.bout = mo;
    mo += 4;
    m.member = pad4(mo);
    off += members * m.member;
  }
  m.total = off;
  return m;
}

// -- the cell walk ---------------------------------------------------------------

struct Cell {
  int g, t, n0;
};

__device__ __forceinline__ Cell cell_at(long long c, int T, int tiles,
                                        int tile) {
  const long long per_group = (long long)T * tiles;
  const long long r = c % per_group;
  return Cell{(int)(c / per_group), (int)(r / tiles), (int)(r % tiles) * tile};
}

// -- f32 route ---------------------------------------------------------------------

// member s's weights as the f32 route reads them: k1 and each later W_l
// transposed to [inputs][units] (the 8 units of a tile contiguous), units
// padded to 8 with zeros; the biases, kout and bout as packed
__device__ void stage_f32(float* w, const float* p, const FfnDims& d,
                          const FwdSmem& m) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int hp0 = d.hp[0], h8 = pad8(hp0);
  for (int i = tid; i < d.F * h8; i += nth) {
    const int f = i / h8, k = i % h8;
    w[i] = k < hp0 ? p[f * hp0 + k] : 0.f;
  }
  for (int l = 1; l < d.n_hidden; ++l) {
    const int hin = d.hp[l - 1], hout = pad8(d.hp[l]);
    const float* W = p + d.off_w[l];
    float* WT = w + m.wl[l];
    for (int i = tid; i < hin * hout; i += nth) {
      const int j = i / hout, k = i % hout;
      WT[i] = k < d.h[l] ? W[k * hin + j] : 0.f;
    }
    for (int i = tid; i < hout; i += nth)
      w[m.bl[l] + i] = i < d.hp[l] ? p[d.off_b[l] + i] : 0.f;
  }
  for (int i = tid; i < d.hp[d.n_hidden - 1]; i += nth)
    w[m.kout + i] = p[d.off_kout + i];
  if (tid == 0) w[m.bout] = p[d.off_bout];
}

// out[k][s] = epilogue(Σ_j W[j][k] · in[j][s]) for k < hout, s < tile, in
// register tiles of kTu units × kTs stocks. Each sum is one fmaf chain over
// j = 0..kin-1 from 0, then + bias[k]: the chain of the kernel this
// replaced, so f32 results are bit for bit the same.
__device__ void layer_f32(const float* __restrict__ W, int wstride,
                          const float* __restrict__ in, int kin,
                          const float* __restrict__ bias, float* outb,
                          int hout, int tile, int l,
                          const uint32_t* __restrict__ rowh,
                          const Dropout& drop) {
  const int groups = tile / kTs;
  const int ntile = hout / kTu * groups;
  for (int it = threadIdx.x; it < ntile; it += blockDim.x) {
    const int k0 = it / groups * kTu, s0 = it % groups * kTs;
    float acc[kTu][kTs];
#pragma unroll
    for (int u = 0; u < kTu; ++u)
#pragma unroll
      for (int s = 0; s < kTs; ++s) acc[u][s] = 0.f;
    const float* wp = W + k0;
    const float* ip = in + s0;
#pragma unroll 2
    for (int j = 0; j < kin; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(wp + j * wstride);
      const float4 z = *reinterpret_cast<const float4*>(wp + j * wstride + 4);
      const float4 a = *reinterpret_cast<const float4*>(ip + j * tile);
      const float4 b = *reinterpret_cast<const float4*>(ip + j * tile + 4);
      const float wv[kTu] = {w.x, w.y, w.z, w.w, z.x, z.y, z.z, z.w};
      const float av[kTs] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < kTu; ++u)
#pragma unroll
        for (int s = 0; s < kTs; ++s) acc[u][s] = fmaf(wv[u], av[s], acc[u][s]);
    }
    uint32_t rows[kTs];
    if (drop.on) {
      const uint4 r0 = *reinterpret_cast<const uint4*>(rowh + s0);
      const uint4 r1 = *reinterpret_cast<const uint4*>(rowh + s0 + 4);
      rows[0] = r0.x; rows[1] = r0.y; rows[2] = r0.z; rows[3] = r0.w;
      rows[4] = r1.x; rows[5] = r1.y; rows[6] = r1.z; rows[7] = r1.w;
    }
#pragma unroll
    for (int u = 0; u < kTu; ++u) {
      const int k = k0 + u;
      const float bk = bias[k];
      float v[kTs];
#pragma unroll
      for (int s = 0; s < kTs; ++s) {
        float a = fmaxf(acc[u][s] + bk, 0.f);
        if (drop.on)
          a = sdf_ffn::keep_unit(rows[s], l, k, drop.threshold) ? a * drop.scale
                                                                : 0.f;
        v[s] = a;
      }
      float4* o = reinterpret_cast<float4*>(outb + k * tile + s0);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// load cell cn's first kPre·threads panel values (a bf16 panel's widened)
// and this thread's zp element into registers (stocks past N and the rest
// are 0)
template <typename PX>
__device__ __forceinline__ void fetch_f32(float (&pre)[kPre], float& zpre,
                                          const Cell& cn, const PX* x,
                                          const float* zp, int T, int F,
                                          int N, int h0, int tile, int lt) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const PX* xt = x + (size_t)cn.t * F * N + cn.n0;
#pragma unroll
  for (int q = 0; q < kPre; ++q) {
    const int i = q * nth + tid, j = i & (tile - 1);
    pre[q] = i < F * tile && cn.n0 + j < N
                 ? panel::ldx(xt + (size_t)(i >> lt) * N + j) : 0.f;
  }
  zpre = tid < h0 ? __ldg(zp + ((size_t)cn.g * T + cn.t) * h0 + tid) : 0.f;
}

template <typename PX>
__global__ void __launch_bounds__(kMaxThreads)
sdf_ffn_fwd_f32_kernel(const PX* __restrict__ x,
                       const float* __restrict__ zp,
                       const float* __restrict__ params,
                       float* __restrict__ out, int T, int N, int tile,
                       long long cells, FfnDims d, FwdSmem m,
                       Dropout drop) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* w = sm + m.w;
  float* zps = sm + m.zp;
  uint32_t* rowh = reinterpret_cast<uint32_t*>(sm + m.rowh);
  float* xs = sm + m.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int tiles = (N + tile - 1) / tile;
  const int F = d.F, L = d.n_hidden, h0 = d.h[0], hp0 = d.hp[0];
  const int lt = __ffs(tile) - 1;  // tile is a power of two
  // the next cell's panel values (the first kPre·threads of its tile) and
  // zp, loaded while this cell computes
  float pre[kPre];
  float zpre = 0.f;
  if (blockIdx.x < cells)
    fetch_f32(pre, zpre, cell_at(blockIdx.x, T, tiles, tile), x, zp, T, F, N,
              h0, tile, lt);
  int staged = -1;
  for (long long c = blockIdx.x; c < cells; c += gridDim.x) {
    const Cell cl = cell_at(c, T, tiles, tile);
    const int s = cl.g, t = cl.t, n0 = cl.n0;
    if (s != staged) {
      stage_f32(w, params + (size_t)s * d.P, d, m);
      staged = s;
    }
#pragma unroll
    for (int q = 0; q < kPre; ++q)
      if (q * nth + tid < F * tile) xs[q * nth + tid] = pre[q];
    const PX* xt = x + (size_t)t * F * N + n0;
    for (int i = kPre * nth + tid; i < F * tile; i += nth) {
      const int j = i & (tile - 1);
      xs[i] = n0 + j < N ? panel::ldx(xt + (size_t)(i >> lt) * N + j) : 0.f;
    }
    if (tid < pad8(hp0)) zps[tid] = zpre;
    if (drop.on) {
      const uint32_t base = drop.member_base[s];
      for (int i = tid; i < tile; i += nth)
        rowh[i] = sdf_ffn::row_hash(base, t, drop.offset + n0 + i);
    }
    if (c + gridDim.x < cells)
      fetch_f32(pre, zpre, cell_at(c + gridDim.x, T, tiles, tile), x, zp, T,
                F, N, h0, tile, lt);
    __syncthreads();

    // layer 0 reads the x tile and writes the activation tile; later layers
    // alternate between the two (selected, not indexed, so the pointers
    // stay in registers)
    layer_f32(w + m.wl[0], pad8(hp0), xs, F, zps, sm + m.act, pad8(hp0), tile,
              0, rowh, drop);
    for (int l = 1; l < L; ++l) {
      __syncthreads();
      const bool odd = l & 1;
      layer_f32(w + m.wl[l], pad8(d.hp[l]), sm + (odd ? m.act : m.x),
                d.hp[l - 1], w + m.bl[l], sm + (odd ? m.x : m.act),
                pad8(d.hp[l]), tile, l, rowh, drop);
    }
    __syncthreads();

    // the output projection: per stock, one chain over k in order
    const float* a = sm + ((L - 1) & 1 ? m.x : m.act);
    const float4* ko = reinterpret_cast<const float4*>(w + m.kout);
    const int hpl = d.hp[L - 1];
    float* orow = out + ((size_t)s * T + t) * N + n0;
    for (int i = tid; i < tile; i += nth) {
      if (n0 + i >= N) continue;
      float o = 0.f;
      for (int j = 0; j < hpl; j += 4) {
        const float4 k = ko[j / 4];
        o = fmaf(k.x, a[j * tile + i], o);
        o = fmaf(k.y, a[(j + 1) * tile + i], o);
        o = fmaf(k.z, a[(j + 2) * tile + i], o);
        o = fmaf(k.w, a[(j + 3) * tile + i], o);
      }
      orow[i] = o + w[m.bout];
    }
    __syncthreads();  // before the next cell overwrites the tiles
  }
}

// -- bf16 route: tensor cores ------------------------------------------------------

// the first layer's A fragments of k step kk from the f32 panel tile xs
// (this thread's column r0, rows 16·kk + 2·tig ...), rounded to bf16
__device__ __forceinline__ void x_frag(uint32_t (&a)[4], const float* xs,
                                       int kk, int tig, int xst) {
  const float* xp = xs + (16 * kk + 2 * tig) * xst;
  a[0] = pack_bf16(xp[0], xp[xst]);                // row gid, k 2·tig
  a[1] = pack_bf16(xp[8], xp[xst + 8]);            // row gid + 8
  a[2] = pack_bf16(xp[8 * xst], xp[9 * xst]);      // k 2·tig + 8
  a[3] = pack_bf16(xp[8 * xst + 8], xp[9 * xst + 8]);
}

// start the copies of cell (t, n0) of member group [s0, s0 + ms): its panel
// tile [F][tile] (stocks past N zero-filled) into xs, and each member's zp
// row, zero-padded to the width bound, into zs [ms][W]. A bf16 panel is
// stored widened here and now (panel.cuh); the zp rows go by cp.async.
template <typename PX>
__device__ __forceinline__ void load_cell(float* xs, float* zs,
                                          const PX* x, const float* zp,
                                          int t, int n0, int s0, int ms,
                                          int T, int F, int N, int h0,
                                          int stride) {
  constexpr int W = SDF_FFN_MAXW;
  const PX* xt = x + (size_t)t * F * N;
  if constexpr (panel::kBf16<PX>) {
    panel::stage_bf16(xs, stride, xt + n0, N, F, kMmaTile, N - n0);
  } else {
    for (int i = threadIdx.x; i < F * kMmaTile; i += blockDim.x) {
      const int f = i / kMmaTile, j = i % kMmaTile;
      const bool valid = n0 + j < N;
      cp_async4(xs + f * stride + j,
                valid ? xt + (size_t)f * N + n0 + j : x, valid);
    }
  }
  for (int i = threadIdx.x; i < ms * W; i += blockDim.x) {
    const int sl = i / W, u = i % W;
    const bool valid = u < h0;
    cp_async4(zs + i, valid ? zp + ((size_t)(s0 + sl) * T + t) * h0 + u : zp,
              valid);
  }
}

// the bf16 B rows of members [s0, s0 + ms): layer l's rows are its units
// (padded to the width bound W), each holding the unit's input weights
// (padded to 16, or to W after the first layer) as bf16 pairs, so a
// fragment's k pair is one 32-bit word; kout is the first of 8 rows of the
// output product. The group's words are zeroed, then the packed weights
// are read once, in order, and scattered; they are bf16-exact already, so
// the conversion is exact.
__device__ void stage_mma(uint32_t* wg, const float* params, int ms,
                          const FfnDims& d, const FwdSmem& m) {
  const int tid = threadIdx.x, nth = blockDim.x, L = d.n_hidden;
  for (int i = tid; i < ms * m.member; i += nth) wg[i] = 0u;
  __syncthreads();
  for (int sl = 0; sl < ms; ++sl) {
    const float* p = params + (size_t)sl * d.P;
    uint32_t* wm = wg + (size_t)sl * m.member;
    float* fm = reinterpret_cast<float*>(wm);
    for (int l = 0; l < L; ++l) {
      // packed: k1 [F][hp0] (l = 0) or W_l [h_l][hp_{l-1}]
      const int rows = l == 0 ? d.F : d.h[l], cols = d.hp[l == 0 ? 0 : l - 1];
      const int kin = l == 0 ? d.h[0] : d.h[l - 1];
      const float* src = p + d.off_w[l];
      __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(wm + m.wl[l]);
      for (int i = tid; i < rows * cols; i += nth) {
        const int r = i / cols, c = i % cols;
        if (c < kin) {
          // B row = unit, column = input: k1 is feature-major
          const int u = l == 0 ? c : r, k = l == 0 ? r : c;
          b[u * 2 * m.rw[l] + k] = __float2bfloat16_rn(src[i]);
        }
      }
      if (l > 0)
        for (int u = tid; u < d.h[l]; u += nth)
          fm[m.bl[l] + u] = p[d.off_b[l] + u];
    }
    __nv_bfloat16* ko = reinterpret_cast<__nv_bfloat16*>(wm + m.kout);
    for (int u = tid; u < d.h[L - 1]; u += nth)
      ko[u] = __float2bfloat16_rn(p[d.off_kout + u]);
    if (tid == 0) fm[m.bout] = p[d.off_bout];
  }
}

// acc[j] += A · B over tile pairs: one ldmatrix.x4 gives the B fragments
// of tiles j and j + 1 at one k step (lane l addresses row 8·(l / 16) +
// l % 8 of the pair, k half (l / 8) % 2); b points at this lane's row and
// k half of tile 0, k step 0
template <int NT>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4],
                                        const uint32_t (&a)[4],
                                        const uint32_t* b, int rw) {
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t q[4];
    ldsm_x4(q, b + 8 * j * rw);
    mma_bf16(acc[j], a, q[0], q[1]);
    mma_bf16(acc[j + 1], a, q[2], q[3]);
  }
}

// the accumulators of a layer start at its bias (zp for the first): c0, c1
// are row gid (stock), units 8j + 2·tig and + 1; c2, c3 the same units of
// row gid + 8
template <int NT>
__device__ __forceinline__ void init_bias(float (&acc)[NT][4],
                                          const float* bias) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j);
    acc[j][0] = acc[j][2] = b.x;
    acc[j][1] = acc[j][3] = b.y;
  }
}

// ReLU, dropout and scale on the accumulator fragments of layer l, rounded
// to bf16 and packed as pk[j][row half], which are the next product's A
// fragments
template <int NT>
__device__ __forceinline__ void epilogue_mma(const float (&acc)[NT][4],
                                             uint32_t (&pk)[NT][2], int l,
                                             const uint32_t (&rows)[2],
                                             int tig, const Dropout& drop) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = fmaxf(acc[j][e], 0.f);
      if (drop.on)
        v[e] = sdf_ffn::keep_unit(rows[e >> 1], l, 8 * j + 2 * tig + (e & 1),
                                  drop.threshold) ? v[e] * drop.scale : 0.f;
    }
    pk[j][0] = pack_bf16(v[0], v[1]);
    pk[j][1] = pack_bf16(v[2], v[3]);
  }
}

// KX: the first layer's k steps (pad16(F) / 16) when at most 4: a warp
// then converts its panel fragments once per cell and every member reuses
// them, in fully unrolled products; KX = 0 reads them per member in a loop
// over any F
template <int MAXW, int KX, typename PX>
__global__ void __launch_bounds__(kMmaMaxThreads, 1)
sdf_ffn_fwd_mma_kernel(const PX* __restrict__ x,
                       const float* __restrict__ zp,
                       const float* __restrict__ params,
                       float* __restrict__ out, int S, int T, int N, int mb,
                       long long cells, FfnDims d, FwdSmem m, Dropout drop) {
  constexpr int NT = MAXW / 8;   // accumulator tiles of 8 units
  constexpr int KT = MAXW / 16;  // 16-deep k steps of a hidden input
  extern __shared__ float4 smem4[];
  float* smf = reinterpret_cast<float*>(smem4);
  uint32_t* smw = reinterpret_cast<uint32_t*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int phases = blockDim.x / 256, phase = warp / 8;
  const int F = d.F, L = d.n_hidden, h0 = d.h[0];
  const int tiles = (N + kMmaTile - 1) / kMmaTile;
  const int xst = m.x_stride;
  // the two cell buffers (panel tile and zp rows), buffer b at x0 +
  // b·xsize and z0 + b·mb·MAXW (selected, not indexed, so nothing goes to
  // local memory)
  float* const x0 = smf + m.x;
  float* const z0 = smf + m.zp;
  const int xsize = m.x_rows * xst;
  // the feature padding rows F..pad16(F) of both buffers stay zero
  for (int i = tid; i < (m.x_rows - F) * xst; i += blockDim.x) {
    x0[F * xst + i] = 0.f;
    x0[xsize + F * xst + i] = 0.f;
  }
  int buf = 0, staged = -1;
  if (blockIdx.x < cells) {
    const Cell c0 = cell_at(blockIdx.x, T, tiles, kMmaTile);
    const int s0 = c0.g * mb;
    load_cell(x0, z0, x, zp, c0.t, c0.n0, s0, min(mb, S - s0), T, F, N, h0,
              xst);
  }
  cp_async_commit();
  const int r0 = (warp % 8) * 16 + gid;  // this thread's stocks: r0, r0 + 8
  // this lane's ldmatrix row and k half within a tile pair
  const int lrow = 8 * (lane >> 4) + (lane & 7), lk = 4 * ((lane >> 3) & 1);
  for (long long c = blockIdx.x; c < cells; c += gridDim.x) {
    const long long next = c + gridDim.x;
    if (next < cells) {
      const Cell cn = cell_at(next, T, tiles, kMmaTile);
      const int s0 = cn.g * mb;
      load_cell(x0 + (buf ^ 1) * xsize, z0 + (buf ^ 1) * mb * MAXW, x, zp,
                cn.t, cn.n0, s0, min(mb, S - s0), T, F, N, h0, xst);
    }
    cp_async_commit();
    const Cell cl = cell_at(c, T, tiles, kMmaTile);
    const int t = cl.t, n0 = cl.n0, s0 = cl.g * mb;
    const int ms = min(mb, S - s0);
    if (cl.g != staged) {
      stage_mma(smw + m.w, params + (size_t)s0 * d.P, ms, d, m);
      staged = cl.g;
    }
    cp_async_wait<1>();  // this cell's tile and zp rows have landed
    __syncthreads();

    const float* xs = x0 + buf * xsize + r0;
    const float* zs = z0 + buf * mb * MAXW;
    uint32_t xa[KX > 0 ? KX : 1][4];
#pragma unroll
    for (int kk = 0; kk < KX; ++kk) x_frag(xa[kk], xs, kk, tig, xst);
    for (int sl = phase; sl < ms; sl += phases) {
      const int s = s0 + sl;
      const uint32_t* wm = smw + m.w + (size_t)sl * m.member;
      const float* fm = reinterpret_cast<const float*>(wm);
      uint32_t rows[2] = {0u, 0u};
      if (drop.on) {
        const uint32_t base = drop.member_base[s];
        rows[0] = sdf_ffn::row_hash(base, t, drop.offset + n0 + r0);
        rows[1] = sdf_ffn::row_hash(base, t, drop.offset + n0 + r0 + 8);
      }
      float acc[NT][4];
      uint32_t pk[NT][2];
      // -- layer 0: the panel tile, rounded to bf16 as it is read ----------
      init_bias<NT>(acc, zs + sl * MAXW + 2 * tig);
      const uint32_t* b0 = wm + m.wl[0] + lrow * m.rw[0] + lk;
      if constexpr (KX > 0) {
#pragma unroll
        for (int kk = 0; kk < KX; ++kk)
          mma_row<NT>(acc, xa[kk], b0 + 8 * kk, m.rw[0]);
      } else {
        for (int kk = 0; kk < m.x_rows / 16; ++kk) {
          uint32_t a[4];
          x_frag(a, xs, kk, tig, xst);
          mma_row<NT>(acc, a, b0 + 8 * kk, m.rw[0]);
        }
      }
      epilogue_mma<NT>(acc, pk, 0, rows, tig, drop);
      // -- later layers: A fragments straight from the packed epilogue -----
      for (int l = 1; l < L; ++l) {
        init_bias<NT>(acc, fm + m.bl[l] + 2 * tig);
        const uint32_t* bl = wm + m.wl[l] + lrow * m.rw[l] + lk;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1],
                                 pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
          mma_row<NT>(acc, a, bl + 8 * kk, m.rw[l]);
        }
        epilogue_mma<NT>(acc, pk, l, rows, tig, drop);
      }
      // -- output projection: an n = 8 product, kout the only live column --
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t* bk = wm + m.kout + (lane & 7) * row_words(MAXW) + lk;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1],
                               pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
        uint32_t q[2];
        ldsm_x2(q, bk + 8 * kk);
        mma_bf16(o, a, q[0], q[1]);
      }
      if (tig == 0) {  // column 0: rows gid (o[0]) and gid + 8 (o[2])
        float* orow = out + ((size_t)s * T + t) * N + n0 + r0;
        if (n0 + r0 < N) orow[0] = o[0] + fm[m.bout];
        if (n0 + r0 + 8 < N) orow[8] = o[2] + fm[m.bout];
      }
    }
    __syncthreads();  // the cell's buffers and the weights are free again
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// -- plans ---------------------------------------------------------------------

// the kernel a route runs for F features on the panel type PX (the bf16
// route's instance by its first layer's k steps)
template <typename PX>
const void* kernel_of(int route, int F) {
  if (route == kRouteF32) return (const void*)sdf_ffn_fwd_f32_kernel<PX>;
  switch (pad16(F) / 16) {
    case 1: return (const void*)sdf_ffn_fwd_mma_kernel<SDF_FFN_MAXW, 1, PX>;
    case 2: return (const void*)sdf_ffn_fwd_mma_kernel<SDF_FFN_MAXW, 2, PX>;
    case 3: return (const void*)sdf_ffn_fwd_mma_kernel<SDF_FFN_MAXW, 3, PX>;
    case 4: return (const void*)sdf_ffn_fwd_mma_kernel<SDF_FFN_MAXW, 4, PX>;
    default: return (const void*)sdf_ffn_fwd_mma_kernel<SDF_FFN_MAXW, 0, PX>;
  }
}

// the kernel for a panel of bf16 (xb16 1) or f32 values
const void* kernel_of(int route, int F, int xb16) {
  return xb16 ? kernel_of<__nv_bfloat16>(route, F)
              : kernel_of<float>(route, F);
}

// 0 if the card takes `route` (on the panel type xb16 names) at `threads`
// and `smem` bytes: resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and
// local-memory bytes per thread; else a cudaError_t value
int kernel_info(int route, int F, int xb16, int threads, size_t smem,
                int* blocks, int* regs, int* local_bytes) {
  const void* kern = kernel_of(route, F, xb16);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// 0 and the smem plan if (layout, route, tile, threads, members, smem
// bytes) is a plan this file takes for S members, else kUnsupported
int check_plan(const int* layout, int S, int route, int tile, int threads,
               int members, long long smem_bytes, FfnDims* d, FwdSmem* m) {
  int maxw = 0;
  if (sdf_ffn::read_dims(layout, d, &maxw) != 0) return kUnsupported;
  if (maxw > SDF_FFN_MAXW) return kUnsupported;
  if (route == kRouteF32) {
    if ((tile != 32 && tile != 64 && tile != 128) ||
        (threads != 128 && threads != 256) || members != 1)
      return kUnsupported;
  } else if (route == kRouteMma) {
    if (tile != kMmaTile || (threads != 256 && threads != 512) ||
        threads > kMmaMaxThreads || members < 1 ||
        members > S)
      return kUnsupported;
  } else {
    return kUnsupported;
  }
  *m = smem_plan(*d, route, tile, members);
  const long long smem = (long long)sizeof(float) * m->total;
  if (smem != smem_bytes || smem > (long long)kMaxSmem) return kUnsupported;
  return 0;
}

}  // namespace

// Registers per thread of the kernel route 0 (f32) or 1 (bf16 tensor
// cores) runs for F features on an f32 (xb16 0) or bf16 (1) panel.
extern "C" int sdf_ffn_fwd_registers(int route, int F, int xb16) {
  if ((route != kRouteF32 && route != kRouteMma) || F < 1) return kUnsupported;
  int info[3] = {0, 0, 0};
  if (kernel_info(route, F, xb16, route == kRouteMma ? 256 : 128, 0,
                  &info[0], &info[1], &info[2]) != 0)
    return kUnsupported;
  return info[1];
}

// What the card makes of a plan: out = [resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
// local-memory bytes per thread] of its instance for an f32 (xb16 0) or
// bf16 (1) panel. Returns 0, a cudaError_t value, or -1 for a plan this
// file refuses.
extern "C" int sdf_ffn_fwd_plan_info(const int* layout, int S, int route,
                                     int tile, int threads, int members,
                                     long long smem_bytes, int xb16,
                                     int* out) {
  FfnDims d;
  FwdSmem m;
  const int rc = check_plan(layout, S, route, tile, threads, members,
                            smem_bytes, &d, &m);
  if (rc != 0) return rc;
  return kernel_info(route, d.F, xb16, threads, (size_t)smem_bytes, &out[0],
                     &out[1], &out[2]);
}

// x: the panel [T, F, N], f32, or bf16 where xb16 is 1 (panel.cuh: the
// kernel's bf16-panel instance). layout: see sdf_ffn::read_dims. dropout:
// rate > 0 iff `dropout` is 1;
// then member s hashes from member_base[s] (a device array of S uint32),
// keeps a unit iff its hash >= `threshold`, and scales kept values by
// `scale`; stock n hashes as the global stock `offset` + n (0 unsharded).
// The plan (route 0 f32 / 1 bf16 tensor cores, stock tile,
// threads, members per block, shared-memory bytes, the resident blocks per
// SM it counts on, G blocks) comes from ops/sdf_ffn.py::fwd_plan; a plan
// that disagrees with this file, or that the card does not hold resident
// (G above blocks per SM × SMs), is refused.
// Returns 0 on success, a cudaError_t value, or -1 for an unsupported shape
// or plan.
extern "C" int sdf_ffn_fwd(const void* x, int xb16, const float* zp,
                           const float* params, float* out, int S, int T,
                           int N, const int* layout, int bf16, int dropout,
                           const unsigned int* member_base,
                           unsigned int threshold, float scale,
                           unsigned int offset, int route,
                           int tile, int threads, int members,
                           long long smem_bytes, int blocks_per_sm, int G,
                           void* stream) {
  if (S < 1 || T < 1 || N < 1 || G < 1 || blocks_per_sm < 1) return kUnsupported;
  if (route != (bf16 ? kRouteMma : kRouteF32)) return kUnsupported;
  FfnDims d;
  FwdSmem m;
  int rc = check_plan(layout, S, route, tile, threads, members, smem_bytes, &d,
                      &m);
  if (rc != 0) return rc;
  int info[3] = {0, 0, 0};
  rc = kernel_info(route, d.F, xb16, threads, (size_t)smem_bytes, &info[0],
                   &info[1], &info[2]);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (info[0] < blocks_per_sm || G > blocks_per_sm * sms) return kUnsupported;
  const long long groups = (S + members - 1) / members;
  const long long cells = groups * T * ((N + tile - 1) / tile);
  if (G > cells) return kUnsupported;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  // the two kernels' arguments: (x, zp, params, out, T, N, tile, cells, d,
  // m, drop) and (x, zp, params, out, S, T, N, members, cells, d, m, drop)
  void* f32_args[] = {&x, &zp, &params, &out, &T, &N, &tile, (void*)&cells,
                      &d, &m, (void*)&drop};
  void* mma_args[] = {&x, &zp, &params, &out, &S, &T, &N, &members,
                      (void*)&cells, &d, &m, (void*)&drop};
  return (int)cudaLaunchKernel(kernel_of(route, d.F, xb16), dim3(G),
                               dim3(threads),
                               route == kRouteF32 ? f32_args : mma_args,
                               (size_t)smem_bytes,
                               static_cast<cudaStream_t>(stream));
}
