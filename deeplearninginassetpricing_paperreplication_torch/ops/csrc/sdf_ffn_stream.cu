// The SDF FFN's streamed-weight route: forward, recompute backward and panel
// cotangent for the stacks the resident kernels (sdf_ffn.cu, sdf_ffn_bwd.cu,
// sdf_ffn_dx.cu) cannot hold: a padded hidden width above 128, more than
// kMaxLayers hidden layers, or weights plus tile beyond one block's 227 KB of
// shared memory.
//
// Replaces, at those shapes, the JAX package's Pallas kernels
// ops/pallas_ffn.py::_fwd_kernel (:188) and _fwd_kernel_members (:561),
// _bwd_kernel (:205) and _bwd_kernel_members (:591), and _dx_kernel (:300),
// which size their stock tile to a VMEM budget for any hidden stack. Here the
// stack is never staged whole: a block holds one cell (member, period, tile
// of BN stocks) and runs it one hidden layer at a time.
//
// - A layer's weights pass through shared memory in slabs of kSlab input
//   units × UC output units (UC = 16 · kThreads / BN), two slabs in flight
//   (cp.async), so any width and depth stream through the same 2 · kSlab · UC
//   floats.
// - The tile's activations ([rows][BN + 4], feature-major, each layer's rows
//   padded to 16 and zero past its width) sit in shared memory where they
//   fit, else in a per-block slice of a global scratch the wrapper allocates
//   (the same code through a generic pointer).
// - The forward keeps two activation buffers (the layer in hand and the one
//   below). The backward and the panel cotangent recompute the forward and
//   keep every layer's post-dropout activations, from which the ReLU ×
//   dropout factor is read back (act > 0 ⇔ h_pre > 0 and kept; scale ≥ 1), then
//   run the dh chain with dh in two buffers of the same kind. The backward
//   adds each cell's parameter gradients into its block's partial slice of
//   grad_part [S][G][P] (read-add-write, no atomics, every element always
//   written by the same thread, so repeatable bit for bit), as
//   sdf_ffn_bwd.cu does; the wrapper sums the G partials in a fixed order.
// - Products run on the CUDA cores in f32 FMAs: 4 units × 4 stocks a thread
//   for a layer (weights from the slab, activations from the tile), 4 × 4
//   (unit, input) pairs a thread for a weight gradient (the sum over the
//   tile's stocks). Under bf16 compute both operands of every product are
//   rounded to bf16 as they are read (the packed weights already are), the
//   rounding points of ops/sdf_ffn.py's plain versions.
// - Dropout: the hash of (member base, period, global stock, layer, unit) of
//   sdf_ffn_common.cuh, any layer.
// - Both panel dtypes (panel.cuh): the tile is widened to f32 as it is
//   staged; dx is written in the panel's dtype, summed over the members in
//   f32 and rounded once.
//
// What bounds it: at the widths it serves, the operations (about as many as
// the resident routes') run on the CUDA cores at f32 rate, and each cell
// re-reads the whole member's weights from L2 (BN FMAs per weight float
// read). It is the simple route that is right for every shape; tensor cores
// and a larger reuse of the slab are later work.
//
// One library per kernel: -DSDF_FFN_STREAM_KERNEL=0 (forward), 1 (backward),
// 2 (panel cotangent), each holding the four (panel dtype × compute dtype)
// instances of its kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "panel.cuh"
#include "sdf_ffn_common.cuh"

#ifndef SDF_FFN_STREAM_KERNEL
#define SDF_FFN_STREAM_KERNEL 0
#endif

namespace {

using sdf_ffn::Dropout;
using sdf_ffn::kUnsupported;
using sdf_ffn::LayoutTable;

constexpr int kThreads = 256;
constexpr int kSlab = 16;  // input units per weight slab; rows pad to this
constexpr int kMaxSmem = 227 * 1024;
constexpr int kFwd = 0, kBwd = 1, kDx = 2;

__host__ __device__ __forceinline__ int pad16(int x) { return (x + 15) & ~15; }

// units a layer pass computes: 4 units × 4 stocks a thread
__host__ __device__ __forceinline__ int pass_units(int BN) {
  return 16 * kThreads / BN;
}

template <bool BF>
__device__ __forceinline__ float rd(float v) {
  return BF ? sdf_ffn::round_bf16(v) : v;
}

template <bool BF>
__device__ __forceinline__ float4 rd4(float4 v) {
  if (BF) {
    v.x = sdf_ffn::round_bf16(v.x);
    v.y = sdf_ffn::round_bf16(v.y);
    v.z = sdf_ffn::round_bf16(v.z);
    v.w = sdf_ffn::round_bf16(v.w);
  }
  return v;
}

// what a layer product does with its sums
enum Epilogue {
  kAct = 0,    // + bias, ReLU, dropout: a hidden layer's activations
  kChain = 1,  // × the layer below's factor: dh_pre of the layer below
  kAccum = 2,  // added into out: the panel cotangent over the members
};

// out[u][n] (u < pad16(Uout), n < BN) from Σ_k W(k, u) · in[k][n] over k <
// Kin: W(k, u) = W[k·ldw + u] (direct) or W[u·ldw + k]. `in` has pad16(Kin)
// rows, zero from Kin. kAct: + bias[u], ReLU, dropout of `layer` (unit u of
// stock n kept iff keep_unit(hash[n], layer, u)); rows from Uout written 0.
// kChain: × dscale where below[u][n] > 0, else 0. kAccum: out += the sums,
// rows u < Uout. Every thread of the block calls it.
template <bool BF, int EPI>
__device__ void layer_product(const float* __restrict__ W, bool direct,
                              int ldw, int Kin, int Uout, const float* in,
                              float* out, const float* __restrict__ bias,
                              const float* below, const uint32_t* hash,
                              int layer, const Dropout& drop, float dscale,
                              float* slab, int BN, int LD) {
  const int UC = pass_units(BN);
  const int nq = BN >> 2;
  const int nt = threadIdx.x % nq, ut = threadIdx.x / nq;
  const int RU = pad16(Uout);
  const int nk = pad16(Kin) / kSlab;
  for (int u0 = 0; u0 < RU; u0 += UC) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    // slab kb: W(k, u) for k in [kb·kSlab, +kSlab), u in [u0, u0 + UC),
    // zero outside the layer
    auto issue = [&](int kb) {
      float* dst = slab + (kb & 1) * kSlab * UC;
      const int k0 = kb * kSlab;
      for (int e = threadIdx.x; e < kSlab * UC; e += kThreads) {
        int k, u;
        if (direct) {
          k = e / UC;
          u = e - k * UC;
        } else {
          u = e / kSlab;
          k = e - u * kSlab;
        }
        const int gk = k0 + k, gu = u0 + u;
        const bool ok = gk < Kin && gu < Uout;
        const size_t at = !ok ? 0
                          : direct ? (size_t)gk * ldw + gu
                                   : (size_t)gu * ldw + gk;
        sdf_ffn::cp_async4(dst + k * UC + u, W + at, ok);
      }
    };
    issue(0);
    sdf_ffn::cp_async_commit();
    for (int kb = 0; kb < nk; ++kb) {
      if (kb + 1 < nk) issue(kb + 1);
      sdf_ffn::cp_async_commit();
      sdf_ffn::cp_async_wait<1>();
      __syncthreads();
      const float* s = slab + (kb & 1) * kSlab * UC + 4 * ut;
      const float* x = in + (size_t)kb * kSlab * LD + 4 * nt;
#pragma unroll 4
      for (int k = 0; k < kSlab; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(s + k * UC);
        const float4 v =
            rd4<BF>(*reinterpret_cast<const float4*>(x + (size_t)k * LD));
        const float wr[4] = {w.x, w.y, w.z, w.w};
        const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wr[r], vc[c], acc[r][c]);
      }
      __syncthreads();
    }
    const int ub = u0 + 4 * ut;
    if (ub >= RU) continue;  // RU is a multiple of 16: a quad is in or out
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = ub + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * nt + c;
        float* o = out + (size_t)u * LD + n;
        const float v = acc[r][c];
        if (EPI == kAct) {
          float a = 0.f;
          if (u < Uout) {
            a = fmaxf(v + __ldg(bias + u), 0.f);
            if (drop.on)
              a = sdf_ffn::keep_unit(hash[n], layer, u, drop.threshold)
                      ? a * drop.scale
                      : 0.f;
          }
          *o = a;
        } else if (EPI == kChain) {
          *o = (u < Uout && below[(size_t)u * LD + n] > 0.f) ? v * dscale
                                                              : 0.f;
        } else if (u < Uout) {
          *o += v;
        }
      }
    }
  }
}

// gp[a·ldg + b] += Σ_n A[a][n] · B[b][n] for a < Ra, b < Rb (operands rounded
// under bf16): a weight gradient's cell partial, 4 × 4 pairs a thread, the
// threads' b rows adjacent (conflict-free float4 rows of stride ≡ 4 mod 32 or
// 20). Only global memory is written.
template <bool BF>
__device__ void grad_product(const float* A, int Ra, const float* B, int Rb,
                             float* gp, int ldg, int BN, int LD) {
  const int at = threadIdx.x >> 4, bt = threadIdx.x & 15;
  for (int a0 = 0; a0 < Ra; a0 += 64) {
    for (int b0 = 0; b0 < Rb; b0 += 64) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < BN; n += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int a = a0 + at + 16 * r;
          av[r] = a < Ra ? rd4<BF>(*reinterpret_cast<const float4*>(
                               A + (size_t)a * LD + n))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          const int b = b0 + bt + 16 * r;
          bv[r] = b < Rb ? rd4<BF>(*reinterpret_cast<const float4*>(
                               B + (size_t)b * LD + n))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = acc[r][c];
            s = fmaf(av[r].x, bv[c].x, s);
            s = fmaf(av[r].y, bv[c].y, s);
            s = fmaf(av[r].z, bv[c].z, s);
            s = fmaf(av[r].w, bv[c].w, s);
            acc[r][c] = s;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int a = a0 + at + 16 * r;
        if (a >= Ra) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = b0 + bt + 16 * c;
          if (b < Rb) gp[(size_t)a * ldg + b] += acc[r][c];
        }
      }
    }
  }
}

// dst[j] += Σ_n A[j][n] for j < R (unrounded): a bias gradient
__device__ void row_sums(const float* A, int R, float* dst, int BN, int LD) {
  for (int j = threadIdx.x; j < R; j += kThreads) {
    float s = 0.f;
    for (int n = 0; n < BN; ++n) s += A[(size_t)j * LD + n];
    dst[j] += s;
  }
}

// the tile x[t][:, n0 : n0 + BN] widened to f32 into X [pad16(F)][LD], zero
// past F and past N
template <typename PX>
__device__ void stage_x(float* X, const PX* __restrict__ x, int T, int F,
                        int N, int t, int n0, int BN, int LD) {
  const int RF = pad16(F);
  for (int i = threadIdx.x; i < RF * BN; i += kThreads) {
    const int f = i / BN, n = i - f * BN;
    float v = 0.f;
    if (f < F && n0 + n < N)
      v = panel::ldx(x + ((size_t)t * F + f) * N + n0 + n);
    X[(size_t)f * LD + n] = v;
  }
}

// the tile's dropout row hashes of member s at period t
__device__ void stage_hash(uint32_t* hash, const Dropout& drop, int s, int t,
                           int n0, int BN) {
  if (!drop.on) return;
  for (int n = threadIdx.x; n < BN; n += kThreads)
    hash[n] = sdf_ffn::row_hash(__ldg(drop.member_base + s), (uint32_t)t,
                                drop.offset + (uint32_t)(n0 + n));
}

// rows of the tile buffers (each [rows][BN + 4]): X, then the forward's two
// activation buffers, or every layer's activations, two dh buffers and (the
// panel cotangent) the dx accumulator
__host__ __device__ inline int tile_rows(int kernel, int n, int F,
                                         const int* h) {
  int wr = 0, sum = 0;
  for (int l = 0; l < n; ++l) {
    const int r = pad16(h[l]);
    wr = r > wr ? r : wr;
    sum += r;
  }
  if (kernel == kFwd) return pad16(F) + 2 * wr;
  return pad16(F) + sum + 2 * wr + (kernel == kDx ? pad16(F) : 0);
}

// shared memory floats besides the tile buffers: the two slabs, the row
// hashes and the g row
__host__ __device__ inline int fixed_floats(int BN) {
  return 2 * kSlab * pass_units(BN) + 2 * BN;
}

// the cell's forward, the stack recomputed one layer at a time from X;
// returns the top layer's activations. `keep_all`: layer l's activations
// at acts + act_row[l] (backward, panel cotangent); else in the two buffers
// at acts, acts + wr·LD (forward)
template <bool BF>
__device__ const float* forward_cell(const LayoutTable& L, const float* W,
                                     const float* __restrict__ zp_row,
                                     const float* X, float* acts, int wr,
                                     bool keep_all, const uint32_t* hash,
                                     const Dropout& drop, float* slab, int BN,
                                     int LD) {
  const int nl = L.n();
  const float* in = X;
  int Kin = L.F(), row = 0;
  for (int l = 0; l < nl; ++l) {
    const int H = L.h(l);
    float* o = keep_all ? acts + (size_t)row * LD
                        : acts + (size_t)((l & 1) * wr) * LD;
    row += pad16(H);
    if (l == 0)
      layer_product<BF, kAct>(W, true, L.hp(0), Kin, H, in, o, zp_row,
                              nullptr, hash, 0, drop, 1.f, slab, BN, LD);
    else
      layer_product<BF, kAct>(W + L.off_w(l), false, L.hp(l - 1), Kin, H, in,
                              o, W + L.off_b(l), nullptr, hash, l, drop, 1.f,
                              slab, BN, LD);
    __syncthreads();
    in = o;
    Kin = H;
  }
  return in;
}

// the cell's dh chain from g down to the first layer: dh_pre of the top
// layer from round(kout)·round(g) and its factor, then down through each
// W_l; `on_layer(l, dhp_l)` runs first at every layer l ≥ 1 (the weight
// gradients read dhp_l and the activations below). Returns dh_pre of the
// first layer. act(l) = acts + act_row[l]·LD.
template <bool BF, typename OnLayer>
__device__ const float* chain_cell(const LayoutTable& L, const float* W,
                                   const float* acts, const float* grow,
                                   float* dh0, float* dh1, float dscale,
                                   const Dropout& drop, float* slab, int BN,
                                   int LD, OnLayer on_layer) {
  const int nl = L.n();
  int top = 0;
  for (int l = 0; l + 1 < nl; ++l) top += pad16(L.h(l));
  const int HL = L.h(nl - 1);
  const float* actL = acts + (size_t)top * LD;
  const float* kout = W + L.off_kout();
  for (int i = threadIdx.x; i < pad16(HL) * BN; i += kThreads) {
    const int j = i / BN, n = i - j * BN;
    float d = 0.f;
    if (j < HL && actL[(size_t)j * LD + n] > 0.f)
      d = rd<BF>(__ldg(kout + j)) * rd<BF>(grow[n]) * dscale;
    dh0[(size_t)j * LD + n] = d;
  }
  __syncthreads();
  float* cur = dh0;
  float* other = dh1;
  int row = top;
  for (int l = nl - 1; l >= 1; --l) {
    const int below = row - pad16(L.h(l - 1));
    on_layer(l, cur, acts + (size_t)below * LD);
    layer_product<BF, kChain>(W + L.off_w(l), true, L.hp(l - 1), L.h(l),
                              L.h(l - 1), cur, other, nullptr,
                              acts + (size_t)below * LD, nullptr, 0, drop,
                              dscale, slab, BN, LD);
    __syncthreads();
    float* tmp = cur;
    cur = other;
    other = tmp;
    row = below;
  }
  return cur;
}

struct Smem {
  float* slab;
  uint32_t* hash;
  float* grow;
  float* tile;
};

__device__ Smem carve(float* smem, float* scratch, size_t block, int BN,
                      int rows, int LD) {
  Smem m;
  m.slab = smem;
  m.hash = reinterpret_cast<uint32_t*>(smem + 2 * kSlab * pass_units(BN));
  m.grow = smem + 2 * kSlab * pass_units(BN) + BN;
  m.tile = scratch ? scratch + block * (size_t)rows * LD
                   : smem + fixed_floats(BN);
  return m;
}

__device__ int widest_rows(const LayoutTable& L) {
  int wr = 0;
  for (int l = 0; l < L.n(); ++l) wr = max(wr, pad16(L.h(l)));
  return wr;
}

__device__ int sum_rows(const LayoutTable& L) {
  int s = 0;
  for (int l = 0; l < L.n(); ++l) s += pad16(L.h(l));
  return s;
}

// -- the three kernels --------------------------------------------------------

// out [S, T, N]: a persistent grid over the S·T·⌈N/BN⌉ cells
template <typename PX, bool BF>
__global__ void __launch_bounds__(kThreads)
    fwd_stream_kernel(const PX* __restrict__ x, const float* __restrict__ zp,
                      const float* __restrict__ params, float* __restrict__ out,
                      float* scratch, LayoutTable L, int S, int T, int N,
                      Dropout drop, int BN, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int LD = BN + 4;
  const Smem m = carve(smem, scratch, blockIdx.x, BN, rows, LD);
  const int F = L.F(), P = L.P(), H1 = L.h(0), nl = L.n();
  const int wr = widest_rows(L);
  float* X = m.tile;
  float* acts = m.tile + (size_t)pad16(F) * LD;
  const int tiles = (N + BN - 1) / BN;
  const long long cells = (long long)S * T * tiles;
  for (long long c = blockIdx.x; c < cells; c += gridDim.x) {
    const int tile = (int)(c % tiles);
    const int t = (int)((c / tiles) % T);
    const int s = (int)(c / ((long long)tiles * T));
    const int n0 = tile * BN;
    __syncthreads();  // the last cell's readers are done
    stage_x(X, x, T, F, N, t, n0, BN, LD);
    stage_hash(m.hash, drop, s, t, n0, BN);
    __syncthreads();
    const float* W = params + (size_t)s * P;
    const float* top =
        forward_cell<BF>(L, W, zp + ((size_t)s * T + t) * H1, X, acts, wr,
                         false, m.hash, drop, m.slab, BN, LD);
    const float* kout = W + L.off_kout();
    const float bout = __ldg(W + L.off_bout());
    const int HL = L.h(nl - 1);
    for (int n = threadIdx.x; n < BN; n += kThreads) {
      if (n0 + n >= N) continue;
      float a = 0.f;
      for (int j = 0; j < HL; ++j)
        a = fmaf(__ldg(kout + j), rd<BF>(top[(size_t)j * LD + n]), a);
      out[((size_t)s * T + t) * N + n0 + n] = a + bout;
    }
  }
}

// grad_part [S, G, P] and dzp_part [S, G, T, H1]: block (g, s) walks member
// s's T·⌈N/BN⌉ cells g, g + G, ... and adds into its own slices
template <typename PX, bool BF>
__global__ void __launch_bounds__(kThreads)
    bwd_stream_kernel(const PX* __restrict__ x, const float* __restrict__ zp,
                      const float* __restrict__ params,
                      const float* __restrict__ g, float* grad_part,
                      float* dzp_part, float* scratch, LayoutTable L, int T,
                      int N, Dropout drop, int BN, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int LD = BN + 4;
  const int G = gridDim.x, gb = blockIdx.x, s = blockIdx.y;
  const Smem m = carve(smem, scratch, (size_t)s * G + gb, BN, rows, LD);
  const int F = L.F(), P = L.P(), H1 = L.h(0), nl = L.n();
  const int wr = widest_rows(L), sr = sum_rows(L);
  float* X = m.tile;
  float* acts = m.tile + (size_t)pad16(F) * LD;
  float* dh0 = acts + (size_t)sr * LD;
  float* dh1 = dh0 + (size_t)wr * LD;
  float* gp = grad_part + ((size_t)s * G + gb) * P;
  const float dscale = drop.on ? drop.scale : 1.f;
  const float* W = params + (size_t)s * P;
  const int tiles = (N + BN - 1) / BN;
  const int cells = T * tiles;
  for (int c = gb; c < cells; c += G) {
    const int tile = c % tiles, t = c / tiles, n0 = tile * BN;
    __syncthreads();
    stage_x(X, x, T, F, N, t, n0, BN, LD);
    stage_hash(m.hash, drop, s, t, n0, BN);
    for (int n = threadIdx.x; n < BN; n += kThreads)
      m.grow[n] = n0 + n < N ? __ldg(g + ((size_t)s * T + t) * N + n0 + n)
                             : 0.f;
    __syncthreads();
    const float* top =
        forward_cell<BF>(L, W, zp + ((size_t)s * T + t) * H1, X, acts, wr,
                         true, m.hash, drop, m.slab, BN, LD);
    // dkout (unrounded activations × g) and dbout
    const int HL = L.h(nl - 1);
    for (int j = threadIdx.x; j < HL; j += kThreads) {
      float a = 0.f;
      for (int n = 0; n < BN; ++n)
        a = fmaf(top[(size_t)j * LD + n], m.grow[n], a);
      gp[L.off_kout() + j] += a;
    }
    if (threadIdx.x == 0) {
      float a = 0.f;
      for (int n = 0; n < BN; ++n) a += m.grow[n];
      gp[L.off_bout()] += a;
    }
    const float* dhp0 = chain_cell<BF>(
        L, W, acts, m.grow, dh0, dh1, dscale, drop, m.slab, BN, LD,
        [&](int l, const float* dhp, const float* below) {
          grad_product<BF>(dhp, L.h(l), below, L.h(l - 1), gp + L.off_w(l),
                           L.hp(l - 1), BN, LD);
          row_sums(dhp, L.h(l), gp + L.off_b(l), BN, LD);
        });
    // dK1 [F][hp0] and dzp
    grad_product<BF>(X, F, dhp0, H1, gp, L.hp(0), BN, LD);
    row_sums(dhp0, H1, dzp_part + (((size_t)s * G + gb) * T + t) * H1, BN,
             LD);
  }
}

// dx [T, F, N] in the panel's dtype: a persistent grid over the T·⌈N/BN⌉
// cells, each for all S members (they share the panel)
template <typename PX, bool BF>
__global__ void __launch_bounds__(kThreads)
    dx_stream_kernel(const PX* __restrict__ x, const float* __restrict__ zp,
                     const float* __restrict__ params,
                     const float* __restrict__ g, PX* __restrict__ dx,
                     float* scratch, LayoutTable L, int S, int T, int N,
                     Dropout drop, int BN, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int LD = BN + 4;
  const Smem m = carve(smem, scratch, blockIdx.x, BN, rows, LD);
  const int F = L.F(), P = L.P(), H1 = L.h(0);
  const int wr = widest_rows(L), sr = sum_rows(L);
  float* X = m.tile;
  float* acts = m.tile + (size_t)pad16(F) * LD;
  float* dh0 = acts + (size_t)sr * LD;
  float* dh1 = dh0 + (size_t)wr * LD;
  float* acc = dh1 + (size_t)wr * LD;
  const float dscale = drop.on ? drop.scale : 1.f;
  const int tiles = (N + BN - 1) / BN;
  const int cells = T * tiles;
  for (int c = blockIdx.x; c < cells; c += gridDim.x) {
    const int tile = c % tiles, t = c / tiles, n0 = tile * BN;
    __syncthreads();
    stage_x(X, x, T, F, N, t, n0, BN, LD);
    for (int i = threadIdx.x; i < pad16(F) * BN; i += kThreads)
      acc[(size_t)(i / BN) * LD + i % BN] = 0.f;
    for (int s = 0; s < S; ++s) {
      stage_hash(m.hash, drop, s, t, n0, BN);
      for (int n = threadIdx.x; n < BN; n += kThreads)
        m.grow[n] = n0 + n < N ? __ldg(g + ((size_t)s * T + t) * N + n0 + n)
                               : 0.f;
      __syncthreads();
      const float* W = params + (size_t)s * P;
      forward_cell<BF>(L, W, zp + ((size_t)s * T + t) * H1, X, acts, wr,
                       true, m.hash, drop, m.slab, BN, LD);
      const float* dhp0 =
          chain_cell<BF>(L, W, acts, m.grow, dh0, dh1, dscale, drop, m.slab,
                         BN, LD, [](int, const float*, const float*) {});
      // dx += K1 · dh_pre of the first layer: W(k = j, u = f) = k1[f][j]
      layer_product<BF, kAccum>(W, false, L.hp(0), H1, F, dhp0, acc, nullptr,
                                nullptr, nullptr, 0, drop, 1.f, m.slab, BN,
                                LD);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < F * BN; i += kThreads) {
      const int f = i / BN, n = i - f * BN;
      if (n0 + n < N)
        panel::st(dx + ((size_t)t * F + f) * N + n0 + n,
                  acc[(size_t)f * LD + n]);
    }
  }
}

// -- the host side ---------------------------------------------------------------

template <typename PX, bool BF>
const void* kernel_for() {
#if SDF_FFN_STREAM_KERNEL == 0
  return (const void*)fwd_stream_kernel<PX, BF>;
#elif SDF_FFN_STREAM_KERNEL == 1
  return (const void*)bwd_stream_kernel<PX, BF>;
#else
  return (const void*)dx_stream_kernel<PX, BF>;
#endif
}

const void* kernel_of(int bf16, int xb16) {
  if (xb16)
    return bf16 ? kernel_for<__nv_bfloat16, true>()
                : kernel_for<__nv_bfloat16, false>();
  return bf16 ? kernel_for<float, true>() : kernel_for<float, false>();
}

// 0 if the card takes the kernel at `smem` bytes: resident blocks per SM,
// registers and local-memory bytes per thread; else a cudaError_t value
int kernel_info(int bf16, int xb16, size_t smem, int* blocks, int* regs,
                int* local_bytes) {
  const void* kern = kernel_of(bf16, xb16);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// the tile rows of `layout` (host ints), or kUnsupported for a layout or
// (tile, smem, where the tiles live) this file does not take
int check_plan(const int* layout, int tile, long long smem_bytes,
               int in_scratch, int* rows) {
  const int n = layout[0], F = layout[1];
  if (n < 1 || F < 1) return kUnsupported;
  if (tile != 16 && tile != 32 && tile != 64) return kUnsupported;
  *rows = tile_rows(SDF_FFN_STREAM_KERNEL, n, F, layout + 5);
  const long long floats =
      fixed_floats(tile) + (in_scratch ? 0LL : (long long)*rows * (tile + 4));
  if (smem_bytes != 4 * floats || smem_bytes > kMaxSmem) return kUnsupported;
  return 0;
}

}  // namespace

// Registers per thread of this library's kernel under bf16 (1) or f32 (0)
// compute on a bf16 (xb16 1) or f32 panel.
extern "C" int sdf_ffn_stream_registers(int bf16, int xb16) {
  int info[3] = {0, 0, 0};
  if (kernel_info(bf16, xb16, 0, &info[0], &info[1], &info[2]) != 0)
    return kUnsupported;
  return info[1];
}

// What the card makes of a plan (tile, shared memory, the tiles in scratch
// or not): resident blocks per SM, registers and local-memory bytes per
// thread into out[3]; 0, or kUnsupported / a cudaError_t value.
extern "C" int sdf_ffn_stream_plan_info(const int* layout, int bf16,
                                        int tile, long long smem_bytes,
                                        int in_scratch, int xb16, int* out) {
  int rows = 0;
  const int rc = check_plan(layout, tile, smem_bytes, in_scratch, &rows);
  if (rc != 0) return rc;
  return kernel_info(bf16, xb16, (size_t)smem_bytes, &out[0], &out[1],
                     &out[2]);
}

namespace {

// the common checks of a launch: the plan, the card's residency, the grid;
// opens the kernel to its shared memory
int prepare(const int* layout, int bf16, int xb16, int tile,
            long long smem_bytes, const float* scratch, int G, int* rows) {
  if (G < 1) return kUnsupported;
  int rc = check_plan(layout, tile, smem_bytes, scratch != nullptr, rows);
  if (rc != 0) return rc;
  int info[3] = {0, 0, 0};
  rc = kernel_info(bf16, xb16, (size_t)smem_bytes, &info[0], &info[1],
                   &info[2]);
  if (rc != 0) return rc;
  return info[0] >= 1 ? 0 : kUnsupported;
}

}  // namespace

#if SDF_FFN_STREAM_KERNEL == 0
// out [S, T, N] f32 on `stream`; scratch: G blocks' tile buffers ([G][rows]
// [tile + 4] floats) or null (in shared memory)
extern "C" int sdf_ffn_fwd_stream(const void* x, int xb16, const float* zp,
                                  const float* params, float* out,
                                  float* scratch, const int* layout,
                                  const int* layout_dev, int S, int T, int N,
                                  int bf16, int dropout,
                                  const unsigned int* member_base,
                                  unsigned int threshold, float scale,
                                  unsigned int offset, int tile,
                                  long long smem_bytes, int G, void* stream) {
  if (S < 1 || T < 1 || N < 1) return kUnsupported;
  int rows = 0;
  const int rc =
      prepare(layout, bf16, xb16, tile, smem_bytes, scratch, G, &rows);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xb16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (bf16)
      fwd_stream_kernel<__nv_bfloat16, true><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, out, scratch, L, S, T, N, drop, tile, rows);
    else
      fwd_stream_kernel<__nv_bfloat16, false><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, out, scratch, L, S, T, N, drop, tile, rows);
  } else {
    const float* xp = static_cast<const float*>(x);
    if (bf16)
      fwd_stream_kernel<float, true><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, out, scratch, L, S, T, N, drop, tile, rows);
    else
      fwd_stream_kernel<float, false><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, out, scratch, L, S, T, N, drop, tile, rows);
  }
  return (int)cudaGetLastError();
}
#elif SDF_FFN_STREAM_KERNEL == 1
// grad_part [S, G, P] and dzp_part [S, G, T, H1], zeroed by the caller; a
// grid of (G, S) blocks; scratch: the S·G blocks' tile buffers or null
extern "C" int sdf_ffn_bwd_stream(const void* x, int xb16, const float* zp,
                                  const float* params, const float* g,
                                  float* grad_part, float* dzp_part,
                                  float* scratch, const int* layout,
                                  const int* layout_dev, int S, int T, int N,
                                  int bf16, int dropout,
                                  const unsigned int* member_base,
                                  unsigned int threshold, float scale,
                                  unsigned int offset, int tile,
                                  long long smem_bytes, int G, void* stream) {
  if (S < 1 || T < 1 || N < 1) return kUnsupported;
  int rows = 0;
  const int rc =
      prepare(layout, bf16, xb16, tile, smem_bytes, scratch, G, &rows);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, S);
  if (xb16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (bf16)
      bwd_stream_kernel<__nv_bfloat16, true><<<grid, kThreads, smem_bytes, st>>>(
          xp, zp, params, g, grad_part, dzp_part, scratch, L, T, N, drop,
          tile, rows);
    else
      bwd_stream_kernel<__nv_bfloat16, false>
          <<<grid, kThreads, smem_bytes, st>>>(xp, zp, params, g, grad_part,
                                               dzp_part, scratch, L, T, N,
                                               drop, tile, rows);
  } else {
    const float* xp = static_cast<const float*>(x);
    if (bf16)
      bwd_stream_kernel<float, true><<<grid, kThreads, smem_bytes, st>>>(
          xp, zp, params, g, grad_part, dzp_part, scratch, L, T, N, drop,
          tile, rows);
    else
      bwd_stream_kernel<float, false><<<grid, kThreads, smem_bytes, st>>>(
          xp, zp, params, g, grad_part, dzp_part, scratch, L, T, N, drop,
          tile, rows);
  }
  return (int)cudaGetLastError();
}
#else
// dx [T, F, N] in the panel's dtype, summed over the S members; scratch:
// the G blocks' tile buffers or null
extern "C" int sdf_ffn_dx_stream(const void* x, int xb16, const float* zp,
                                 const float* params, const float* g,
                                 void* dx, float* scratch, const int* layout,
                                 const int* layout_dev, int S, int T, int N,
                                 int bf16, int dropout,
                                 const unsigned int* member_base,
                                 unsigned int threshold, float scale,
                                 unsigned int offset, int tile,
                                 long long smem_bytes, int G, void* stream) {
  if (S < 1 || T < 1 || N < 1) return kUnsupported;
  int rows = 0;
  const int rc =
      prepare(layout, bf16, xb16, tile, smem_bytes, scratch, G, &rows);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xb16) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* dp = static_cast<__nv_bfloat16*>(dx);
    if (bf16)
      dx_stream_kernel<__nv_bfloat16, true><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, g, dp, scratch, L, S, T, N, drop, tile, rows);
    else
      dx_stream_kernel<__nv_bfloat16, false><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, g, dp, scratch, L, S, T, N, drop, tile, rows);
  } else {
    const float* xp = static_cast<const float*>(x);
    float* dp = static_cast<float*>(dx);
    if (bf16)
      dx_stream_kernel<float, true><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, g, dp, scratch, L, S, T, N, drop, tile, rows);
    else
      dx_stream_kernel<float, false><<<G, kThreads, smem_bytes, st>>>(
          xp, zp, params, g, dp, scratch, L, S, T, N, drop, tile, rows);
  }
  return (int)cudaGetLastError();
}
#endif
