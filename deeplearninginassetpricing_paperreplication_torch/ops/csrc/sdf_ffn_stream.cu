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
// read). It is the simple route that is right for every shape: the f32
// panel cotangent's, the scratch-tile stacks' and the deep narrow stacks'
// route (route 2 f32, route 3 bf16), and the bit-for-bit reference of route
// 5 on the same plan. Its 4 × 4 tiles a thread do two 16-byte shared loads
// for 16 FMAs, so shared memory, not the FMA pipes, sets its pace.
//
// Under bf16 compute each kernel has a tensor-core route of its own
// (fwd_stream_mma_kernel, bwd_stream_mma_kernel, dx_stream_mma_kernel, below:
// bf16 tiles, mma.sync products, bf16 weight slabs), planned wherever its
// tiles fit shared memory; the kernels above stay the f32 route and the bf16
// route of the stacks whose tiles go to scratch or that are too deep. Under
// f32 compute every kernel has a register-tiled route of its own
// (fwd_stream_tiled_kernel, bwd_stream_tiled_kernel, dx_stream_tiled_kernel,
// route 5, below: route 2's values bit for bit, 512-thread blocks of larger
// register tiles, a three-stage cp.async ring, the tile in shared memory),
// planned wherever its tile fits, but for the forward and the panel
// cotangent of stacks at most 64 units wide where route 2 takes tile 64.
//
// One library per kernel: -DSDF_FFN_STREAM_KERNEL=0 (forward), 1 (backward),
// 2 (panel cotangent), each holding the four (panel dtype × compute dtype)
// instances of its kernel, the two (panel dtype) instances of its
// tensor-core kernel and the four (panel dtype × stock tile) instances of
// its register-tiled kernel. The panel
// cotangent's audit build (-DSDF_FFN_DX_AUDIT beside =2, its own library)
// also counts its tensor-core kernel's top-layer decisions against the exact
// chain; its dx is the main library's, bit for bit.
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
// past F and past N, by a block of NT threads
template <typename PX, int NT = kThreads>
__device__ void stage_x(float* X, const PX* __restrict__ x, int T, int F,
                        int N, int t, int n0, int BN, int LD) {
  const int RF = pad16(F);
  for (int i = threadIdx.x; i < RF * BN; i += NT) {
    const int f = i / BN, n = i - f * BN;
    float v = 0.f;
    if (f < F && n0 + n < N)
      v = panel::ldx(x + ((size_t)t * F + f) * N + n0 + n);
    X[(size_t)f * LD + n] = v;
  }
}

// the tile's dropout row hashes of member s at period t (a block of NT
// threads)
template <int NT = kThreads>
__device__ void stage_hash(uint32_t* hash, const Dropout& drop, int s, int t,
                           int n0, int BN) {
  if (!drop.on) return;
  for (int n = threadIdx.x; n < BN; n += NT)
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

// -- the tensor-core route: bf16 compute ---------------------------------------
//
// Under bf16 compute every product reads its operands rounded to bf16, so the
// tiles hold bf16 ([rows][BN + 8] bf16 bits, feature-major, each layer's rows
// padded to 16 and zero past its width): exactly what the products read, in
// half the bytes, twice the stocks a block. The three values the plain route
// reads unrounded come from the f32 accumulators in the epilogues instead:
// the top layer's activations in dkout, and dh_pre in the bias gradients and
// in dzp. The ReLU × dropout factor is read back from a tile as act > 0, as
// from the f32 tiles: a positive activation that rounds to bf16 zero (below
// 2^-133) is stored as -0 (bits 0x8000), which every product reads as 0, so
// the factor is "bits != 0" and exact.
//
// Products run on mma.sync.m16n8k16 (bf16 operands, f32 accumulators): a warp
// owns 64 output units × 32 stocks (4 × 4 fragments), the block's 8 warps
// BN/32 along the stocks and the rest along the units, so one pass covers
// UC = 16384/BN units. Weights stream as bf16 from a copy in the products'
// [units][inputs] orientation (ops/sdf_ffn.py stream_mma_weights: each
// layer's matrix and, for the dh chain, its transpose; wtab holds each one's
// offset and row length), in slabs of kMmaSlab inputs × UC units through a
// three-stage cp.async ring (16-byte copies, one __syncthreads a slab). The
// forward and the backward's recompute run the same routine with the same
// k-step order, so a ReLU decision never differs between the loss and its
// gradient. The weight gradients run on mma.sync too (M the gradient's rows,
// N its columns, K the cell's BN stocks); each cell's partial is added into
// the block's grad_part slice in 16-byte vectors, every element always by the
// same thread (repeatable bit for bit, no atomics).
//
// What bounds it: the tensor cores (operations). On an H100 at (256, 256),
// T = 48, N = 10,000 the forward runs 21.7× and the backward 32× from that
// bound: one 8-warp block an SM (180 / 237 registers), a __syncthreads a
// slab, and in the backward each cell's read-add-write of its ~78,000-float
// gradient partial (not measured apart). Under f32 compute the register-
// tiled route 5 (below) takes the same stacks.

constexpr int kMmaSlab = 32;           // inputs per bf16 weight slab
constexpr int kMmaStages = 3;          // slabs in flight
constexpr int kSlabLd = kMmaSlab + 8;  // bf16 a slab row: 80 B, so the 8
                                       // rows of an ldmatrix hit distinct banks
constexpr int kRed = 512;              // floats of the cross-warp sums
constexpr unsigned kFull = 0xffffffffu;

typedef uint16_t bfbits;  // a bf16 value's bits in the tiles and slabs

// units one pass of the tensor-core route computes at stock tile BN
__host__ __device__ __forceinline__ int mma_pass_units(int BN) {
  return 64 * (8 / (BN / 32));
}

// shared-memory bytes of a tensor-core block: the slab ring, the row hashes,
// the g row, the cross-warp sums, then `rows` tile rows of BN + 8 bf16
__host__ __device__ inline long long mma_smem_bytes(int BN, int rows,
                                                    int SU) {
  return 2LL * kMmaStages * SU * kSlabLd + 8LL * BN + 4LL * kRed +
         2LL * rows * (BN + 8);
}

__device__ __forceinline__ uint32_t bf_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// a non-negative activation's bits: 0 unless it is positive, then rounded to
// bf16, with -0 standing for a positive value that rounds to zero
__device__ __forceinline__ uint32_t act_bits(float a) {
  if (!(a > 0.f)) return 0u;
  const uint32_t b = bf_bits(a);
  return b ? b : 0x8000u;
}

__device__ __forceinline__ float unbits(bfbits b) {
  return __uint_as_float((uint32_t)b << 16);
}

// a warp's place in the block's products at stock tile BN
struct MmaWarp {
  int wn, wu, UC, lane, g, t;
  __device__ explicit MmaWarp(int BN) {
    const int warp = threadIdx.x >> 5, WN = BN >> 5;
    wn = warp % WN;
    wu = warp / WN;
    UC = mma_pass_units(BN);
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
  }
};

// what a layer product's epilogue does with its sums
enum MmaEpilogue {
  kMmaAct = 0,    // + bias, ReLU, dropout, act_bits: a hidden layer
  kMmaChain = 1,  // × dscale where the layer below's bits are nonzero: dh_pre
  kMmaTop = 2,    // the panel cotangent's top layer: dh_pre, decisions
                  // certified against the exact chain (DxTopOut)
  kMmaAccum = 3,  // added into the panel cotangent's f32 tile (DxAccOut)
};

struct MmaOut {
  const float* bias;     // kMmaAct: [Uout] f32
  const uint32_t* hash;  // kMmaAct: the tile's dropout row hashes
  int layer;
  Dropout drop;
  const bfbits* below;   // kMmaChain: the layer below's activation tile
  float dscale;
  const float* grow;     // kMmaAct: the g row (dkout), or null
  float* rsum;           // row sums' destination (read-add-write), or null
};

// rs[mt][h]: a thread's sums of its rows (mt, g + 8h) over its stocks;
// summed over the warp's 32 stocks, then over the warps of the same units in
// a fixed order, and added to dst[u] for u < Uout, u in the pass at u0
__device__ void finish_row_sums(float (&rs)[4][2], const MmaWarp& w, int BN,
                                int u0, int RU, int Uout, float* red,
                                float* dst) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = rs[mt][h];
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      rs[mt][h] = s;
    }
  if (w.t == 0) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int ul = w.wu * 64 + mt * 16 + w.g;
      if (u0 + ul < RU) {
        red[w.wn * w.UC + ul] = rs[mt][0];
        red[w.wn * w.UC + ul + 8] = rs[mt][1];
      }
    }
  }
  __syncthreads();
  const int WN = BN >> 5, rows = min(w.UC, RU - u0);
  for (int ul = threadIdx.x; ul < rows; ul += kThreads) {
    if (u0 + ul >= Uout) continue;
    float s = 0.f;
    for (int q = 0; q < WN; ++q) s += red[q * w.UC + ul];
    dst[u0 + ul] += s;
  }
  __syncthreads();
}

// the epilogue of one pass (units from u0) of a layer product
template <int EPI>
__device__ void mma_epilogue(const float (&acc)[4][4][4], const MmaWarp& w,
                             int u0, int RU, int Uout, bfbits* out,
                             const MmaOut& e, float* red, int BN) {
  const int LDH = BN + 8;
  float rs[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int ub = u0 + w.wu * 64 + mt * 16;
    if (ub >= RU) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = ub + w.g + 8 * h;
      const bool in = u < Uout;
      const float bias =
          (EPI == kMmaAct && in) ? __ldg(e.bias + u) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = w.wn * 32 + nt * 8 + 2 * w.t;
        float v0 = 0.f, v1 = 0.f;
        uint32_t b0, b1;
        if (EPI == kMmaAct) {
          if (in) {
            v0 = fmaxf(acc[mt][nt][2 * h] + bias, 0.f);
            v1 = fmaxf(acc[mt][nt][2 * h + 1] + bias, 0.f);
            if (e.drop.on) {
              v0 = sdf_ffn::keep_unit(e.hash[n], e.layer, u,
                                      e.drop.threshold)
                       ? v0 * e.drop.scale
                       : 0.f;
              v1 = sdf_ffn::keep_unit(e.hash[n + 1], e.layer, u,
                                      e.drop.threshold)
                       ? v1 * e.drop.scale
                       : 0.f;
            }
          }
          b0 = act_bits(v0);
          b1 = act_bits(v1);
          if (e.grow)
            rs[mt][h] = fmaf(v1, e.grow[n + 1], fmaf(v0, e.grow[n], rs[mt][h]));
        } else {
          if (in) {
            const uint32_t f = *reinterpret_cast<const uint32_t*>(
                e.below + (size_t)u * LDH + n);
            if (f & 0xffffu) v0 = acc[mt][nt][2 * h] * e.dscale;
            if (f >> 16) v1 = acc[mt][nt][2 * h + 1] * e.dscale;
          }
          b0 = bf_bits(v0);
          b1 = bf_bits(v1);
          rs[mt][h] = (rs[mt][h] + v0) + v1;
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)u * LDH + n) =
            b0 | (b1 << 16);
      }
    }
  }
  if (e.rsum) finish_row_sums(rs, w, BN, u0, RU, Uout, red, e.rsum);
}

// kMmaTop: the top layer of the panel cotangent
struct DxTopOut {
  const float* bias;     // [Uout] f32 (the zp row in a one-layer stack)
  const uint32_t* hash;  // the tile's dropout row hashes
  int layer;
  Dropout drop;
  const float* kout;     // [Uout], bf16 values
  const float* grow;     // the g row
  float dscale;
  const float* amax;     // [BN]: max_k |in[k][n]| of each stock
  const float* wabs;     // [Uout]: Σ_k |A[u][k]|
  float window;          // certify_window(Kin)
  const bfbits* A;       // the product's matrix and its row length, input
  int lda;               // tile and depth (the exact chain reads them)
  const bfbits* in;
  int Kin;
  int n0, N;             // the tile's first stock, the stocks (the audit)
};

// kMmaAccum: the panel cotangent's dx product
struct DxAccOut {
  float* acc;  // [pad16(F)][BN + 4] f32, summed over the members
};

// the panel cotangent's epilogues, defined with its kernel below
template <int EPI>
__device__ void mma_epilogue(const float (&acc)[4][4][4], const MmaWarp& w,
                             int u0, int RU, int Uout, bfbits* out,
                             const DxTopOut& e, float* red, int BN);
template <int EPI>
__device__ void mma_epilogue(const float (&acc)[4][4][4], const MmaWarp& w,
                             int u0, int RU, int Uout, bfbits* out,
                             const DxAccOut& e, float* red, int BN);

// out[u][n] (u < pad16(Uout), n < BN, bf16) from Σ_k A[u][k]·in[k][n] over
// k < Kin: A the bf16 copy's [units][lda] matrix (zero past the layer), `in`
// a tile of pad16(Kin) rows (zero from Kin). Slab i of the ring holds units
// [p·UC, +UC) × inputs [kb·kMmaSlab, +kMmaSlab) of pass p; the epilogue of
// pass p (EPI, with `e` of its kind) runs after its last slab. Every thread
// of the block calls it; it ends synchronised.
template <int EPI, typename Out>
__device__ void layer_product_mma(const bfbits* __restrict__ A, int lda,
                                  int Kin, int Uout, const bfbits* in,
                                  bfbits* out, const Out& e, bfbits* slab,
                                  int SU, float* red, int BN) {
  const MmaWarp w(BN);
  const int LDH = BN + 8;
  const int RU = pad16(Uout), KP = pad16(Kin);
  const int nk = (KP + kMmaSlab - 1) / kMmaSlab;
  const int total = ((RU + w.UC - 1) / w.UC) * nk;
  auto issue = [&](int i) {
    if (i < total) {
      const int p = i / nk, kb = i - p * nk;
      const int u0 = p * w.UC, k0 = kb * kMmaSlab;
      const int rows = min(w.UC, RU - u0);
      bfbits* dst = slab + (size_t)(i % kMmaStages) * SU * kSlabLd;
      for (int c = threadIdx.x; c < rows * (kMmaSlab / 8); c += kThreads) {
        const int r = c / (kMmaSlab / 8), q = c % (kMmaSlab / 8);
        sdf_ffn::cp_async16(
            reinterpret_cast<float*>(dst + r * kSlabLd + q * 8),
            reinterpret_cast<const float*>(A + (size_t)(u0 + r) * lda + k0 +
                                           q * 8),
            16);
      }
    }
    sdf_ffn::cp_async_commit();
  };
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  issue(0);
  issue(1);
  for (int i = 0; i < total; ++i) {
    sdf_ffn::cp_async_wait<1>();
    __syncthreads();  // slab i landed; every warp is done with slab i - 1
    issue(i + 2);
    const int p = i / nk, kb = i - p * nk;
    const int u0 = p * w.UC, k0 = kb * kMmaSlab;
    const int ub = u0 + w.wu * 64;  // the warp's first unit
    if (ub < RU) {
      const bfbits* s = slab + (size_t)(i % kMmaStages) * SU * kSlabLd +
                        (w.wu * 64) * kSlabLd;
      const int steps = min(kMmaSlab, KP - k0) >> 4;
      for (int ks = 0; ks < steps; ++ks) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (ub + 16 * mt < RU)
            sdf_ffn::ldsm_x4(a[mt], reinterpret_cast<const uint32_t*>(
                                        s + (mt * 16 + (w.lane & 15)) * kSlabLd +
                                        ks * 16 + (w.lane >> 4) * 8));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t r[4];
          sdf_ffn::ldsm_x4_t(
              r, reinterpret_cast<const uint32_t*>(
                     in + (size_t)(k0 + ks * 16 + (w.lane & 15)) * LDH +
                     w.wn * 32 + q * 16 + (w.lane >> 4) * 8));
          b[2 * q][0] = r[0];
          b[2 * q][1] = r[1];
          b[2 * q + 1][0] = r[2];
          b[2 * q + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (ub + 16 * mt < RU)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              sdf_ffn::mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
    }
    if (kb == nk - 1) {
      mma_epilogue<EPI>(acc, w, u0, RU, Uout, out, e, red, BN);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    }
  }
  __syncthreads();
}

// gp[a·ldg + b] += Σ_n A[a][n]·B[b][n] for a < Ra, b < Rb over the cell's BN
// stocks (bf16 tiles; a weight gradient's partial): warp tiles of 64 rows ×
// 32 columns, the sums added in 16-byte vectors (lanes t and t ^ 1 trade
// halves: the even one takes row g, the odd one row g + 8). Only global
// memory is written.
__device__ void grad_product_mma(const bfbits* A, int Ra, const bfbits* B,
                                 int Rb, float* gp, int ldg, int BN) {
  const int LDH = BN + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const int RA = pad16(Ra), RB = pad16(Rb);
  const int ta = (RA + 63) >> 6, tb = (RB + 31) >> 5;
  for (int wt = warp; wt < ta * tb; wt += kThreads / 32) {
    const int a0 = (wt / tb) * 64, b0 = (wt % tb) * 32;
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
    for (int k0 = 0; k0 < BN; k0 += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        if (a0 + 16 * mt < RA)
          sdf_ffn::ldsm_x4(a[mt], reinterpret_cast<const uint32_t*>(
                                      A + (size_t)(a0 + 16 * mt + (lane & 15)) *
                                              LDH +
                                      k0 + (lane >> 4) * 8));
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (b0 + 16 * q < RB) {
          uint32_t r[4];
          sdf_ffn::ldsm_x4(
              r, reinterpret_cast<const uint32_t*>(
                     B +
                     (size_t)(b0 + 16 * q + (lane & 7) + ((lane >> 4) << 3)) *
                         LDH +
                     k0 + ((lane >> 3) & 1) * 8));
          b[2 * q][0] = r[0];
          b[2 * q][1] = r[1];
          b[2 * q + 1][0] = r[2];
          b[2 * q + 1][1] = r[3];
        }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (a0 + 16 * mt < RA && b0 + 8 * nt < RB)
            sdf_ffn::mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (a0 + 16 * mt >= RA) continue;
      const int a = a0 + 16 * mt + g + (odd ? 8 : 0);
      float4 v[4], o[4];
      bool ok[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        ok[nt] = false;
        if (b0 + 8 * nt >= RB) continue;
        const float* c = acc[mt][nt];
        const float r0 = __shfl_xor_sync(kFull, odd ? c[0] : c[2], 1);
        const float r1 = __shfl_xor_sync(kFull, odd ? c[1] : c[3], 1);
        v[nt] = odd ? make_float4(r0, r1, c[2], c[3])
                    : make_float4(c[0], c[1], r0, r1);
        ok[nt] = a < Ra && b0 + 8 * nt + 4 * (t >> 1) < Rb;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (ok[nt])
          o[nt] = *reinterpret_cast<const float4*>(
              gp + (size_t)a * ldg + b0 + 8 * nt + 4 * (t >> 1));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (ok[nt]) {
          o[nt].x += v[nt].x;
          o[nt].y += v[nt].y;
          o[nt].z += v[nt].z;
          o[nt].w += v[nt].w;
          *reinterpret_cast<float4*>(gp + (size_t)a * ldg + b0 + 8 * nt +
                                     4 * (t >> 1)) = o[nt];
        }
    }
  }
}

// dh_pre of the top layer, round(kout_j)·round(g_n)·dscale where its
// activation is nonzero (else 0), into dh (pad16(HL) rows, bf16), its f32 row
// sums added to dst[j]: a thread 8 stocks of a row, the BN/8 threads of a row
// adjacent lanes of one warp
__device__ void top_dh_mma(const bfbits* act, int HL,
                           const float* __restrict__ kout, const float* grow,
                           float dscale, bfbits* dh, float* dst, int BN) {
  const int LDH = BN + 8, per = BN / 8;
  const int items = pad16(HL) * per;
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x & ~31; base < items; base += kThreads) {
    const int i = base + lane;
    const int j = i / per, n = (i - j * per) * 8;
    float s = 0.f;
    if (i < items) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(act + (size_t)j * LDH + n);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const float k = j < HL ? sdf_ffn::round_bf16(__ldg(kout + j)) : 0.f;
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float d0 = 0.f, d1 = 0.f;
        if (j < HL && (av[q] & 0xffffu))
          d0 = k * sdf_ffn::round_bf16(grow[n + 2 * q]) * dscale;
        if (j < HL && (av[q] >> 16))
          d1 = k * sdf_ffn::round_bf16(grow[n + 2 * q + 1]) * dscale;
        s = (s + d0) + d1;
        o[q] = bf_bits(d0) | (bf_bits(d1) << 16);
      }
      *reinterpret_cast<uint4*>(dh + (size_t)j * LDH + n) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    for (int d = 1; d < per; d <<= 1) s += __shfl_xor_sync(kFull, s, d);
    if (i < items && i % per == 0 && j < HL) dst[j] += s;
  }
}

// the tile x[t][:, n0 : n0 + BN] rounded to bf16 into X [pad16(F)][BN + 8],
// zero past F and past N (a bf16 panel is copied as it is)
template <typename PX>
__device__ void stage_x_mma(bfbits* X, const PX* __restrict__ x, int F,
                            int N, int t, int n0, int BN) {
  const int RF = pad16(F), half = BN / 2, LDH = BN + 8;
  for (int i = threadIdx.x; i < RF * half; i += kThreads) {
    const int f = i / half, n = (i - f * half) * 2;
    float v0 = 0.f, v1 = 0.f;
    if (f < F) {
      const PX* p = x + ((size_t)t * F + f) * N + n0 + n;
      if (n0 + n < N) v0 = panel::ldx(p);
      if (n0 + n + 1 < N) v1 = panel::ldx(p + 1);
    }
    *reinterpret_cast<uint32_t*>(X + (size_t)f * LDH + n) =
        bf_bits(v0) | (bf_bits(v1) << 16);
  }
}

struct MmaSmem {
  bfbits* slab;
  uint32_t* hash;
  float* grow;
  float* red;
  bfbits* tile;
};

// the block's regions from `slab_bytes` of slab ring on
__device__ MmaSmem carve_mma_at(float* smem, int BN, int slab_bytes) {
  char* p = reinterpret_cast<char*>(smem);
  MmaSmem m;
  m.slab = reinterpret_cast<bfbits*>(p);
  p += slab_bytes;
  m.hash = reinterpret_cast<uint32_t*>(p);
  p += 4 * BN;
  m.grow = reinterpret_cast<float*>(p);
  p += 4 * BN;
  m.red = reinterpret_cast<float*>(p);
  p += 4 * kRed;
  m.tile = reinterpret_cast<bfbits*>(p);
  return m;
}

__device__ MmaSmem carve_mma(float* smem, int BN, int SU) {
  return carve_mma_at(smem, BN, 2 * kMmaStages * SU * kSlabLd);
}

// the cell's forward on the tensor cores, one layer at a time from X;
// returns the top layer's tile. `keep_all`: layer l's tile at acts + its row
// (the backward), else in the two buffers at acts, acts + wr rows. With
// `grow`, the top layer's epilogue adds Σ_n act·g (f32, unrounded) to dkout.
__device__ const bfbits* forward_cell_mma(
    const LayoutTable& L, const float* W, const bfbits* Wb, const int* wtab,
    const float* __restrict__ zp_row, const bfbits* X, bfbits* acts, int wr,
    bool keep_all, const uint32_t* hash, const Dropout& drop,
    const float* grow, float* dkout, bfbits* slab, int SU, float* red,
    int BN) {
  const int nl = L.n(), LDH = BN + 8;
  const bfbits* in = X;
  int Kin = L.F(), row = 0;
  for (int l = 0; l < nl; ++l) {
    const int H = L.h(l);
    bfbits* o = keep_all ? acts + (size_t)row * LDH
                         : acts + (size_t)((l & 1) * wr) * LDH;
    row += pad16(H);
    const bool top = l + 1 == nl;
    const MmaOut e{l ? W + L.off_b(l) : zp_row, hash, l, drop, nullptr, 1.f,
                   top ? grow : nullptr, top ? dkout : nullptr};
    layer_product_mma<kMmaAct>(Wb + __ldg(wtab + 4 * l),
                               __ldg(wtab + 4 * l + 1), Kin, H, in, o, e,
                               slab, SU, red, BN);
    in = o;
    Kin = H;
  }
  return in;
}

// the cell's dh chain on the tensor cores from g down to the first layer,
// and each layer's weight gradient and bias gradient on the way (dzp_row
// takes the first layer's row sums); returns dh_pre of the first layer
__device__ const bfbits* chain_cell_mma(
    const LayoutTable& L, const float* W, const bfbits* Wb, const int* wtab,
    const bfbits* acts, const float* grow, bfbits* dh0, bfbits* dh1,
    float dscale, const Dropout& drop, float* gp, float* dzp_row,
    bfbits* slab, int SU, float* red, int BN) {
  const int nl = L.n(), LDH = BN + 8;
  int top = 0;
  for (int l = 0; l + 1 < nl; ++l) top += pad16(L.h(l));
  top_dh_mma(acts + (size_t)top * LDH, L.h(nl - 1), W + L.off_kout(), grow,
             dscale, dh0, nl > 1 ? gp + L.off_b(nl - 1) : dzp_row, BN);
  __syncthreads();
  bfbits* cur = dh0;
  bfbits* other = dh1;
  int row = top;
  for (int l = nl - 1; l >= 1; --l) {
    const int below = row - pad16(L.h(l - 1));
    const bfbits* act = acts + (size_t)below * LDH;
    grad_product_mma(cur, L.h(l), act, L.h(l - 1), gp + L.off_w(l),
                     L.hp(l - 1), BN);
    const MmaOut e{nullptr, nullptr, 0, drop, act, dscale, nullptr,
                   l > 1 ? gp + L.off_b(l - 1) : dzp_row};
    layer_product_mma<kMmaChain>(Wb + __ldg(wtab + 4 * l + 2),
                                 __ldg(wtab + 4 * l + 3), L.h(l), L.h(l - 1),
                                 cur, other, e, slab, SU, red, BN);
    bfbits* tmp = cur;
    cur = other;
    other = tmp;
    row = below;
  }
  return cur;
}

// out [S, T, N]: a persistent grid over the S·T·⌈N/BN⌉ cells; wb [S][Pb]
// the members' bf16 weight copies
template <typename PX>
__global__ void __launch_bounds__(kThreads)
    fwd_stream_mma_kernel(const PX* __restrict__ x,
                          const float* __restrict__ zp,
                          const float* __restrict__ params,
                          const bfbits* __restrict__ wb,
                          const int* __restrict__ wtab, int Pb,
                          float* __restrict__ out, LayoutTable L, int S,
                          int T, int N, Dropout drop, int BN, int SU) {
  extern __shared__ __align__(16) float smem[];
  const int LDH = BN + 8;
  const MmaSmem m = carve_mma(smem, BN, SU);
  const int F = L.F(), P = L.P(), H1 = L.h(0), nl = L.n();
  const int wr = widest_rows(L);
  bfbits* X = m.tile;
  bfbits* acts = m.tile + (size_t)pad16(F) * LDH;
  const int tiles = (N + BN - 1) / BN;
  const long long cells = (long long)S * T * tiles;
  // the output product: the kThreads / BN threads of a stock split the units
  const int parts = kThreads / BN, n = threadIdx.x % BN,
            part = threadIdx.x / BN;
  for (long long c = blockIdx.x; c < cells; c += gridDim.x) {
    const int tile = (int)(c % tiles);
    const int t = (int)((c / tiles) % T);
    const int s = (int)(c / ((long long)tiles * T));
    const int n0 = tile * BN;
    __syncthreads();  // the last cell's readers are done
    stage_x_mma(X, x, F, N, t, n0, BN);
    stage_hash(m.hash, drop, s, t, n0, BN);
    __syncthreads();
    const float* W = params + (size_t)s * P;
    const bfbits* top = forward_cell_mma(
        L, W, wb + (size_t)s * Pb, wtab, zp + ((size_t)s * T + t) * H1, X,
        acts, wr, false, m.hash, drop, nullptr, nullptr, m.slab, SU, m.red,
        BN);
    const float* kout = W + L.off_kout();
    const int HL = L.h(nl - 1), span = (HL + parts - 1) / parts;
    float a = 0.f;
    for (int j = part * span; j < min(HL, (part + 1) * span); ++j)
      a = fmaf(__ldg(kout + j), unbits(top[(size_t)j * LDH + n]), a);
    m.red[part * BN + n] = a;
    __syncthreads();
    if (threadIdx.x < BN && n0 + n < N) {
      float o = 0.f;
      for (int q = 0; q < parts; ++q) o += m.red[q * BN + n];
      out[((size_t)s * T + t) * N + n0 + n] = o + __ldg(W + L.off_bout());
    }
  }
}

// grad_part [S, G, P] and dzp_part [S, G, T, H1]: block (g, s) walks member
// s's T·⌈N/BN⌉ cells g, g + G, ... and adds into its own slices
template <typename PX>
__global__ void __launch_bounds__(kThreads)
    bwd_stream_mma_kernel(const PX* __restrict__ x,
                          const float* __restrict__ zp,
                          const float* __restrict__ params,
                          const bfbits* __restrict__ wb,
                          const int* __restrict__ wtab, int Pb,
                          const float* __restrict__ g, float* grad_part,
                          float* dzp_part, LayoutTable L, int T, int N,
                          Dropout drop, int BN, int SU) {
  extern __shared__ __align__(16) float smem[];
  const int LDH = BN + 8;
  const int G = gridDim.x, gb = blockIdx.x, s = blockIdx.y;
  const MmaSmem m = carve_mma(smem, BN, SU);
  const int F = L.F(), P = L.P(), H1 = L.h(0);
  const int wr = widest_rows(L), sr = sum_rows(L);
  bfbits* X = m.tile;
  bfbits* acts = m.tile + (size_t)pad16(F) * LDH;
  bfbits* dh0 = acts + (size_t)sr * LDH;
  bfbits* dh1 = dh0 + (size_t)wr * LDH;
  float* gp = grad_part + ((size_t)s * G + gb) * P;
  const float dscale = drop.on ? drop.scale : 1.f;
  const float* W = params + (size_t)s * P;
  const bfbits* Wb = wb + (size_t)s * Pb;
  const int tiles = (N + BN - 1) / BN;
  const int cells = T * tiles;
  for (int c = gb; c < cells; c += G) {
    const int tile = c % tiles, t = c / tiles, n0 = tile * BN;
    __syncthreads();
    stage_x_mma(X, x, F, N, t, n0, BN);
    stage_hash(m.hash, drop, s, t, n0, BN);
    for (int n = threadIdx.x; n < BN; n += kThreads)
      m.grow[n] = n0 + n < N ? __ldg(g + ((size_t)s * T + t) * N + n0 + n)
                             : 0.f;
    __syncthreads();
    // the recompute, dkout (unrounded activations × g) in its top epilogue
    forward_cell_mma(L, W, Wb, wtab, zp + ((size_t)s * T + t) * H1, X, acts,
                     wr, true, m.hash, drop, m.grow, gp + L.off_kout(),
                     m.slab, SU, m.red, BN);
    if (threadIdx.x == 0) {
      float a = 0.f;
      for (int n = 0; n < BN; ++n) a += m.grow[n];
      gp[L.off_bout()] += a;
    }
    float* dzp_row = dzp_part + (((size_t)s * G + gb) * T + t) * H1;
    const bfbits* dhp0 =
        chain_cell_mma(L, W, Wb, wtab, acts, m.grow, dh0, dh1, dscale, drop,
                       gp, dzp_row, m.slab, SU, m.red, BN);
    // dK1 [F][hp0]
    grad_product_mma(X, F, dhp0, H1, gp, L.hp(0), BN);
  }
}

// -- the tensor-core route of the panel cotangent -----------------------------
//
// A panel cotangent does not sum over stocks, so one flipped ReLU decision
// moves a whole term of one stock's dx (5% of max|dx| in a CPU experiment,
// sdf_ffn_dx.cu, tools/dx_flip_sensitivity.py): the backward's decisions on
// mma.sync average such flips out, the dx's would not. So its decisions are
// route 3's, bit for bit, by sdf_ffn_dx.cu route 1's rule at streamed widths:
//
// - The layers below the top run route 3's chains on the CUDA cores
//   (layer_product_exact: an fmaf chain over the inputs in k order from 0 on
//   bf16 operands, whose products are exact in f32, then + bias, ReLU and
//   dropout), into bf16 tiles (act_bits). Their values and decisions are
//   route 3's.
// - The top layer runs on mma.sync; where |h| ≤ certify_window(Kin)·(max|a|
//   ·Σ_k|W_uk| + |b_u|) the lane recomputes the exact chain (its unit's row of
//   the bf16 copy, the stock's column of the input tile) and decides on it.
//   Its epilogue writes dh_pre = round(kout)·round(g)·dscale where the
//   decision is on; its activations are never stored.
// - The dh chain (W_lᵀ·dh_pre, × the factor read from the exact tile below,
//   written over that tile) and dx's K1·dh1_pre run on mma.sync: they decide
//   nothing, so another f32 sum order moves only a rounding of dh_pre. dx
//   sums the members in an f32 tile in member order, rounded once at the end.
//
// The window grows with the depth of the top layer's sum: sdf_ffn_dx.cu's
// 2^-16 was sized as eight times what an mma accumulation can move a sum
// over 64 inputs, so here it is 2^-16 per started 64 inputs (mirrored by
// ops/sdf_ffn.py stream_certify_window).
//
// What bounds it: the tensor cores (operations). On an H100 at (256, 256),
// F = 46, T = 48, N = 10,000, S = 9 it runs 24.7× from that bound: one
// 8-warp block an SM (228 registers), a __syncthreads a slab, layer 0 on the
// CUDA cores (about 8% of the multiply-adds), and in the K1 product at
// F = 46 half the warps idle (48 rows against a 128-unit pass).
constexpr float kCertify = 1.0f / 65536.0f;
constexpr int kCertifyDepth = 64;
constexpr float kCertifyFloor = 1e-30f;

__host__ __device__ inline float certify_window(int kin) {
  return kCertify * (float)((kin + kCertifyDepth - 1) / kCertifyDepth);
}

// shared memory of the dx's slab region: the bf16 ring of the mma products
// or the two f32 slabs of the exact layers (kSlab × pass_units(BN)), which
// never run at once
__host__ __device__ inline long long dx_mma_slab_bytes(int BN, int SU) {
  const long long ring = 2LL * kMmaStages * SU * kSlabLd;
  const long long f32 = 8LL * kSlab * pass_units(BN);
  return ring > f32 ? ring : f32;
}

// shared-memory bytes of a dx tensor-core block: the slab region, the row
// hashes, the g row, the cross-warp floats (the stocks' max|a|), then `rows`
// bf16 tile rows of BN + 8 (the panel tile, the layers below the top, the
// top's dh_pre) and the f32 dx tile [pad16(F)][BN + 4]
__host__ __device__ inline long long dx_mma_smem_bytes(int BN, int rows,
                                                       int F, int SU) {
  return dx_mma_slab_bytes(BN, SU) + 8LL * BN + 4LL * kRed +
         2LL * rows * (BN + 8) + 4LL * pad16(F) * (BN + 4);
}

// the plain version's pre-activation sum of unit row `a` (bf16, zero past
// Kin up to a multiple of 8) over the stock n of `in` (bf16 tile, zero past
// Kin up to pad16(Kin)): an fmaf chain over k in order from 0, route 3's
__device__ __forceinline__ float exact_chain_bits(const bfbits* __restrict__ a,
                                                  const bfbits* in, int n,
                                                  int Kin, int LDH) {
  float h = 0.f;
  for (int k = 0; k < Kin; k += 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(a + k));
    const uint32_t wv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h = fmaf(__uint_as_float(wv[i] << 16),
               unbits(in[(size_t)(k + 2 * i) * LDH + n]), h);
      h = fmaf(__uint_as_float(wv[i] & 0xffff0000u),
               unbits(in[(size_t)(k + 2 * i + 1) * LDH + n]), h);
    }
  }
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
  seen = __reduce_add_sync(kFull, seen);
  certified = __reduce_add_sync(kFull, certified);
  flips = __reduce_add_sync(kFull, flips);
  outside = __reduce_add_sync(kFull, outside);
  const unsigned wbits = __reduce_max_sync(kFull, __float_as_uint(worst));
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_dx_audit[0], (unsigned long long)seen);
    atomicAdd(&g_dx_audit[1], (unsigned long long)certified);
    atomicAdd(&g_dx_audit[2], (unsigned long long)flips);
    atomicAdd(&g_dx_audit[3], (unsigned long long)outside);
    atomicMax(&g_dx_audit[4], (unsigned long long)wbits);
  }
}
#endif

// out[u][n] (u < pad16(Uout), n < BN, bf16 bits): route 3's layer product
// (layer_product<true, kAct>) on bf16 tiles, its weights W(k, u) (bf16
// values in f32: W[k·ldw + u] direct, else W[u·ldw + k]) through the two f32
// slabs at `slab`, its inputs from `in` (pad16(Kin) rows, zero from Kin): per
// element an fmaf chain over k < pad16(Kin) in order from 0, + bias[u],
// ReLU, dropout of `layer`, act_bits; rows from Uout written 0. Every thread
// of the block calls it.
__device__ void layer_product_exact(const float* __restrict__ W, bool direct,
                                    int ldw, int Kin, int Uout,
                                    const bfbits* in, bfbits* out,
                                    const float* __restrict__ bias,
                                    const uint32_t* hash, int layer,
                                    const Dropout& drop, float* slab,
                                    int BN) {
  const int LDH = BN + 8;
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
      const bfbits* x = in + (size_t)kb * kSlab * LDH + 4 * nt;
#pragma unroll 4
      for (int k = 0; k < kSlab; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(s + k * UC);
        const uint2 q = *reinterpret_cast<const uint2*>(x + (size_t)k * LDH);
        const float wr[4] = {w.x, w.y, w.z, w.w};
        const float vc[4] = {__uint_as_float(q.x << 16),
                             __uint_as_float(q.x & 0xffff0000u),
                             __uint_as_float(q.y << 16),
                             __uint_as_float(q.y & 0xffff0000u)};
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
      uint32_t b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 4 * nt + c;
        float a = 0.f;
        if (u < Uout) {
          a = fmaxf(acc[r][c] + __ldg(bias + u), 0.f);
          if (drop.on)
            a = sdf_ffn::keep_unit(hash[n], layer, u, drop.threshold)
                    ? a * drop.scale
                    : 0.f;
        }
        b[c] = act_bits(a);
      }
      *reinterpret_cast<uint2*>(out + (size_t)u * LDH + 4 * nt) =
          make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
    }
  }
}

// amax[n] = max_k |in[k][n]| over k < Kin (bf16 tile) for the BN stocks,
// through red[0, kThreads); amax is red + kThreads. Ends synchronised.
__device__ void stock_max(const bfbits* in, int Kin, float* red, int BN) {
  const int LDH = BN + 8, parts = kThreads / BN;
  const int n = threadIdx.x % BN, part = threadIdx.x / BN;
  uint32_t m = 0;
  for (int k = part; k < Kin; k += parts)
    m = max(m, (uint32_t)(in[(size_t)k * LDH + n] & 0x7fffu));
  red[part * BN + n] = __uint_as_float(m << 16);
  __syncthreads();
  if (threadIdx.x < BN) {
    float a = 0.f;
    for (int q = 0; q < parts; ++q) a = fmaxf(a, red[q * BN + n]);
    red[kThreads + n] = a;
  }
  __syncthreads();
}

// the top layer's dh_pre of the decision `on` at unit u, stock n
__device__ __forceinline__ float top_dh_of(bool on, const DxTopOut& e, int u,
                                           int n, float ko) {
  if (on && e.drop.on)
    on = sdf_ffn::keep_unit(e.hash[n], e.layer, u, e.drop.threshold);
  return on ? ko * sdf_ffn::round_bf16(e.grow[n]) * e.dscale : 0.f;
}

// kMmaTop: h = Σ + b decides each element by its sign where |h| lies outside
// the window of its magnitude bound, else by the exact chain's (recomputed
// after the pass's other elements, one set bit at a time); out = dh_pre in
// bf16 (0 past Uout). The audit build also computes every element's chain.
template <int EPI>
__device__ void mma_epilogue(const float (&acc)[4][4][4], const MmaWarp& w,
                             int u0, int RU, int Uout, bfbits* out,
                             const DxTopOut& e, float*, int BN) {
  static_assert(EPI == kMmaTop, "the top layer's epilogue");
  const int LDH = BN + 8;
  // bit ((mt·2 + h)·4 + nt)·2 + j of the element (mt, h, nt, j): its mma
  // sum is positive (on), and it lies within the window (need)
  uint32_t on[2] = {0u, 0u}, need[2] = {0u, 0u};
#ifdef SDF_FFN_DX_AUDIT
  unsigned seen = 0, certified = 0, flips = 0, outside = 0;
  float worst = 0.f;
#endif
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int ub = u0 + w.wu * 64 + mt * 16;
    if (ub >= RU) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = ub + w.g + 8 * h;
      const bool in = u < Uout;
      float bias = 0.f, mag = 0.f, ko = 0.f;
      if (in) {
        bias = __ldg(e.bias + u);
        mag = __ldg(e.wabs + u);
        ko = sdf_ffn::round_bf16(__ldg(e.kout + u));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = w.wn * 32 + nt * 8 + 2 * w.t;
        uint32_t b[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!in) continue;
          const int bit = ((mt * 2 + h) * 4 + nt) * 2 + j;
          const float hs = acc[mt][nt][2 * h + j] + bias;
          const float bound =
              e.window * (e.amax[n + j] * mag + fabsf(bias)) + kCertifyFloor;
          const bool flagged = fabsf(hs) <= bound;
          on[bit >> 5] |= (uint32_t)(hs > 0.f) << (bit & 31);
          need[bit >> 5] |= (uint32_t)flagged << (bit & 31);
          b[j] = bf_bits(top_dh_of(hs > 0.f, e, u, n + j, ko));
#ifdef SDF_FFN_DX_AUDIT
          if (e.n0 + n + j < e.N) {
            const float exact =
                exact_chain_bits(e.A + (size_t)u * e.lda, e.in, n + j, e.Kin,
                                 LDH) +
                bias;
            const float m = e.amax[n + j] * mag + fabsf(bias);
            const bool flip = (hs > 0.f) != (exact > 0.f);
            ++seen;
            certified += flagged;
            flips += flip;
            outside += flip && !flagged;
            if (m > 0.f) worst = fmaxf(worst, fabsf(hs - exact) / m);
          }
#endif
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)u * LDH + n) =
            b[0] | (b[1] << 16);
      }
    }
  }
#ifdef SDF_FFN_DX_AUDIT
  audit_add(seen, certified, flips, outside, worst);
#endif
  // the exact chain decides the flagged elements; a decision it turns round
  // rewrites the element's dh_pre
#pragma unroll
  for (int q = 0; q < 2; ++q)
    for (uint32_t rest = need[q]; rest; rest &= rest - 1) {
      const int bit = 32 * q + __ffs(rest) - 1;
      const int mt = bit >> 4, h = (bit >> 3) & 1, nt = (bit >> 1) & 3,
                j = bit & 1;
      const int u = u0 + w.wu * 64 + mt * 16 + w.g + 8 * h;
      const int n = w.wn * 32 + nt * 8 + 2 * w.t + j;
      const float bias = __ldg(e.bias + u);
      const bool exact =
          exact_chain_bits(e.A + (size_t)u * e.lda, e.in, n, e.Kin, LDH) +
              bias >
          0.f;
      if (exact == (((on[q] >> (bit & 31)) & 1u) != 0u)) continue;
      out[(size_t)u * LDH + n] = (bfbits)bf_bits(
          top_dh_of(exact, e, u, n, sdf_ffn::round_bf16(__ldg(e.kout + u))));
    }
}

// kMmaAccum: the f32 dx tile += the pass's sums, rows u < Uout
template <int EPI>
__device__ void mma_epilogue(const float (&acc)[4][4][4], const MmaWarp& w,
                             int u0, int RU, int Uout, bfbits*,
                             const DxAccOut& e, float*, int BN) {
  static_assert(EPI == kMmaAccum, "the dx product's epilogue");
  const int LDF = BN + 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int ub = u0 + w.wu * 64 + mt * 16;
    if (ub >= RU) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = ub + w.g + 8 * h;
      if (u >= Uout) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float2* p = reinterpret_cast<float2*>(
            e.acc + (size_t)u * LDF + w.wn * 32 + nt * 8 + 2 * w.t);
        float2 v = *p;
        v.x += acc[mt][nt][2 * h];
        v.y += acc[mt][nt][2 * h + 1];
        *p = v;
      }
    }
  }
}

// dx [T, F, N] in the panel's dtype: a persistent grid over the T·⌈N/BN⌉
// cells, each for all S members (they share the panel); wb [S][Pb] the
// members' bf16 weight copies, wabs [S][HL] their top layer's Σ_k |W_uk|
template <typename PX>
__global__ void __launch_bounds__(kThreads)
    dx_stream_mma_kernel(const PX* __restrict__ x,
                         const float* __restrict__ zp,
                         const float* __restrict__ params,
                         const bfbits* __restrict__ wb,
                         const int* __restrict__ wtab, int Pb,
                         const float* __restrict__ g,
                         const float* __restrict__ wabs, PX* __restrict__ dx,
                         LayoutTable L, int S, int T, int N, Dropout drop,
                         int BN, int SU) {
  extern __shared__ __align__(16) float smem[];
  const int LDH = BN + 8, LDF = BN + 4;
  const MmaSmem m = carve_mma_at(smem, BN, (int)dx_mma_slab_bytes(BN, SU));
  const int F = L.F(), P = L.P(), H1 = L.h(0), nl = L.n();
  const int RF = pad16(F), lt = nl - 1, HL = L.h(lt);
  int top = 0;  // rows of the layers below the top
  for (int l = 0; l < lt; ++l) top += pad16(L.h(l));
  bfbits* X = m.tile;
  bfbits* acts = X + (size_t)RF * LDH;
  bfbits* dht = acts + (size_t)top * LDH;  // the top layer's dh_pre
  float* dxa = reinterpret_cast<float*>(dht + (size_t)pad16(HL) * LDH);
  float* fslab = reinterpret_cast<float*>(m.slab);
  const float dscale = drop.on ? drop.scale : 1.f;
  const int Kt = lt ? L.h(lt - 1) : F;  // the top layer's inputs
  const float window = certify_window(Kt);
  const int At_off = __ldg(wtab + 4 * lt), At_ld = __ldg(wtab + 4 * lt + 1);
  const int tiles = (N + BN - 1) / BN;
  const int cells = T * tiles;
  for (int c = blockIdx.x; c < cells; c += gridDim.x) {
    const int tile = c % tiles, t = c / tiles, n0 = tile * BN;
    __syncthreads();  // the last cell's readers are done
    stage_x_mma(X, x, F, N, t, n0, BN);
    for (int i = threadIdx.x; i < RF * BN; i += kThreads)
      dxa[(size_t)(i / BN) * LDF + i % BN] = 0.f;
    for (int s = 0; s < S; ++s) {
      stage_hash(m.hash, drop, s, t, n0, BN);
      for (int n = threadIdx.x; n < BN; n += kThreads)
        m.grow[n] = n0 + n < N ? __ldg(g + ((size_t)s * T + t) * N + n0 + n)
                               : 0.f;
      __syncthreads();
      const float* W = params + (size_t)s * P;
      const bfbits* Wb = wb + (size_t)s * Pb;
      const float* zrow = zp + ((size_t)s * T + t) * H1;
      // the layers below the top: route 3's chains on the CUDA cores
      const bfbits* in = X;
      int Kin = F, row = 0;
      for (int l = 0; l < lt; ++l) {
        const int H = L.h(l);
        bfbits* o = acts + (size_t)row * LDH;
        row += pad16(H);
        if (l == 0)
          layer_product_exact(W, true, L.hp(0), Kin, H, in, o, zrow, m.hash,
                              0, drop, fslab, BN);
        else
          layer_product_exact(W + L.off_w(l), false, L.hp(l - 1), Kin, H, in,
                              o, W + L.off_b(l), m.hash, l, drop, fslab, BN);
        __syncthreads();
        in = o;
        Kin = H;
      }
      // the top layer on the tensor cores, its decisions certified
      stock_max(in, Kin, m.red, BN);
      const bfbits* At = Wb + At_off;
      const DxTopOut et{lt ? W + L.off_b(lt) : zrow, m.hash, lt, drop,
                        W + L.off_kout(), m.grow, dscale, m.red + kThreads,
                        wabs + (size_t)s * HL, window, At, At_ld, in, Kin,
                        n0, N};
      layer_product_mma<kMmaTop>(At, At_ld, Kin, HL, in, dht, et, m.slab, SU,
                                 m.red, BN);
      // the dh chain: dh_pre of layer l - 1 over its activations
      const bfbits* cur = dht;
      for (int l = lt; l >= 1; --l) {
        row -= pad16(L.h(l - 1));
        bfbits* below = acts + (size_t)row * LDH;
        const MmaOut ec{nullptr, nullptr, 0, drop, below, dscale, nullptr,
                        nullptr};
        layer_product_mma<kMmaChain>(Wb + __ldg(wtab + 4 * l + 2),
                                     __ldg(wtab + 4 * l + 3), L.h(l),
                                     L.h(l - 1), cur, below, ec, m.slab, SU,
                                     m.red, BN);
        cur = below;
      }
      // dx += K1 · dh_pre of the first layer: K1 as [pad16(F)][h0 padded]
      layer_product_mma<kMmaAccum>(Wb + __ldg(wtab + 2), __ldg(wtab + 3), H1,
                                   F, cur, nullptr, DxAccOut{dxa}, m.slab, SU,
                                   m.red, BN);
    }
    for (int i = threadIdx.x; i < F * BN; i += kThreads) {
      const int f = i / BN, n = i - f * BN;
      if (n0 + n < N)
        panel::st(dx + ((size_t)t * F + f) * N + n0 + n,
                  dxa[(size_t)f * LDF + n]);
    }
  }
}

// -- the register-tiled route: f32 compute on the CUDA cores ------------------
//
// Route 5: the three kernels under f32 compute, redesigned from route 2's
// (fwd_stream_kernel, bwd_stream_kernel, dx_stream_kernel) for the widths
// that stream (a padded layer of 128 or more units). They compute route 2's
// values bit for bit on the same plan: every output of a layer product is
// one fmaf chain over its inputs in k order from 0 (over pad16(Kin), the
// same zero terms), its epilogue route 2's (bias, ReLU, the dropout hash;
// the chain's factor; the dx sum), and every weight-gradient element of a
// cell one fmaf chain over
// the cell's stocks in n order, added once into the block's grad_part slice
// in the cell order c = gb, gb + G, ...; so the forward's out is route 2's at
// any tile and grid, and the backward's gradients are route 2's at the same
// (tile, G). What differs is how the work sits on the card:
//
// - Blocks of 512 threads (16 warps, twice route 2's), one an SM. A layer
//   product gives each thread 8 units × TN stocks (TN = tile / 16: 4 at
//   tile 64, 2 at tile 32), the block 32 unit groups × 16 stock groups, so a
//   pass covers kTilePass = 256 units: a 256-unit layer reads its input tile
//   once. A warp's 32 lanes are 4 unit groups × 8 stock groups, so the
//   16-byte weight reads are broadcasts (4 addresses a warp) and the
//   activation reads 8 adjacent float4s: 3 shared loads feed 32 FMAs at
//   tile 64 (route 2: 2 loads, 16 FMAs).
// - Weights stream through a three-stage cp.async ring of slabs of
//   kTileSlab inputs × 256 units in 16-byte copies, one __syncthreads a slab.
//   A slab is laid out as the weights lie in global memory: [input][unit]
//   where the units are contiguous (K1, and every dh chain's W_l), else
//   [unit][input] (the forward's W_l, rows kTileKLd floats apart), with the
//   thread's units placed so that either layout reads conflict-free.
// - The backward writes each layer's dh_pre over that layer's activations
//   once its weight gradient has read them (the chain's epilogue reads the
//   factor of element (u, n) and writes dh_pre to the same element; dkout
//   reads the top layer before its dh_pre overwrites it), so its tile is
//   pad16(F) + Σ pad16(h_l) rows (route 2: + 2 · the widest layer): at (256,
//   256), F = 46 it holds 64 stocks in shared memory.
// - A weight gradient gives each thread 4 rows × 4 columns (a round of 64 ×
//   128 pairs), the sum over the cell's stocks sequential in n; the round's
//   grad_part block is copied into the idle slab ring before that sum, so
//   the read-add-write's reads hide behind it, and each element is added
//   once, always by the same thread (repeatable, no atomics).
// - The forward copies the next cell's panel tile into X (cp.async, an f32
//   panel with 16-byte aligned rows) while the layers above the first run,
//   and reads kout from the idle slab ring in its output sums.
//
// - The panel cotangent (dx_stream_tiled_kernel) recomputes the forward and
//   runs the dh chain as the backward does (dh_pre over the activations),
//   then adds K1·dh1_pre into an f32 dx tile after the panel tile and the
//   layers, member after member in s order, and writes dx once a cell in
//   the panel's dtype: route 2's dx bit for bit at any plan (each element
//   belongs to one cell, each sum runs over its inputs in order). Its tile
//   is 2·pad16(F) + Σ pad16(h_l) rows: at (256, 256), F = 46, 64 stocks in
//   shared memory. K1·dh1_pre has pad16(F) output units, which would fill
//   48 of a 256-unit pass at F = 46, so for pad16(F) ≤ kNarrowUnits it runs
//   on a map of its own (k1_product_narrow: every thread pad16(F)/16 units ×
//   tile/32 stocks).
//
// What bounds it: the f32 FMAs (operations). Layers narrower than a pass
// idle the threads whose units lie past them: a 64-unit layer uses a quarter
// of a pass, where route 2's 64-unit pass at tile 64 is full, so the forward
// and the panel cotangent of stacks at most 64 units wide keep route 2 where
// route 2 takes tile 64 (ops/sdf_ffn.py stream_route_plan); the backward,
// whose weight gradients and dh chain gain at any width, takes route 5
// wherever its tile fits.

constexpr int kTileThreads = 512;  // a block: 16 warps
constexpr int kTileSG = kTileThreads / 32;  // stock groups (unit groups: 32)
constexpr int kTilePass = 256;      // units a layer pass: 32 groups × 8
constexpr int kTileSlab = kSlab;    // inputs a weight slab
constexpr int kTileStages = 3;      // slabs in flight
constexpr int kTileKLd = kTileSlab + 4;  // floats a [unit][input] slab row
constexpr int kTileSlabFloats = kTilePass * kTileKLd;  // the larger layout

// rows of a register-tiled block's tile ([rows][tile + 4] f32): X, then the
// forward's two activation buffers, or every layer (each layer's dh_pre
// written over its activations) and (the panel cotangent) the dx accumulator
__host__ __device__ inline int tiled_rows(int kernel, int n, int F,
                                          const int* h) {
  int wr = 0, sum = 0;
  for (int l = 0; l < n; ++l) {
    const int r = pad16(h[l]);
    wr = r > wr ? r : wr;
    sum += r;
  }
  if (kernel == kFwd) return pad16(F) + 2 * wr;
  return pad16(F) + sum + (kernel == kDx ? pad16(F) : 0);
}

// shared-memory bytes of a register-tiled block: the slab ring, the row
// hashes, the g row, then the tile
__host__ __device__ inline long long tiled_smem_bytes(int BN, int rows) {
  return 4LL * (kTileStages * kTileSlabFloats + 2 * BN +
                (long long)rows * (BN + 4));
}

// a thread's place in a register-tiled layer product at stock tile BN: TN =
// BN / kTileSG stocks of stock group sg (TN ≥ 4: 4·sg + (c & 3) + (c >> 2)
// · 4·kTileSG, read as float4s; TN = 2: 2·sg + c), and 8 units of unit
// group ug. A warp is 8 adjacent stock groups × 4 adjacent unit groups.
template <int BN>
struct TileThread {
  static constexpr int TN = BN / kTileSG;
  int sg, ug;
  __device__ TileThread() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    sg = (lane & 7) + 8 * (warp % (kTileSG / 8));
    ug = (lane >> 3) + 4 * (warp / (kTileSG / 8));
  }
  __device__ __forceinline__ int stock(int c) const {
    return TN >= 4 ? (c >> 2) * 4 * kTileSG + 4 * sg + (c & 3) : 2 * sg + c;
  }
  // unit r of the pass: [input][unit] slabs read units 4·ug … 4·ug + 3 and
  // 128 further as two float4s; [unit][input] slabs rows ug + 32·r
  __device__ __forceinline__ int unit(int r, bool direct) const {
    return direct ? (r >> 2) * 128 + 4 * ug + (r & 3) : r * 32 + ug;
  }
};

__device__ __forceinline__ void ld4(float* d, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// TN activations of stocks th.stock(0 … TN-1) from the tile row at p
template <int BN>
__device__ __forceinline__ void ld_stocks(float* d, const float* p,
                                          const TileThread<BN>& th) {
  constexpr int TN = TileThread<BN>::TN;
  if (TN >= 4) {
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      ld4(d + 4 * q, p + q * 4 * kTileSG + 4 * th.sg);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p + 2 * th.sg);
    d[0] = v.x;
    d[1] = v.y;
  }
}

// out[u][n] (u < pad16(Uout), n < BN) from Σ_k W(k, u)·in[k][n] over k <
// pad16(Kin): layer_product<false, EPI> on the register tiles, the same
// sums and epilogues (kAccum: out += the sums, rows u < Uout). W(k, u) =
// W[k·ldw + u] (direct) or W[u·ldw + k]; `in` has pad16(Kin) rows, zero
// from Kin. kChain may write over `below` (each element read, then written,
// by one thread), and kAccum reads and writes each element of `out` in one
// thread. UD / UT:
// how far the [input][unit] and [unit][input] slab loops unroll (whole
// slabs in the forward; the backward, at the 128-register cap of 512
// threads, less). Every thread of the block calls it; it ends synchronised.
template <int EPI, int BN, int UD = kTileSlab, int UT = kTileSlab / 4>
__device__ void layer_product_tiled(const float* __restrict__ W, bool direct,
                                    int ldw, int Kin, int Uout,
                                    const float* in, float* out,
                                    const float* __restrict__ bias,
                                    const float* below, const uint32_t* hash,
                                    int layer, const Dropout& drop,
                                    float dscale, float* slab) {
  constexpr int LD = BN + 4;
  const TileThread<BN> th;
  constexpr int TN = TileThread<BN>::TN;
  const int RU = pad16(Uout);
  const int nk = pad16(Kin) / kTileSlab;
  const int total = ((RU + kTilePass - 1) / kTilePass) * nk;
  // slab i: units [p·256, +256) × inputs [kb·16, +16) of pass p, zero
  // outside the layer, in 16-byte copies
  auto issue = [&](int i) {
    if (i < total) {
      const int p = i / nk, kb = i - p * nk;
      const int u0 = p * kTilePass, k0 = kb * kTileSlab;
      float* dst = slab + (i % kTileStages) * kTileSlabFloats;
      for (int c = threadIdx.x; c < kTilePass * kTileSlab / 4;
           c += kTileThreads) {
        int k, u;
        float* d;
        if (direct) {
          k = c / (kTilePass / 4);
          u = (c % (kTilePass / 4)) * 4;
          d = dst + k * kTilePass + u;
        } else {
          u = c / (kTileSlab / 4);
          k = (c % (kTileSlab / 4)) * 4;
          d = dst + u * kTileKLd + k;
        }
        const int gk = k0 + k, gu = u0 + u;
        const bool ok = gk < Kin && gu < Uout;
        const float* src = !ok ? W
                           : direct ? W + (size_t)gk * ldw + gu
                                    : W + (size_t)gu * ldw + gk;
        sdf_ffn::cp_async16(d, src, ok ? 16 : 0);
      }
    }
    sdf_ffn::cp_async_commit();
  };
  float acc[8][TN];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  issue(0);
  issue(1);
  for (int i = 0; i < total; ++i) {
    sdf_ffn::cp_async_wait<1>();
    __syncthreads();  // slab i landed; every warp is done with slab i - 1
    issue(i + 2);
    const int p = i / nk, kb = i - p * nk;
    const int u0 = p * kTilePass;
    const float* s = slab + (i % kTileStages) * kTileSlabFloats;
    const float* x = in + (size_t)kb * kTileSlab * LD;
    if (direct) {
      const float* w = s + 4 * th.ug;
#pragma unroll (UD)
      for (int k = 0; k < kTileSlab; ++k) {
        float wv[8], xv[TN];
        ld4(wv, w + k * kTilePass);
        ld4(wv + 4, w + k * kTilePass + 128);
        ld_stocks(xv, x + (size_t)k * LD, th);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
      }
    } else {
      const float* w = s + th.ug * kTileKLd;
#pragma unroll (UT)
      for (int kq = 0; kq < kTileSlab; kq += 4) {
        float wq[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r) ld4(wq[r], w + r * 32 * kTileKLd + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float xv[TN];
          ld_stocks(xv, x + (size_t)(kq + kk) * LD, th);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c)
              acc[r][c] = fmaf(wq[r][kk], xv[c], acc[r][c]);
        }
      }
    }
    if (kb != nk - 1) continue;
    // the pass's epilogue: route 2's, the thread's stocks in float4s (or a
    // float2)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int u = u0 + th.unit(r, direct);
      if (u < RU) {
        const bool in_layer = u < Uout;
        const float b = (EPI == kAct && in_layer) ? __ldg(bias + u) : 0.f;
        float* o = out + (size_t)u * LD;
        float f[TN];
        if (EPI != kAct) {
          // kChain: the factor's activations; kAccum: out's sums so far
          if (in_layer) {
            ld_stocks(f, (EPI == kChain ? below : out) + (size_t)u * LD, th);
          } else {
#pragma unroll
            for (int c = 0; c < TN; ++c) f[c] = 0.f;
          }
        }
        float v[TN];
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const float a = acc[r][c];
          if (EPI == kAct) {
            float e = 0.f;
            if (in_layer) {
              e = fmaxf(a + b, 0.f);
              if (drop.on)
                e = sdf_ffn::keep_unit(hash[th.stock(c)], layer, u,
                                       drop.threshold)
                        ? e * drop.scale
                        : 0.f;
            }
            v[c] = e;
          } else if (EPI == kChain) {
            v[c] = (in_layer && f[c] > 0.f) ? a * dscale : 0.f;
          } else {
            v[c] = f[c] + a;
          }
          acc[r][c] = 0.f;
        }
        // kAccum: route 2 leaves out's rows past Uout as they are
        if (EPI == kAccum && !in_layer) continue;
        if (TN >= 4) {
#pragma unroll
          for (int q = 0; q < TN / 4; ++q)
            *reinterpret_cast<float4*>(o + q * 4 * kTileSG + 4 * th.sg) =
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                            v[4 * q + 3]);
        } else {
          *reinterpret_cast<float2*>(o + 2 * th.sg) = make_float2(v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
      }
    }
  }
  __syncthreads();
}

// gp[a·ldg + b] += Σ_n A[a][n]·B[b][n] for a < Ra, b < Rb over the tile's
// BN stocks in n order (grad_product<false>'s sums): rounds of 64 rows ×
// 128 columns, each thread rows ag + 16·i and columns bg + 32·j (i, j < 4;
// a warp 4 adjacent rows × 8 adjacent columns). A round's grad_part block
// is copied into `stage` (the idle slab ring, [64][kGradLd]) in 16-byte
// cp.async copies before the sum over the stocks, so the read-add-write's
// reads overlap it; each element is then added once, always by the same
// thread. Only global memory is written.
constexpr int kGradRows = 64, kGradCols = 128, kGradLd = kGradCols + 8;
static_assert(kGradRows * kGradLd <= kTileStages * kTileSlabFloats,
              "a grad_part block fits the slab ring");
static_assert(kTileThreads == 512, "16 row groups × 32 column groups");

template <int BN>
__device__ void grad_product_tiled(const float* A, int Ra, const float* B,
                                   int Rb, float* gp, int ldg, float* stage) {
  constexpr int LD = BN + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bg = (lane & 7) + 8 * (warp & 3);
  const int ag = (lane >> 3) + 4 * (warp >> 2);
  for (int a0 = 0; a0 < Ra; a0 += kGradRows) {
    for (int b0 = 0; b0 < Rb; b0 += kGradCols) {
      for (int c = threadIdx.x; c < kGradRows * kGradCols / 4;
           c += kTileThreads) {
        const int r = c / (kGradCols / 4), q = (c % (kGradCols / 4)) * 4;
        const bool ok = a0 + r < Ra && b0 + q < Rb;
        sdf_ffn::cp_async16(stage + r * kGradLd + q,
                            ok ? gp + (size_t)(a0 + r) * ldg + b0 + q : gp,
                            ok ? 16 : 0);
      }
      sdf_ffn::cp_async_commit();
      float acc[4][4];
      int ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // rows past Ra / Rb read a row that is there; their sums are dropped
        ar[i] = min(a0 + ag + 16 * i, Ra - 1) * LD;
        br[i] = min(b0 + bg + 32 * i, Rb - 1) * LD;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 1
      for (int n = 0; n < BN; n += 4) {
        float av[4][4], bv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ld4(av[i], A + ar[i] + n);
          ld4(bv[i], B + br[i] + n);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
      }
      sdf_ffn::cp_async_wait<0>();
      __syncthreads();  // the block landed
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = a0 + ag + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = b0 + bg + 32 * j;
          if (a < Ra && b < Rb)
            gp[(size_t)a * ldg + b] =
                stage[(ag + 16 * i) * kGradLd + bg + 32 * j] + acc[i][j];
        }
      }
      __syncthreads();  // every thread has read the block
    }
  }
}

// dst[j] += Σ_n A[j][n] for j < R in n order (row_sums' sums), a float4 of
// stocks at a time
template <int BN>
__device__ void row_sums_tiled(const float* A, int R, float* dst) {
  constexpr int LD = BN + 4;
  for (int j = threadIdx.x; j < R; j += kTileThreads) {
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < BN; n += 4) {
      const float4 v = *reinterpret_cast<const float4*>(A + (size_t)j * LD + n);
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    dst[j] += s;
  }
}

struct NoHook {
  __device__ void operator()() const {}
};

// forward_cell<false> on the register tiles: the top layer's activations
// (UD / UT: layer_product_tiled's unrolls); after_first() runs once the
// first layer's product is done with X
template <int BN, int UD = kTileSlab, int UT = kTileSlab / 4,
          typename AfterFirst = NoHook>
__device__ const float* forward_cell_tiled(const LayoutTable& L,
                                           const float* W,
                                           const float* __restrict__ zp_row,
                                           const float* X, float* acts,
                                           int wr, bool keep_all,
                                           const uint32_t* hash,
                                           const Dropout& drop, float* slab,
                                           AfterFirst after_first = {}) {
  constexpr int LD = BN + 4;
  const int nl = L.n();
  const float* in = X;
  int Kin = L.F(), row = 0;
  for (int l = 0; l < nl; ++l) {
    const int H = L.h(l);
    float* o = keep_all ? acts + (size_t)row * LD
                        : acts + (size_t)((l & 1) * wr) * LD;
    row += pad16(H);
    if (l == 0)
      layer_product_tiled<kAct, BN, UD, UT>(W, true, L.hp(0), Kin, H, in, o,
                                            zp_row, nullptr, hash, 0, drop,
                                            1.f, slab);
    else
      layer_product_tiled<kAct, BN, UD, UT>(
          W + L.off_w(l), false, L.hp(l - 1), Kin, H, in, o, W + L.off_b(l),
          nullptr, hash, l, drop, 1.f, slab);
    if (l == 0) after_first();
    in = o;
    Kin = H;
  }
  return in;
}

// out [S, T, N]: fwd_stream_kernel<PX, false> on the register tiles, stock
// tile BN, the tile in shared memory
template <typename PX, int BN>
__global__ void __launch_bounds__(kTileThreads)
    fwd_stream_tiled_kernel(const PX* __restrict__ x,
                            const float* __restrict__ zp,
                            const float* __restrict__ params,
                            float* __restrict__ out, LayoutTable L, int S,
                            int T, int N, Dropout drop) {
  constexpr int LD = BN + 4;
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;
  uint32_t* hash =
      reinterpret_cast<uint32_t*>(smem + kTileStages * kTileSlabFloats);
  float* X = smem + kTileStages * kTileSlabFloats + 2 * BN;
  const int F = L.F(), P = L.P(), H1 = L.h(0), nl = L.n();
  const int wr = widest_rows(L);
  float* acts = X + (size_t)pad16(F) * LD;
  const int tiles = (N + BN - 1) / BN;
  const long long cells = (long long)S * T * tiles;
  // an f32 panel whose rows start 16-byte aligned: the next cell's tile is
  // copied into X (cp.async) once the first layer has read it, while the
  // layers above it run
  bool vec = false;
  if constexpr (!panel::kBf16<PX>)
    vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto prefetch = [&](long long cn) {
    if constexpr (!panel::kBf16<PX>) {
      const int tn = (int)((cn / tiles) % T), m0 = (int)(cn % tiles) * BN;
      for (int i = threadIdx.x; i < pad16(F) * (BN / 4); i += kTileThreads) {
        const int f = i / (BN / 4), q = (i % (BN / 4)) * 4;
        const int left = N - (m0 + q);
        const int bytes = f < F ? 4 * max(0, min(4, left)) : 0;
        sdf_ffn::cp_async16(X + (size_t)f * LD + q,
                            bytes ? x + ((size_t)tn * F + f) * N + m0 + q : x,
                            bytes);
      }
      sdf_ffn::cp_async_commit();
    }
  };
  bool staged = false;  // X holds this cell's tile already
  for (long long c = blockIdx.x; c < cells; c += gridDim.x) {
    const int tile = (int)(c % tiles);
    const int t = (int)((c / tiles) % T);
    const int s = (int)(c / ((long long)tiles * T));
    const int n0 = tile * BN;
    __syncthreads();  // the last cell's readers are done
    if (!staged) stage_x<PX, kTileThreads>(X, x, T, F, N, t, n0, BN, LD);
    stage_hash<kTileThreads>(hash, drop, s, t, n0, BN);
    sdf_ffn::cp_async_wait<0>();  // the prefetched tile landed
    __syncthreads();
    const float* W = params + (size_t)s * P;
    staged = vec && c + gridDim.x < cells;
    const float* top = forward_cell_tiled<BN>(
        L, W, zp + ((size_t)s * T + t) * H1, X, acts, wr, false, hash, drop,
        slab, [&] {
          if (staged) prefetch(c + gridDim.x);
        });
    // kout in the idle slab ring: the output sums read it from shared
    // memory
    const int HL = L.h(nl - 1);
    for (int j = threadIdx.x; j < HL; j += kTileThreads)
      slab[j] = __ldg(W + L.off_kout() + j);
    __syncthreads();
    const float bout = __ldg(W + L.off_bout());
    for (int n = threadIdx.x; n < BN; n += kTileThreads) {
      if (n0 + n >= N) continue;
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < HL; ++j)
        a = fmaf(slab[j], top[(size_t)j * LD + n], a);
      out[((size_t)s * T + t) * N + n0 + n] = a + bout;
    }
  }
}

// grad_part [S, G, P] and dzp_part [S, G, T, H1]: bwd_stream_kernel<PX,
// false> on the register tiles, each layer's dh_pre over its activations
template <typename PX, int BN>
__global__ void __launch_bounds__(kTileThreads)
    bwd_stream_tiled_kernel(const PX* __restrict__ x,
                            const float* __restrict__ zp,
                            const float* __restrict__ params,
                            const float* __restrict__ g, float* grad_part,
                            float* dzp_part, LayoutTable L, int T, int N,
                            Dropout drop) {
  constexpr int LD = BN + 4;
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;
  uint32_t* hash =
      reinterpret_cast<uint32_t*>(smem + kTileStages * kTileSlabFloats);
  float* grow = smem + kTileStages * kTileSlabFloats + BN;
  float* X = grow + BN;
  const int G = gridDim.x, gb = blockIdx.x, s = blockIdx.y;
  const int F = L.F(), P = L.P(), H1 = L.h(0), nl = L.n();
  const int HL = L.h(nl - 1);
  float* acts = X + (size_t)pad16(F) * LD;
  int top_row = 0;  // rows of the layers below the top
  for (int l = 0; l + 1 < nl; ++l) top_row += pad16(L.h(l));
  float* gp = grad_part + ((size_t)s * G + gb) * P;
  const float dscale = drop.on ? drop.scale : 1.f;
  const float* W = params + (size_t)s * P;
  const float* kout = W + L.off_kout();
  const int tiles = (N + BN - 1) / BN;
  const int cells = T * tiles;
  for (int c = gb; c < cells; c += G) {
    const int tile = c % tiles, t = c / tiles, n0 = tile * BN;
    __syncthreads();
    stage_x<PX, kTileThreads>(X, x, T, F, N, t, n0, BN, LD);
    stage_hash<kTileThreads>(hash, drop, s, t, n0, BN);
    for (int n = threadIdx.x; n < BN; n += kTileThreads)
      grow[n] = n0 + n < N ? __ldg(g + ((size_t)s * T + t) * N + n0 + n)
                           : 0.f;
    __syncthreads();
    float* top = acts + (size_t)top_row * LD;
    forward_cell_tiled<BN, 4, 1>(L, W, zp + ((size_t)s * T + t) * H1, X,
                                 acts, 0, true, hash, drop, slab);
    // dkout (the activations × g) and dbout, before dh_pre overwrites them
    for (int j = threadIdx.x; j < HL; j += kTileThreads) {
      float a = 0.f;
#pragma unroll
      for (int n = 0; n < BN; n += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(top + (size_t)j * LD + n);
        a = fmaf(v.x, grow[n], a);
        a = fmaf(v.y, grow[n + 1], a);
        a = fmaf(v.z, grow[n + 2], a);
        a = fmaf(v.w, grow[n + 3], a);
      }
      gp[L.off_kout() + j] += a;
    }
    if (threadIdx.x == 0) {
      float a = 0.f;
      for (int n = 0; n < BN; ++n) a += grow[n];
      gp[L.off_bout()] += a;
    }
    __syncthreads();
    // dh_pre of the top layer over its activations
    for (int i = threadIdx.x; i < pad16(HL) * BN; i += kTileThreads) {
      const int j = i / BN, n = i - j * BN;
      float* p = top + (size_t)j * LD + n;
      *p = (j < HL && *p > 0.f) ? __ldg(kout + j) * grow[n] * dscale : 0.f;
    }
    __syncthreads();
    int row = top_row;
    for (int l = nl - 1; l >= 1; --l) {
      const int below = row - pad16(L.h(l - 1));
      const float* dhp = acts + (size_t)row * LD;
      float* act = acts + (size_t)below * LD;
      grad_product_tiled<BN>(dhp, L.h(l), act, L.h(l - 1), gp + L.off_w(l),
                             L.hp(l - 1), slab);
      row_sums_tiled<BN>(dhp, L.h(l), gp + L.off_b(l));
      __syncthreads();  // the weight gradient has read the activations
      layer_product_tiled<kChain, BN, 4, 1>(
          W + L.off_w(l), true, L.hp(l - 1), L.h(l), L.h(l - 1), dhp, act,
          nullptr, act, nullptr, 0, drop, dscale, slab);
      row = below;
    }
    // dK1 [F][hp0] and dzp
    grad_product_tiled<BN>(X, F, acts, H1, gp, L.hp(0), slab);
    row_sums_tiled<BN>(acts, H1,
                       dzp_part + (((size_t)s * G + gb) * T + t) * H1);
  }
}

// The panel cotangent's K1 product on a map of its own: out[u][n] += Σ_j
// W[u·ldw + j]·in[j][n] over j < pad16(Kin), for u < Uout, 16·R =
// pad16(Uout) ≤ kNarrowUnits (layer_product<false, kAccum> of K1 [F][hp0],
// not direct: its sums in j order from 0 and its epilogue). The block's
// threads are 16 unit groups × 32 stock groups: a thread holds units ug +
// 16·r (r < R) × stocks TN·sg … + TN - 1 (TN = BN / 32), so every thread
// works where a 256-unit pass would keep pad16(F)/256 of them busy. A warp
// is 4 adjacent unit groups × 8 adjacent stock groups: its weight reads are
// 4 rows kNarrowLd floats apart (conflict-free 16-byte reads), its
// activation reads 8 adjacent float2s (or floats). K1 streams in slabs of
// kNarrowK inputs × 16·R units ([unit][input]) through the three-stage
// ring. Every thread of the block calls it; it ends synchronised.
constexpr int kNarrowUnits = 64;
constexpr int kNarrowK = 64;
constexpr int kNarrowLd = kNarrowK + 4;
static_assert(kNarrowUnits * kNarrowLd <= kTileSlabFloats,
              "a narrow slab fits a stage of the ring");

template <int BN, int R>
__device__ void k1_product_narrow(const float* __restrict__ W, int ldw,
                                  int Kin, int Uout, const float* in,
                                  float* out, float* slab) {
  constexpr int LD = BN + 4;
  constexpr int TN = BN / 32;
  static_assert(TN == 1 || TN == 2, "stock tiles 32 and 64");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sg = (lane & 7) + 8 * (warp & 3);
  const int ug = (lane >> 3) + 4 * (warp >> 2);
  const int K16 = pad16(Kin);
  const int nk = (K16 + kNarrowK - 1) / kNarrowK;
  // slab i: units [0, 16·R) × inputs [i·kNarrowK, +kNarrowK), zero outside
  // K1, in 16-byte copies
  auto issue = [&](int i) {
    if (i < nk) {
      float* dst = slab + (i % kTileStages) * kTileSlabFloats;
      const int k0 = i * kNarrowK;
      for (int c = threadIdx.x; c < 16 * R * (kNarrowK / 4);
           c += kTileThreads) {
        const int u = c / (kNarrowK / 4), k = (c % (kNarrowK / 4)) * 4;
        const int gk = k0 + k;
        const bool ok = gk < Kin && u < Uout;
        sdf_ffn::cp_async16(dst + u * kNarrowLd + k,
                            ok ? W + (size_t)u * ldw + gk : W, ok ? 16 : 0);
      }
    }
    sdf_ffn::cp_async_commit();
  };
  float acc[R][TN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  issue(0);
  issue(1);
  for (int i = 0; i < nk; ++i) {
    sdf_ffn::cp_async_wait<1>();
    __syncthreads();  // slab i landed; every warp is done with slab i - 1
    issue(i + 2);
    const float* w =
        slab + (i % kTileStages) * kTileSlabFloats + ug * kNarrowLd;
    const float* x = in + (size_t)i * kNarrowK * LD + TN * sg;
    const int kn = min(kNarrowK, K16 - i * kNarrowK);  // a multiple of 16
#pragma unroll 2
    for (int kq = 0; kq < kn; kq += 4) {
      float wq[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) ld4(wq[r], w + r * 16 * kNarrowLd + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* p = x + (size_t)(kq + kk) * LD;
        float xv[TN];
        if constexpr (TN == 2) {
          const float2 v = *reinterpret_cast<const float2*>(p);
          xv[0] = v.x;
          xv[1] = v.y;
        } else {
          xv[0] = *p;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] = fmaf(wq[r][kk], xv[c], acc[r][c]);
      }
    }
  }
  // route 2's epilogue: out += the sums, rows u < Uout
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int u = ug + 16 * r;
    if (u >= Uout) continue;
    float* o = out + (size_t)u * LD + TN * sg;
    if constexpr (TN == 2) {
      float2 v = *reinterpret_cast<const float2*>(o);
      v.x = v.x + acc[r][0];
      v.y = v.y + acc[r][1];
      *reinterpret_cast<float2*>(o) = v;
    } else {
      *o = *o + acc[r][0];
    }
  }
  __syncthreads();
}

// dx tile += K1·dh1_pre of one member: the narrow map where pad16(F) ≤
// kNarrowUnits, else layer_product_tiled's 256-unit passes
template <int BN>
__device__ void k1_product(const LayoutTable& L, const float* W,
                           const float* dh1, float* acc, const Dropout& drop,
                           float* slab) {
  const int F = L.F(), H1 = L.h(0), hp0 = L.hp(0);
  switch (pad16(F) / 16) {
    case 1:
      k1_product_narrow<BN, 1>(W, hp0, H1, F, dh1, acc, slab);
      break;
    case 2:
      k1_product_narrow<BN, 2>(W, hp0, H1, F, dh1, acc, slab);
      break;
    case 3:
      k1_product_narrow<BN, 3>(W, hp0, H1, F, dh1, acc, slab);
      break;
    case 4:
      k1_product_narrow<BN, 4>(W, hp0, H1, F, dh1, acc, slab);
      break;
    default:
      layer_product_tiled<kAccum, BN, 4, 1>(W, false, hp0, H1, F, dh1, acc,
                                            nullptr, nullptr, nullptr, 0,
                                            drop, 1.f, slab);
  }
}
static_assert(kNarrowUnits == 4 * 16, "k1_product's cases");

// dx [T, F, N] in the panel's dtype: dx_stream_kernel<PX, false> on the
// register tiles, a persistent grid over the T·⌈N/BN⌉ cells, each for all S
// members in s order; the tile in shared memory (X, every layer with its
// dh_pre written over it, the f32 dx accumulator)
template <typename PX, int BN>
__global__ void __launch_bounds__(kTileThreads)
    dx_stream_tiled_kernel(const PX* __restrict__ x,
                           const float* __restrict__ zp,
                           const float* __restrict__ params,
                           const float* __restrict__ g, PX* __restrict__ dx,
                           LayoutTable L, int S, int T, int N, Dropout drop) {
  constexpr int LD = BN + 4;
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;
  uint32_t* hash =
      reinterpret_cast<uint32_t*>(smem + kTileStages * kTileSlabFloats);
  float* grow = smem + kTileStages * kTileSlabFloats + BN;
  float* X = grow + BN;
  const int F = L.F(), P = L.P(), H1 = L.h(0), nl = L.n();
  const int HL = L.h(nl - 1);
  float* acts = X + (size_t)pad16(F) * LD;
  int top_row = 0;  // rows of the layers below the top
  for (int l = 0; l + 1 < nl; ++l) top_row += pad16(L.h(l));
  float* top = acts + (size_t)top_row * LD;
  float* acc = top + (size_t)pad16(HL) * LD;
  const float dscale = drop.on ? drop.scale : 1.f;
  const int tiles = (N + BN - 1) / BN;
  const int cells = T * tiles;
  for (int c = blockIdx.x; c < cells; c += gridDim.x) {
    const int tile = c % tiles, t = c / tiles, n0 = tile * BN;
    __syncthreads();  // the last cell's readers are done
    stage_x<PX, kTileThreads>(X, x, T, F, N, t, n0, BN, LD);
    for (int i = threadIdx.x; i < pad16(F) * BN; i += kTileThreads)
      acc[(size_t)(i / BN) * LD + i % BN] = 0.f;
    for (int s = 0; s < S; ++s) {
      stage_hash<kTileThreads>(hash, drop, s, t, n0, BN);
      for (int n = threadIdx.x; n < BN; n += kTileThreads)
        grow[n] = n0 + n < N ? __ldg(g + ((size_t)s * T + t) * N + n0 + n)
                             : 0.f;
      __syncthreads();
      const float* W = params + (size_t)s * P;
      const float* kout = W + L.off_kout();
      forward_cell_tiled<BN, 4, 1>(L, W, zp + ((size_t)s * T + t) * H1, X,
                                   acts, 0, true, hash, drop, slab);
      // dh_pre of the top layer over its activations
      for (int i = threadIdx.x; i < pad16(HL) * BN; i += kTileThreads) {
        const int j = i / BN, n = i - j * BN;
        float* p = top + (size_t)j * LD + n;
        *p = (j < HL && *p > 0.f) ? __ldg(kout + j) * grow[n] * dscale : 0.f;
      }
      __syncthreads();
      // the dh chain: each layer's dh_pre over the activations below
      int row = top_row;
      for (int l = nl - 1; l >= 1; --l) {
        const int below = row - pad16(L.h(l - 1));
        float* act = acts + (size_t)below * LD;
        layer_product_tiled<kChain, BN, 4, 1>(
            W + L.off_w(l), true, L.hp(l - 1), L.h(l), L.h(l - 1),
            acts + (size_t)row * LD, act, nullptr, act, nullptr, 0, drop,
            dscale, slab);
        row = below;
      }
      // dx += K1 · dh_pre of the first layer
      k1_product<BN>(L, W, acts, acc, drop, slab);
    }
    for (int i = threadIdx.x; i < F * BN; i += kTileThreads) {
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

// 0 if the card takes kernel `kern` in blocks of `threads` at `smem`
// bytes (it opens the kernel to them): resident blocks per SM, registers
// and local-memory bytes per thread; else a cudaError_t value
int func_info(const void* kern, int threads, size_t smem, int* blocks,
              int* regs, int* local_bytes) {
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

// func_info of this library's kernel under bf16 (1) or f32 compute on a
// bf16 (xb16 1) or f32 panel
int kernel_info(int bf16, int xb16, size_t smem, int* blocks, int* regs,
                int* local_bytes) {
  return func_info(kernel_of(bf16, xb16), kThreads, smem, blocks, regs,
                   local_bytes);
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

// -- the tensor-core route's host side ----------------------------------------

namespace {

const void* mma_kernel_of(int xb16) {
#if SDF_FFN_STREAM_KERNEL == 0
  return xb16 ? (const void*)fwd_stream_mma_kernel<__nv_bfloat16>
              : (const void*)fwd_stream_mma_kernel<float>;
#elif SDF_FFN_STREAM_KERNEL == 1
  return xb16 ? (const void*)bwd_stream_mma_kernel<__nv_bfloat16>
              : (const void*)bwd_stream_mma_kernel<float>;
#else
  return xb16 ? (const void*)dx_stream_mma_kernel<__nv_bfloat16>
              : (const void*)dx_stream_mma_kernel<float>;
#endif
}

// func_info of this library's tensor-core kernel
int mma_kernel_info(int xb16, size_t smem, int* blocks, int* regs,
                    int* local_bytes) {
  return func_info(mma_kernel_of(xb16), kThreads, smem, blocks, regs,
                   local_bytes);
}

// the slab rows SU of `layout` at stock tile `tile`: a pass's units, or the
// widest padded layer (in the panel cotangent also pad16(F), the rows of its
// dx product) where that is narrower
int mma_slab_rows(const int* layout, int tile) {
  const int n = layout[0];
  int w = SDF_FFN_STREAM_KERNEL == kDx ? pad16(layout[1]) : 0;
  for (int l = 0; l < n; ++l) {
    const int r = pad16(layout[5 + l]);
    w = r > w ? r : w;
  }
  const int uc = mma_pass_units(tile);
  return uc < w ? uc : w;
}

// 0, and the slab rows, for a plan (tile, shared memory) of `layout` this
// route takes: its tiles all in shared memory; else kUnsupported
int check_mma_plan(const int* layout, int tile, long long smem_bytes,
                   int* SU) {
  const int n = layout[0], F = layout[1];
  if (n < 1 || F < 1) return kUnsupported;
  if (tile != 32 && tile != 64 && tile != 128) return kUnsupported;
  *SU = mma_slab_rows(layout, tile);
  long long want;
  if (SDF_FFN_STREAM_KERNEL == kDx) {
    // the panel tile, the layers below the top and the top's dh_pre
    int rows = pad16(F);
    for (int l = 0; l < n; ++l) rows += pad16(layout[5 + l]);
    want = dx_mma_smem_bytes(tile, rows, F, *SU);
  } else {
    want = mma_smem_bytes(
        tile, tile_rows(SDF_FFN_STREAM_KERNEL, n, F, layout + 5), *SU);
  }
  if (smem_bytes != want || smem_bytes > kMaxSmem) return kUnsupported;
  return 0;
}

// the checks of a launch: the plan, the card's residency, the grid; opens
// the kernel to its shared memory
int prepare_mma(const int* layout, int xb16, int tile, long long smem_bytes,
                int G, int* SU) {
  if (G < 1) return kUnsupported;
  int rc = check_mma_plan(layout, tile, smem_bytes, SU);
  if (rc != 0) return rc;
  int info[3] = {0, 0, 0};
  rc = mma_kernel_info(xb16, (size_t)smem_bytes, &info[0], &info[1],
                       &info[2]);
  if (rc != 0) return rc;
  return info[0] >= 1 ? 0 : kUnsupported;
}

}  // namespace

// Registers per thread of this library's tensor-core kernel (bf16 compute)
// on a bf16 (xb16 1) or f32 panel.
extern "C" int sdf_ffn_stream_mma_registers(int xb16) {
  int info[3] = {0, 0, 0};
  if (mma_kernel_info(xb16, 0, &info[0], &info[1], &info[2]) != 0)
    return kUnsupported;
  return info[1];
}

// What the card makes of a tensor-core plan (tile, shared memory): resident
// blocks per SM, registers and local-memory bytes per thread into out[3];
// 0, or kUnsupported / a cudaError_t value.
extern "C" int sdf_ffn_stream_mma_plan_info(const int* layout, int tile,
                                            long long smem_bytes, int xb16,
                                            int* out) {
  int SU = 0;
  const int rc = check_mma_plan(layout, tile, smem_bytes, &SU);
  if (rc != 0) return rc;
  return mma_kernel_info(xb16, (size_t)smem_bytes, &out[0], &out[1],
                         &out[2]);
}

#if SDF_FFN_STREAM_KERNEL == 0
// The tensor-core forward (bf16 compute): out [S, T, N] f32 on `stream`; wb
// [S][Pb] the members' bf16 weight copies, wtab their table (device ints).
extern "C" int sdf_ffn_fwd_stream_mma(
    const void* x, int xb16, const float* zp, const float* params,
    const void* wb, const int* wtab, int Pb, float* out, const int* layout,
    const int* layout_dev, int S, int T, int N, int dropout,
    const unsigned int* member_base, unsigned int threshold, float scale,
    unsigned int offset, int tile, long long smem_bytes, int G,
    void* stream) {
  if (S < 1 || T < 1 || N < 1 || Pb < 1) return kUnsupported;
  int SU = 0;
  const int rc = prepare_mma(layout, xb16, tile, smem_bytes, G, &SU);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bfbits* w = static_cast<const bfbits*>(wb);
  if (xb16)
    fwd_stream_mma_kernel<__nv_bfloat16><<<G, kThreads, smem_bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), zp, params, w, wtab, Pb, out, L,
        S, T, N, drop, tile, SU);
  else
    fwd_stream_mma_kernel<float><<<G, kThreads, smem_bytes, st>>>(
        static_cast<const float*>(x), zp, params, w, wtab, Pb, out, L, S, T,
        N, drop, tile, SU);
  return (int)cudaGetLastError();
}
#elif SDF_FFN_STREAM_KERNEL == 1
// The tensor-core backward (bf16 compute): grad_part [S, G, P] and dzp_part
// [S, G, T, H1], zeroed by the caller, on a grid of (G, S) blocks.
extern "C" int sdf_ffn_bwd_stream_mma(
    const void* x, int xb16, const float* zp, const float* params,
    const void* wb, const int* wtab, int Pb, const float* g,
    float* grad_part, float* dzp_part, const int* layout,
    const int* layout_dev, int S, int T, int N, int dropout,
    const unsigned int* member_base, unsigned int threshold, float scale,
    unsigned int offset, int tile, long long smem_bytes, int G,
    void* stream) {
  if (S < 1 || T < 1 || N < 1 || Pb < 1) return kUnsupported;
  int SU = 0;
  const int rc = prepare_mma(layout, xb16, tile, smem_bytes, G, &SU);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bfbits* w = static_cast<const bfbits*>(wb);
  const dim3 grid(G, S);
  if (xb16)
    bwd_stream_mma_kernel<__nv_bfloat16><<<grid, kThreads, smem_bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), zp, params, w, wtab, Pb, g,
        grad_part, dzp_part, L, T, N, drop, tile, SU);
  else
    bwd_stream_mma_kernel<float><<<grid, kThreads, smem_bytes, st>>>(
        static_cast<const float*>(x), zp, params, w, wtab, Pb, g, grad_part,
        dzp_part, L, T, N, drop, tile, SU);
  return (int)cudaGetLastError();
}
#else
// The tensor-core panel cotangent (bf16 compute): dx [T, F, N] in the
// panel's dtype, summed over the S members; wabs [S][HL] the top layer's
// Σ_k |W_uk| (f32) of each member, which the certified window reads.
extern "C" int sdf_ffn_dx_stream_mma(
    const void* x, int xb16, const float* zp, const float* params,
    const void* wb, const int* wtab, int Pb, const float* g, void* dx,
    const float* wabs, const int* layout, const int* layout_dev, int S,
    int T, int N, int dropout, const unsigned int* member_base,
    unsigned int threshold, float scale, unsigned int offset, int tile,
    long long smem_bytes, int G, void* stream) {
  if (S < 1 || T < 1 || N < 1 || Pb < 1) return kUnsupported;
  int SU = 0;
  const int rc = prepare_mma(layout, xb16, tile, smem_bytes, G, &SU);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bfbits* w = static_cast<const bfbits*>(wb);
  if (xb16)
    dx_stream_mma_kernel<__nv_bfloat16><<<G, kThreads, smem_bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), zp, params, w, wtab, Pb, g,
        wabs, static_cast<__nv_bfloat16*>(dx), L, S, T, N, drop, tile, SU);
  else
    dx_stream_mma_kernel<float><<<G, kThreads, smem_bytes, st>>>(
        static_cast<const float*>(x), zp, params, w, wtab, Pb, g, wabs,
        static_cast<float*>(dx), L, S, T, N, drop, tile, SU);
  return (int)cudaGetLastError();
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

// Read the counters into out[5] (after the launch; waits for `stream`).
extern "C" int sdf_ffn_dx_audit_read(unsigned long long* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      out, g_dx_audit, sizeof(g_dx_audit), 0, cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(st);
}
#endif
#endif

// -- the register-tiled route's host side -------------------------------------

namespace {

const void* tiled_kernel_of(int xb16, int tile) {
#if SDF_FFN_STREAM_KERNEL == 0
  if (tile == 32)
    return xb16 ? (const void*)fwd_stream_tiled_kernel<__nv_bfloat16, 32>
                : (const void*)fwd_stream_tiled_kernel<float, 32>;
  return xb16 ? (const void*)fwd_stream_tiled_kernel<__nv_bfloat16, 64>
              : (const void*)fwd_stream_tiled_kernel<float, 64>;
#elif SDF_FFN_STREAM_KERNEL == 1
  if (tile == 32)
    return xb16 ? (const void*)bwd_stream_tiled_kernel<__nv_bfloat16, 32>
                : (const void*)bwd_stream_tiled_kernel<float, 32>;
  return xb16 ? (const void*)bwd_stream_tiled_kernel<__nv_bfloat16, 64>
              : (const void*)bwd_stream_tiled_kernel<float, 64>;
#else
  if (tile == 32)
    return xb16 ? (const void*)dx_stream_tiled_kernel<__nv_bfloat16, 32>
                : (const void*)dx_stream_tiled_kernel<float, 32>;
  return xb16 ? (const void*)dx_stream_tiled_kernel<__nv_bfloat16, 64>
              : (const void*)dx_stream_tiled_kernel<float, 64>;
#endif
}

// func_info of this library's register-tiled kernel at stock tile `tile`
int tiled_kernel_info(int xb16, int tile, size_t smem, int* blocks,
                      int* regs, int* local_bytes) {
  return func_info(tiled_kernel_of(xb16, tile), kTileThreads, smem, blocks,
                   regs, local_bytes);
}

// 0 for a plan (tile, shared memory) of `layout` this route takes: stock
// tile 32 or 64, its tile in shared memory; else kUnsupported
int check_tiled_plan(const int* layout, int tile, long long smem_bytes) {
  const int n = layout[0], F = layout[1];
  if (n < 1 || F < 1) return kUnsupported;
  if (tile != 32 && tile != 64) return kUnsupported;
  const long long want = tiled_smem_bytes(
      tile, tiled_rows(SDF_FFN_STREAM_KERNEL, n, F, layout + 5));
  if (smem_bytes != want || smem_bytes > kMaxSmem) return kUnsupported;
  return 0;
}

// the checks of a launch: the plan, the card's residency, the grid; opens
// the kernel to its shared memory
int prepare_tiled(const int* layout, int xb16, int tile, long long smem_bytes,
                  int G) {
  if (G < 1) return kUnsupported;
  int rc = check_tiled_plan(layout, tile, smem_bytes);
  if (rc != 0) return rc;
  int info[3] = {0, 0, 0};
  rc = tiled_kernel_info(xb16, tile, (size_t)smem_bytes, &info[0], &info[1],
                         &info[2]);
  if (rc != 0) return rc;
  return info[0] >= 1 ? 0 : kUnsupported;
}

}  // namespace

// Registers per thread of this library's register-tiled kernel (f32
// compute) on a bf16 (xb16 1) or f32 panel: the larger of its two stock
// tiles' instances.
extern "C" int sdf_ffn_stream_tiled_registers(int xb16) {
  int most = 0;
  for (int tile = 32; tile <= 64; tile *= 2) {
    int info[3] = {0, 0, 0};
    if (tiled_kernel_info(xb16, tile, 0, &info[0], &info[1], &info[2]) != 0)
      return kUnsupported;
    most = info[1] > most ? info[1] : most;
  }
  return most;
}

// What the card makes of a register-tiled plan (tile, shared memory):
// resident blocks per SM, registers and local-memory bytes per thread into
// out[3]; 0, or kUnsupported / a cudaError_t value.
extern "C" int sdf_ffn_stream_tiled_plan_info(const int* layout, int tile,
                                              long long smem_bytes, int xb16,
                                              int* out) {
  const int rc = check_tiled_plan(layout, tile, smem_bytes);
  if (rc != 0) return rc;
  return tiled_kernel_info(xb16, tile, (size_t)smem_bytes, &out[0], &out[1],
                           &out[2]);
}

#if SDF_FFN_STREAM_KERNEL == 0
// The register-tiled forward (f32 compute): out [S, T, N] on `stream`.
extern "C" int sdf_ffn_fwd_stream_tiled(
    const void* x, int xb16, const float* zp, const float* params, float* out,
    const int* layout, const int* layout_dev, int S, int T, int N,
    int dropout, const unsigned int* member_base, unsigned int threshold,
    float scale, unsigned int offset, int tile, long long smem_bytes, int G,
    void* stream) {
  if (S < 1 || T < 1 || N < 1) return kUnsupported;
  const int rc = prepare_tiled(layout, xb16, tile, smem_bytes, G);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  if (tile == 32) {
    if (xb16)
      fwd_stream_tiled_kernel<__nv_bfloat16, 32>
          <<<G, kTileThreads, smem_bytes, st>>>(xh, zp, params, out, L, S, T, N,
                                            drop);
    else
      fwd_stream_tiled_kernel<float, 32><<<G, kTileThreads, smem_bytes, st>>>(
          xf, zp, params, out, L, S, T, N, drop);
  } else {
    if (xb16)
      fwd_stream_tiled_kernel<__nv_bfloat16, 64>
          <<<G, kTileThreads, smem_bytes, st>>>(xh, zp, params, out, L, S, T, N,
                                            drop);
    else
      fwd_stream_tiled_kernel<float, 64><<<G, kTileThreads, smem_bytes, st>>>(
          xf, zp, params, out, L, S, T, N, drop);
  }
  return (int)cudaGetLastError();
}
#elif SDF_FFN_STREAM_KERNEL == 1
// The register-tiled backward (f32 compute): grad_part [S, G, P] and
// dzp_part [S, G, T, H1], zeroed by the caller, on a grid of (G, S) blocks.
extern "C" int sdf_ffn_bwd_stream_tiled(
    const void* x, int xb16, const float* zp, const float* params,
    const float* g, float* grad_part, float* dzp_part, const int* layout,
    const int* layout_dev, int S, int T, int N, int dropout,
    const unsigned int* member_base, unsigned int threshold, float scale,
    unsigned int offset, int tile, long long smem_bytes, int G,
    void* stream) {
  if (S < 1 || T < 1 || N < 1) return kUnsupported;
  const int rc = prepare_tiled(layout, xb16, tile, smem_bytes, G);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(G, S);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  if (tile == 32) {
    if (xb16)
      bwd_stream_tiled_kernel<__nv_bfloat16, 32>
          <<<grid, kTileThreads, smem_bytes, st>>>(xh, zp, params, g, grad_part,
                                               dzp_part, L, T, N, drop);
    else
      bwd_stream_tiled_kernel<float, 32>
          <<<grid, kTileThreads, smem_bytes, st>>>(xf, zp, params, g, grad_part,
                                                   dzp_part, L, T, N, drop);
  } else {
    if (xb16)
      bwd_stream_tiled_kernel<__nv_bfloat16, 64>
          <<<grid, kTileThreads, smem_bytes, st>>>(xh, zp, params, g, grad_part,
                                               dzp_part, L, T, N, drop);
    else
      bwd_stream_tiled_kernel<float, 64>
          <<<grid, kTileThreads, smem_bytes, st>>>(xf, zp, params, g, grad_part,
                                                   dzp_part, L, T, N, drop);
  }
  return (int)cudaGetLastError();
}
#else
// The register-tiled panel cotangent (f32 compute): dx [T, F, N] in the
// panel's dtype, summed over the S members, on `stream`.
extern "C" int sdf_ffn_dx_stream_tiled(
    const void* x, int xb16, const float* zp, const float* params,
    const float* g, void* dx, const int* layout, const int* layout_dev, int S,
    int T, int N, int dropout, const unsigned int* member_base,
    unsigned int threshold, float scale, unsigned int offset, int tile,
    long long smem_bytes, int G, void* stream) {
  if (S < 1 || T < 1 || N < 1) return kUnsupported;
  const int rc = prepare_tiled(layout, xb16, tile, smem_bytes, G);
  if (rc != 0) return rc;
  const Dropout drop{dropout, member_base, threshold, scale, offset};
  const LayoutTable L{layout_dev};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  __nv_bfloat16* dh = static_cast<__nv_bfloat16*>(dx);
  float* df = static_cast<float*>(dx);
  if (tile == 32) {
    if (xb16)
      dx_stream_tiled_kernel<__nv_bfloat16, 32>
          <<<G, kTileThreads, smem_bytes, st>>>(xh, zp, params, g, dh, L, S, T,
                                            N, drop);
    else
      dx_stream_tiled_kernel<float, 32><<<G, kTileThreads, smem_bytes, st>>>(
          xf, zp, params, g, df, L, S, T, N, drop);
  } else {
    if (xb16)
      dx_stream_tiled_kernel<__nv_bfloat16, 64>
          <<<G, kTileThreads, smem_bytes, st>>>(xh, zp, params, g, dh, L, S, T,
                                            N, drop);
    else
      dx_stream_tiled_kernel<float, 64><<<G, kTileThreads, smem_bytes, st>>>(
          xf, zp, params, g, df, L, S, T, N, drop);
  }
  return (int)cudaGetLastError();
}
#endif
