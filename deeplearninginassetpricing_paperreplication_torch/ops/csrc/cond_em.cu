// Fused moment net + conditional empirical means for Hopper (sm_90a),
// forward, backward and panel cotangent.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/pallas_moment.py
// _fwd_kernel (:64), _bwd_kernel (:86) and _dx_kernel (:134) and, through
// the explicit member axis S, _fwd_kernel_members (:274) and
// _bwd_kernel_members (:302). For member s, moment k and stock n:
//
//   em[s,k,n] = Σ_t tanh(kT_s[k,:] · x[t,:,n] + zp_m[s,t,k]) · xr[s,t,n]·tinv[n]
//
// over the feature-major panel x [T, F, N]; h [K, T, N] never exists in
// device memory. The backward, from gem = dL/dem [S, K, N], recomputes h and
// emits dkT [S, K, F], dzp_m [S, T, K] and dxr [S, T, N] (the chain back
// into the SDF factor, and through it into the generator).
//
// Rounding points are the JAX kernel's (pallas_ffn._dot): with bf16 the
// operands of kT·x and of dpre·xᵀ are rounded, everything else is f32, tanh
// included (tanhf on every route, as cond_em_dx recomputes h).
//
// Which Pallas kernel each replaces: cond_em_fwd the two forward kernels,
// cond_em_bwd the two backward ones, cond_em_dx _dx_kernel.
//
// What bounds them on this card, as measured (chip_smoke.py --only_cem on
// an NVIDIA H100 80GB HBM3 at 700 W; S = 9, T = 48, N = 10,000, F = 46,
// K = 8; device time from CUDA-graph replays): the first
// kernels here ran one thread per (member, stock) with one shared load per
// FMA, 4-byte panel loads used at once and the panel read once per member:
// 0.83 ms forward and 1.49 ms backward in f32, against bounds of 0.049 and
// 0.097 ms (the f32 FMA rate; the 88 MB panel alone is 0.026 ms). Latency
// bound them, not bytes. The redesign:
//
// * The panel arrives by 16-byte cp.async (4-byte where N is not a multiple
//   of 4: N = 10,007 takes the forward at S = 1 from 0.051 to 0.084 ms)
//   into stages, so that the next period is in flight while one computes,
//   and one slab serves all the block's members; every member's
//   kT sits in shared memory, moments padded to 4 for float4 broadcasts.
// * Forward, f32: register tiles of RT moments × CT stocks per thread (8 × 2
//   at K = 8, S = 9: two kT float4 loads and one float2 of the panel give 16
//   FMAs); the em accumulators stay in registers across the periods of a
//   group. What bounds it now is instruction issue, the FMAs and about 35 M
//   tanhf at S = 9 (0.184 ms; more than two stages timed the same).
//   bf16: mma.sync m16n8k16 on the tensor cores, A = the panel slab (16
//   stocks × 16 features, rounded to bf16 as the fragments are built), B =
//   the stacked kT (8 member-moments per n tile, in registers for the whole
//   kernel); the epilogue adds zp, takes tanh, multiplies by w and
//   accumulates em in the accumulator-fragment layout (0.10 ms; tanhf
//   costs more than the SFU's approximate tanh, which the reference's
//   rounding points do not allow).
// * Backward, f32: phase A recomputes h per (member, stock) in KP × 2
//   register tiles and writes dpre for the block's members and dxr; phase B
//   forms dkT in (KP/4) × 4 register tiles over a stock-major copy of the
//   tile (a float4 of the panel and KP/4 values of dpre per KP FMAs), the
//   accumulators in registers across periods, while one thread per (member,
//   moment) sums dzp_m. At one member a block phase B reads the stage
//   instead (no copy: six blocks an SM, one wave). One stage: the next
//   period lands during phase B (two stages timed the same). Two FMA passes
//   on twelve warps an SM, latency-bound: 0.47 ms. bf16: both products on
//   mma.sync (dkT's A = dpre in bf16 [rows × 128 stocks], B = the stage),
//   the partial sums of dzp_m and dxr by warp shuffles, then in a fixed
//   order (0.23 ms). Both kernels round kT to bf16 themselves.
// * The launch plan (route, stock tile, members per block, threads, stages,
//   shared memory, resident blocks) is Python arithmetic in
//   ops/cond_em.py::cem_plan, chosen to fill whole waves; this file
//   recomputes the shared-memory plan at each launch and refuses a plan that
//   disagrees, and cond_em_plan_info asks the card for the resident blocks
//   once per plan, before its first launch. Blocks that share a tile are
//   adjacent in launch order.
//
// The f32 outputs are bit for bit those of the one-thread-per-stock
// kernels: each sum keeps its chain. pre[s,t,k,n] is an fmaf chain over
// f = 0..F−1 from 0; em is fmaf(tanhf(pre + z), xr·tinv, em) over the
// periods of a group (_groups(S, T, N, 64, …)) from 0, the groups summed by
// the wrapper; dkT per (member, group, 128-stock tile) adds, in period
// order, each period's fmaf chain over the tile's stocks j = 0..127 from 0;
// dzp_m per (member, tile, t, k) is a serial sum over j; dxr is an fmaf
// chain over k of gm·h, times tinv. Which thread computes a chain is free;
// its order is not. The partial sums leave no float atomics, so two calls
// give bitwise-equal gradients (the bf16 backward's too: its sums run in a
// fixed order). Ragged stock lanes read x = 0, xr = 0, tinv = 0 and gem =
// 0, masked before any product (NaN·0 would otherwise leak in).
//
// The panel cotangent (cond_em_dx, below) is
//
//   dx[t, f, n] = Σ_s Σ_k round(kT_s[k, f]) · round(dpre_s[t, k, n]),
//   dpre = gem · xr · tinv · (1 − h²)
//
// summed over the members, who share the panel. The first kernel ran one
// thread per (period, stock) with its panel and dx columns in shared memory,
// the members walked serially: 0.97 ms at S = 9 on an NVIDIA H100 80GB
// HBM3 at 700 W, against a bound of 0.097 ms (the f32 FMA rate). The
// redesign is a persistent grid of G resident blocks, each walking a
// contiguous run of (stock tile, period) cells, the period innermost (gem
// and tinv of a tile stay in the caches for its periods). A cell's panel tile [F][tile] and xr rows [S][tile] arrive by
// cp.async (16 bytes a copy, 4 where N is not a multiple of 4) while the
// previous cell computes, once for all members; every member's kT sits in
// shared memory.
//
// * f32 (route 0): phase A recomputes pre for RT member-moments × 4 stocks a
//   thread (two kT float4 broadcasts and one panel float4 per 32 FMAs), then
//   h and dpre, which it writes to shared memory [S·KP][tile]; phase B gives
//   each thread 6 features × 4 stocks of dx, and per member the fmaf chain
//   over the KP moments (four dpre float4s and six kT float4s per 96 FMAs),
//   added to the accumulator member by member; one float4 store of stocks
//   per feature row. Every chain is the first kernel's: pre an fmaf chain
//   over f from 0, v = gem·w·(1 − h²) with w = xr·tinv, member s's term an
//   fmaf chain over k = 0..KP−1 from 0 (the padded moments' fmaf(0, 0, v)
//   included, which turns −0 into +0), and dx = 0 + v_0 + v_1 + ... in
//   member order: bit for bit the same dx.
// * bf16 (route 1, F ≤ 64): one warp per 16 stocks. pre = panel · kT on
//   mma.sync m16n8k16 (A = the panel slab rounded to bf16, B = the stacked
//   kT of all members, r = s·K + k), two n tiles at a time; the epilogue
//   adds zp_m, takes tanhf, forms dpre and rounds it to bf16, and the two
//   accumulator tiles are, as they stand in the registers, the A fragment of
//   one k step of dx = dpre · kTᵀ (contracted over all S·K member-moments,
//   padded to 16), on mma.sync again. The dx tile goes through the warp's
//   own columns of the spent panel slab, and the block stores [F][tile]
//   rows coalesced.
//
// No float atomics: two calls are bitwise-equal. The launch plan (route,
// tile, threads, shared memory, resident blocks, G) is
// ops/cond_em.py::cem_dx_plan's, checked here as the others are.
//
// The panel: every kernel here stages it through fwd_load, and has a float
// and a bf16-panel instance (the template's PX; panel.cuh). The bf16
// instance stores its panel widened into the same f32 stages there, with
// ordinary loads in place of the panel's cp.async copies (the xr rows
// keep theirs), so it computes what the float one does on the f32 panel
// x.bfloat16().float(); cond_em_dx writes dx in the panel's dtype. One
// library per panel dtype: the build passes -DCOND_EM_PANEL_BF16=0|1 and
// the library holds that dtype's instances alone, so the two compile side
// by side; its entry points refuse the other dtype (xb16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "panel.cuh"

#ifndef COND_EM_PANEL_BF16
#define COND_EM_PANEL_BF16 0
#endif

namespace {

constexpr int kMaxK = 16;
constexpr int kBwdTile = 128;       // the backward's partials are built on it
constexpr int kFwdMaxThreads = 512;  // launch bounds: ≤ 128 registers
constexpr int kBwdMaxThreads = 256;  // launch bounds: ≤ 255 registers
constexpr int kMmaMaxF = 64;         // the tensor-core routes: ≤ 4 k steps
constexpr int kFwdCoresStages = 2;   // the CUDA-core forward's panel slabs
constexpr long long kMaxSmem = 227 * 1024;
constexpr int kUnsupported = -1;
constexpr int kRouteCores = 0, kRouteMma = 1;

__host__ __device__ constexpr int pad4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ constexpr int pad8(int v) { return (v + 7) / 8 * 8; }
// a row stride of at least w floats, a multiple of 4 whose quarter is odd:
// float4 loads of consecutive rows fall in distinct bank groups
__host__ __device__ constexpr int odd4(int w) {
  return (pad4(w) / 4) % 2 ? pad4(w) : pad4(w) + 4;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// wait until at most n of this thread's latest copy groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

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

// elements tid, tid + blockDim.x, ... of a [rows][cols] array as (row r,
// column c), without a division per element
struct Walk {
  int r, c, dr, dc;
};

__device__ __forceinline__ Walk walk_start(int cols) {
  return Walk{(int)threadIdx.x / cols, (int)threadIdx.x % cols,
              (int)blockDim.x / cols, (int)blockDim.x % cols};
}

__device__ __forceinline__ void walk_next(Walk& w, int cols) {
  w.r += w.dr;
  w.c += w.dc;
  if (w.c >= cols) {
    w.c -= cols;
    ++w.r;
  }
}

// start the copies of period t's panel slab [F][tile] (row stride xst,
// feature-major; stocks past N zero-filled) into xs, and of the block's
// members' xr rows [M][tile] (members past Ml and stocks past N zero) into
// xrs: 16 bytes a copy where N is a multiple of 4 (every row then starts
// 16-byte aligned), else 4. A bf16 panel is stored widened into xs here and
// now (panel.cuh).
template <typename PX>
__device__ __forceinline__ void fwd_load(float* xs, int xst, float* xrs,
                                         const PX* x, const float* xr,
                                         int t, int n0, int s0, int Ml, int M,
                                         int T, int F, int N, int tile) {
  const PX* xt = x + (size_t)t * F * N + n0;
  const bool vec = (N & 3) == 0;
  if constexpr (panel::kBf16<PX>) {
    panel::stage_bf16(xs, xst, xt, N, F, tile, N - n0);
  } else if (vec) {
    const int q = tile / 4;
    for (Walk w = walk_start(q); w.r < F; walk_next(w, q)) {
      const int left = N - n0 - 4 * w.c;
      cp_async16(xs + w.r * xst + 4 * w.c,
                 left > 0 ? xt + (size_t)w.r * N + 4 * w.c : x,
                 left >= 4 ? 16 : left > 0 ? 4 * left : 0);
    }
  } else {
    for (Walk w = walk_start(tile); w.r < F; walk_next(w, tile)) {
      const bool ok = n0 + w.c < N;
      cp_async4(xs + w.r * xst + w.c, ok ? xt + (size_t)w.r * N + w.c : x,
                ok);
    }
  }
  if (vec) {
    const int q = tile / 4;
    for (Walk w = walk_start(q); w.r < M; walk_next(w, q)) {
      const int left = w.r < Ml ? N - n0 - 4 * w.c : 0;
      cp_async16(xrs + w.r * tile + 4 * w.c,
                 left > 0 ? xr + ((size_t)(s0 + w.r) * T + t) * N + n0 +
                                4 * w.c
                          : xr,
                 left >= 4 ? 16 : left > 0 ? 4 * left : 0);
    }
    return;
  }
  for (Walk w = walk_start(tile); w.r < M; walk_next(w, tile)) {
    const bool ok = w.r < Ml && n0 + w.c < N;
    cp_async4(xrs + w.r * tile + w.c,
              ok ? xr + ((size_t)(s0 + w.r) * T + t) * N + n0 + w.c : xr, ok);
  }
}

// -- forward, CUDA cores (f32; bf16 operands where F exceeds the mma route) -

// a thread's CT consecutive stocks sc·CT .. of a row (CT 1 or 2)
template <int CT>
__device__ __forceinline__ void load_cols(float (&v)[CT], const float* row,
                                          int sc) {
  if constexpr (CT == 1) {
    v[0] = row[sc];
  } else {
    const float2 a = reinterpret_cast<const float2*>(row)[sc];
    v[0] = a.x;
    v[1] = a.y;
  }
}

// Block (stock tile, period group, member group); thread (row chunk rc of
// RT moments of one member, stock chunk sc of CT stocks). Shared memory:
// kT [M][F][KP], zp_m [tpg][M][KP] (moments past K zero), the panel slabs
// [NS][F][tile] and xr [NS][M][tile], periods t + 1 .. t + NS − 1 in flight
// while t computes (NS is kFwdCoresStages: more timed the same).
template <int RT, int CT, bool BF16, typename PX>
__global__ void __launch_bounds__(kFwdMaxThreads, 1)
cond_em_fwd_cores(const PX* __restrict__ x, const float* __restrict__ zpm,
                  const float* __restrict__ xr,
                  const float* __restrict__ tinv,
                  const float* __restrict__ kT, float* __restrict__ em_part,
                  int S, int T, int F, int N, int K, int tpg, int M,
                  int tile, int NS) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int KP = pad4(K), chunks = KP / RT;
  const int n0 = blockIdx.x * tile, g = blockIdx.y, s0 = blockIdx.z * M;
  const int Ml = min(M, S - s0);
  const int t0 = g * tpg, t1 = min(T, t0 + tpg);
  float* kTs = sm;
  float* zs = kTs + M * F * KP;
  float* xs = zs + tpg * M * KP;
  float* xrs = xs + NS * F * tile;
  for (int i = 0; i < NS - 1; ++i) {  // periods t0 .. t0 + NS − 2 in flight
    if (t0 + i < t1)
      fwd_load(xs + i * F * tile, tile, xrs + i * M * tile, x, xr, t0 + i,
               n0, s0, Ml, M, T, F, N, tile);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < M * F * KP; i += blockDim.x) {
    const int m = i / (F * KP), f = (i / KP) % F, k = i % KP;
    const float v =
        (m < Ml && k < K) ? kT[((size_t)(s0 + m) * K + k) * F + f] : 0.f;
    kTs[i] = BF16 ? round_bf16(v) : v;
  }
  for (int i = threadIdx.x; i < tpg * M * KP; i += blockDim.x) {
    const int tl = i / (M * KP), m = (i / KP) % M, k = i % KP;
    zs[i] = (m < Ml && k < K && t0 + tl < t1)
                ? zpm[((size_t)(s0 + m) * T + t0 + tl) * K + k]
                : 0.f;
  }
  const int spt = tile / CT;
  const int rc = threadIdx.x / spt, sc = threadIdx.x % spt;
  const bool active = rc < Ml * chunks;
  const int m = active ? rc / chunks : 0, k0 = active ? rc % chunks * RT : 0;
  float tv[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int n = n0 + sc * CT + j;
    tv[j] = n < N ? tinv[n] : 0.f;
  }
  float em[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) em[i][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) % NS, nb = (t - t0 + NS - 1) % NS;
    cp_async_wait(NS - 2);
    __syncthreads();  // slab t has landed; every thread is done with t − 1
    if (t + NS - 1 < t1)
      fwd_load(xs + nb * F * tile, tile, xrs + nb * M * tile, x, xr,
               t + NS - 1, n0, s0, Ml, M, T, F, N, tile);
    cp_async_commit();
    if (!active) continue;
    const float* xb = xs + b * F * tile;
    const float4* kb =
        reinterpret_cast<const float4*>(kTs + m * F * KP + k0);
    float pre[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) pre[i][j] = 0.f;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      float xv[CT];
      load_cols<CT>(xv, xb + f * tile, sc);
      if constexpr (BF16) {
#pragma unroll
        for (int j = 0; j < CT; ++j) xv[j] = round_bf16(xv[j]);
      }
      float kv[RT];
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const float4 w = kb[f * (KP / 4) + q];
        kv[4 * q] = w.x;
        kv[4 * q + 1] = w.y;
        kv[4 * q + 2] = w.z;
        kv[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) pre[i][j] = fmaf(kv[i], xv[j], pre[i][j]);
    }
    float z[RT];
    const float4* zb =
        reinterpret_cast<const float4*>(zs + ((t - t0) * M + m) * KP + k0);
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) {
      const float4 v = zb[q];
      z[4 * q] = v.x;
      z[4 * q + 1] = v.y;
      z[4 * q + 2] = v.z;
      z[4 * q + 3] = v.w;
    }
    float w[CT];
    load_cols<CT>(w, xrs + (b * M + m) * tile, sc);
#pragma unroll
    for (int j = 0; j < CT; ++j) w[j] = w[j] * tv[j];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        em[i][j] = fmaf(tanhf(pre[i][j] + z[i]), w[j], em[i][j]);
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int k = k0 + i;
    if (k >= K) continue;
    float* out = em_part + (((size_t)(s0 + m) * gridDim.y + g) * K + k) * N;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int n = n0 + sc * CT + j;
      if (n < N) out[n] = em[i][j];
    }
  }
}

// -- forward, bf16 on the tensor cores ---------------------------------------

// the A fragments of k step kk from the f32 panel slab xs (this thread's
// stock gid, features 16·kk + 2·tig ...), rounded to bf16
__device__ __forceinline__ void x_frag(uint32_t (&a)[4], const float* xs,
                                       int kk, int tig, int xst) {
  const float* xp = xs + (16 * kk + 2 * tig) * xst;
  a[0] = pack_bf16(xp[0], xp[xst]);            // stock gid, k 2·tig
  a[1] = pack_bf16(xp[8], xp[xst + 8]);        // stock gid + 8
  a[2] = pack_bf16(xp[8 * xst], xp[9 * xst]);  // k 2·tig + 8
  a[3] = pack_bf16(xp[8 * xst + 8], xp[9 * xst + 8]);
}

// n tiles of 8 stacked member-moments per warp: the largest of 3, 2, 1 that
// divides the block's M · ⌈K/8⌉ tiles
__host__ __device__ inline int mma_nt(int M, int K) {
  const int tiles = M * pad8(K) / 8;
  return tiles % 3 == 0 ? 3 : tiles % 2 == 0 ? 2 : 1;
}

// Block (stock tile, period group, member group) of (tile / 16) × row
// groups warps; a warp computes 16 stocks × NT n tiles of the stacked
// member-moments r = m · KP8 + k. Shared memory: zp_m [tpg][M·KP8], the
// panel slabs [NS][16·KS][tile + 4] (rows past F zero) and xr
// [NS][M][tile].
template <int NT, int KS, typename PX>
__global__ void __launch_bounds__(kFwdMaxThreads, 1)
cond_em_fwd_mma(const PX* __restrict__ x, const float* __restrict__ zpm,
                const float* __restrict__ xr, const float* __restrict__ tinv,
                const float* __restrict__ kT, float* __restrict__ em_part,
                int S, int T, int F, int N, int K, int tpg, int M, int tile,
                int NS) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int KP8 = pad8(K), R = M * KP8, xst = tile + 4, xsz = 16 * KS * xst;
  const int n0 = blockIdx.x * tile, g = blockIdx.y, s0 = blockIdx.z * M;
  const int Ml = min(M, S - s0);
  const int t0 = g * tpg, t1 = min(T, t0 + tpg);
  float* zs = sm;
  float* xs = zs + tpg * R;
  float* xrs = xs + NS * xsz;
  for (int i = 0; i < NS - 1; ++i) {
    if (t0 + i < t1)
      fwd_load(xs + i * xsz, xst, xrs + i * M * tile, x, xr, t0 + i, n0, s0,
               Ml, M, T, F, N, tile);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < NS * (16 * KS - F) * xst; i += blockDim.x) {
    const int bi = i / ((16 * KS - F) * xst), e = i % ((16 * KS - F) * xst);
    xs[bi * 16 * KS * xst + F * xst + e] = 0.f;
  }
  for (int i = threadIdx.x; i < tpg * R; i += blockDim.x) {
    const int tl = i / R, r = i % R, m = r / KP8, k = r % KP8;
    zs[i] = (m < Ml && k < K && t0 + tl < t1)
                ? zpm[((size_t)(s0 + m) * T + t0 + tl) * K + k]
                : 0.f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wps = tile / 16, rg = warp / wps, ws = warp % wps;
  // B fragments: kT of stacked row (rg·NT + j)·8 + gid, features 16·kk + 2·tig
  uint32_t bf[NT][KS][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int r = (rg * NT + j) * 8 + gid, m = r / KP8, k = r % KP8;
    const bool ok = m < Ml && k < K;
    const float* kr = kT + ((size_t)(s0 + (ok ? m : 0)) * K + (ok ? k : 0)) * F;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 16 * kk + 2 * tig + (e & 1) + (e >> 1) * 8;
        v[e] = ok && f < F ? kr[f] : 0.f;
      }
      bf[j][kk][0] = pack_bf16(v[0], v[1]);
      bf[j][kk][1] = pack_bf16(v[2], v[3]);
    }
  }
  // the epilogue's columns: stacked rows c, c + 1 of n tile j
  int col[NT], mw[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    col[j] = (rg * NT + j) * 8 + 2 * tig;
    mw[j] = min(col[j] / KP8, M - 1);  // rows past the members: not written
  }
  const int nl = ws * 16 + gid;
  const float tv_lo = n0 + nl < N ? tinv[n0 + nl] : 0.f;
  const float tv_hi = n0 + nl + 8 < N ? tinv[n0 + nl + 8] : 0.f;
  float em[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) em[j][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) % NS, nb = (t - t0 + NS - 1) % NS;
    cp_async_wait(NS - 2);
    __syncthreads();
    if (t + NS - 1 < t1)
      fwd_load(xs + nb * xsz, xst, xrs + nb * M * tile, x, xr, t + NS - 1, n0,
               s0, Ml, M, T, F, N, tile);
    cp_async_commit();
    uint32_t a[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      x_frag(a[kk], xs + b * xsz + nl, kk, tig, xst);
    const float* zt = zs + (t - t0) * R;
    const float* xrb = xrs + b * M * tile + nl;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(acc, a[kk], bf[j][kk][0], bf[j][kk][1]);
      const float2 z = *reinterpret_cast<const float2*>(zt + col[j]);
      const float w_lo = xrb[mw[j] * tile] * tv_lo;
      const float w_hi = xrb[mw[j] * tile + 8] * tv_hi;
      em[j][0] = fmaf(tanhf(acc[0] + z.x), w_lo, em[j][0]);
      em[j][1] = fmaf(tanhf(acc[1] + z.y), w_lo, em[j][1]);
      em[j][2] = fmaf(tanhf(acc[2] + z.x), w_hi, em[j][2]);
      em[j][3] = fmaf(tanhf(acc[3] + z.y), w_hi, em[j][3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int m = col[j] / KP8;
    if (m >= Ml) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = col[j] % KP8 + (e & 1), n = n0 + nl + (e >> 1) * 8;
      if (k < K && n < N)
        em_part[(((size_t)(s0 + m) * gridDim.y + g) * K + k) * N + n] =
            em[j][e];
    }
  }
}

// -- backward -------------------------------------------------------------------

// Route 0 runs 64 threads a member: phase A holds 2 stocks × KP moments a
// thread, phase B a (KP/4) × 4 register tile of dkT, so that a member's
// 4·⌈F/4⌉ tiles and its K dzp_m rows fit its threads at F ≤ 48
constexpr int kBwdPerMember = 64;
constexpr int kStageStride = kBwdTile + 4;  // odd quarter: conflict-free

template <int PB>
__device__ __forceinline__ void load_pb(float (&d)[PB], const float* p) {
  if constexpr (PB == 1) {
    d[0] = p[0];
  } else if constexpr (PB == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else if constexpr (PB == 3) {
    d[0] = p[0];
    d[1] = p[1];
    d[2] = p[2];
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Block (member group, 128-stock tile, period group), member groups of one
// tile adjacent. Period t's tile lands feature-major in one stage (fwd_load:
// 16-byte copies where N is a multiple of 4; two stages timed the same);
// with XT it is copied once into the stock-major xT (rounded in bf16) while
// phase A reads the stage: thread (member, stock slot sa) recomputes h for
// stocks sa and sa + 64 and writes dpre [128][DS] and dxr. Phase B: thread
// (member, kq, fq) forms the PB × 4 tile of dkT over j = 0..127 (moments
// kq·PB..; with XT features 4·fq.., one float4 of xT a stock; without,
// features fq + c·⌈F/4⌉ read from the stage: no xT, a smaller block), or
// one (member, moment) row of dzp_m. Period t + 1 lands while phase B runs
// (with XT) or after it. Shared memory: kT [MB][F][KP], zp_m [tpg][MB][KP],
// the stage [rows][132] (rows F with XT, else 4·⌈F/4⌉, those past F zero)
// and xr [MB][128], xT [128][XS] (XT only), dpre [128][DS] (and its bf16
// rounding, bf16 only).
template <int KP, bool BF16, bool XT, typename PX>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
cond_em_bwd_kernel(const PX* __restrict__ x, const float* __restrict__ zpm,
                   const float* __restrict__ xr,
                   const float* __restrict__ tinv,
                   const float* __restrict__ kT,
                   const float* __restrict__ gem, float* __restrict__ dkT_part,
                   float* __restrict__ dzpm_part, float* __restrict__ dxr,
                   int S, int T, int F, int N, int K, int tpg, int MB) {
  constexpr int PB = KP / 4, SPT = kBwdPerMember, CT = kBwdTile / SPT;
  constexpr int XST = kStageStride;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int XS = pad4(F), DS = odd4(MB * KP), FQ = (F + 3) / 4;
  const int rows = XT ? F : 4 * FQ;
  const int s0 = blockIdx.x * MB, tile = blockIdx.y, g = blockIdx.z;
  const int Ml = min(MB, S - s0), n0 = tile * kBwdTile;
  const int t0 = g * tpg, t1 = min(T, t0 + tpg);
  float* kTs = sm;
  float* zs = kTs + MB * F * KP;
  float* stage = zs + tpg * MB * KP;
  float* xrs = stage + rows * XST;
  float* xT = xrs + MB * kBwdTile;
  float* dps = xT + (XT ? kBwdTile * XS : 0);
  float* dpr = BF16 ? dps + kBwdTile * DS : dps;
  if (t0 < t1) {  // a group past T (T = 5 in 4 groups) has no period
    fwd_load(stage, XST, xrs, x, xr, t0, n0, s0, Ml, MB, T, F, N, kBwdTile);
    cp_async_commit();
  }
  if constexpr (XT) {
    for (int i = threadIdx.x; i < kBwdTile * (XS - F); i += blockDim.x)
      xT[(i / (XS - F)) * XS + F + i % (XS - F)] = 0.f;
  } else {
    for (int i = threadIdx.x; i < (rows - F) * XST; i += blockDim.x)
      stage[F * XST + i] = 0.f;
  }
  for (int i = threadIdx.x; i < MB * F * KP; i += blockDim.x) {
    const int m = i / (F * KP), f = (i / KP) % F, k = i % KP;
    const float v =
        (m < Ml && k < K) ? kT[((size_t)(s0 + m) * K + k) * F + f] : 0.f;
    kTs[i] = BF16 ? round_bf16(v) : v;
  }
  for (int i = threadIdx.x; i < tpg * MB * KP; i += blockDim.x) {
    const int tl = i / (MB * KP), m = (i / KP) % MB, k = i % KP;
    zs[i] = (m < Ml && k < K && t0 + tl < t1)
                ? zpm[((size_t)(s0 + m) * T + t0 + tl) * K + k]
                : 0.f;
  }
  // phase A's role: member ra, stocks sa + c·SPT
  const int ra = threadIdx.x / SPT, sa = threadIdx.x % SPT;
  const bool act_a = ra < Ml;
  float gm[KP][CT], tv[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const int n = n0 + sa + c * SPT;
    const bool ok = act_a && n < N;
    tv[c] = ok ? tinv[n] : 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k)
      gm[k][c] = ok && k < K ? gem[((size_t)(s0 + ra) * K + k) * N + n] : 0.f;
  }
  // phase B's role: a dkT tile (member mb, moments kq·PB.., features
  // 4·fq..) or a dzp_m row (member mz, moment kz)
  const int per_m = KP / PB * FQ, nB = MB * per_m;
  const int item = threadIdx.x;
  const int mb = item / per_m, kq = item % per_m / FQ, fq = item % FQ;
  const bool act_b = item < nB && mb < Ml;
  const int mz = (item - nB) / K, kz = (item - nB) % K;
  const bool act_z = item >= nB && item < nB + MB * K && mz < Ml;
  const int tiles = gridDim.y;
  float acc[PB][4];
#pragma unroll
  for (int a = 0; a < PB; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const float* xst = stage;
    cp_async_wait(0);
    __syncthreads();  // stage t has landed; phase B of t − 1 is done
    // -- the tile, stock-major, for phase B (lanes walk the features) ------
    if constexpr (XT) {
      for (Walk w = walk_start(F); w.r < kBwdTile / 4; walk_next(w, F)) {
        const float4 v =
            *reinterpret_cast<const float4*>(xst + w.c * XST + 4 * w.r);
        float* o = xT + 4 * w.r * XS + w.c;
        o[0] = BF16 ? round_bf16(v.x) : v.x;
        o[XS] = BF16 ? round_bf16(v.y) : v.y;
        o[2 * XS] = BF16 ? round_bf16(v.z) : v.z;
        o[3 * XS] = BF16 ? round_bf16(v.w) : v.w;
      }
    }
    // -- phase A: recompute h, then dpre and dxr per (member, stock) --------
    if (act_a) {
      float pre[KP][CT];
#pragma unroll
      for (int k = 0; k < KP; ++k)
#pragma unroll
        for (int c = 0; c < CT; ++c) pre[k][c] = 0.f;
      const float* xa = xst + sa;
      const float4* kb = reinterpret_cast<const float4*>(kTs + ra * F * KP);
#pragma unroll 4
      for (int f = 0; f < F; ++f) {
        float xv[CT];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          xv[c] = xa[f * XST + c * SPT];
          if constexpr (BF16) xv[c] = round_bf16(xv[c]);
        }
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) {
          const float4 w = kb[f * (KP / 4) + q];
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            pre[4 * q][c] = fmaf(w.x, xv[c], pre[4 * q][c]);
            pre[4 * q + 1][c] = fmaf(w.y, xv[c], pre[4 * q + 1][c]);
            pre[4 * q + 2][c] = fmaf(w.z, xv[c], pre[4 * q + 2][c]);
            pre[4 * q + 3][c] = fmaf(w.w, xv[c], pre[4 * q + 3][c]);
          }
        }
      }
      const float* z = zs + ((t - t0) * MB + ra) * KP;
      const float* xra = xrs + ra * kBwdTile + sa;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float w = xra[c * SPT] * tv[c];
        float dp[KP];
        float colsum = 0.f;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          dp[k] = 0.f;
          if (k < K) {
            const float h = tanhf(pre[k][c] + z[k]);
            dp[k] = gm[k][c] * w * (1.f - h * h);
            colsum = fmaf(gm[k][c], h, colsum);
          }
        }
        float4* drow =
            reinterpret_cast<float4*>(dps + (sa + c * SPT) * DS + ra * KP);
        float4* rrow =
            reinterpret_cast<float4*>(dpr + (sa + c * SPT) * DS + ra * KP);
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) {
          drow[q] = make_float4(dp[4 * q], dp[4 * q + 1], dp[4 * q + 2],
                                dp[4 * q + 3]);
          if constexpr (BF16)
            rrow[q] = make_float4(round_bf16(dp[4 * q]),
                                  round_bf16(dp[4 * q + 1]),
                                  round_bf16(dp[4 * q + 2]),
                                  round_bf16(dp[4 * q + 3]));
        }
        const int n = n0 + sa + c * SPT;
        if (n < N) dxr[((size_t)(s0 + ra) * T + t) * N + n] = colsum * tv[c];
      }
    }
    __syncthreads();  // xT and dpre are complete; with XT, stage t is free
    if (XT && t + 1 < t1) {
      fwd_load(stage, XST, xrs, x, xr, t + 1, n0, s0, Ml, MB, T, F, N,
               kBwdTile);
      cp_async_commit();
    }
    // -- phase B: dkT += Σ_j round(dpre) ⊗ round(x); dzp_m[t] = Σ_j dpre ----
    if (act_b) {
      float v[PB][4];
#pragma unroll
      for (int a = 0; a < PB; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[a][c] = 0.f;
      const float* dpb = dpr + mb * KP + kq * PB;
#pragma unroll 4
      for (int j = 0; j < kBwdTile; ++j) {
        float d[PB], xv[4];
        load_pb<PB>(d, dpb + j * DS);
        if constexpr (XT) {
          const float4 q = *reinterpret_cast<const float4*>(xT + j * XS +
                                                            fq * 4);
          xv[0] = q.x;
          xv[1] = q.y;
          xv[2] = q.z;
          xv[3] = q.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            xv[c] = xst[(fq + c * FQ) * XST + j];
            if constexpr (BF16) xv[c] = round_bf16(xv[c]);
          }
        }
#pragma unroll
        for (int a = 0; a < PB; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) v[a][c] = fmaf(d[a], xv[c], v[a][c]);
      }
#pragma unroll
      for (int a = 0; a < PB; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] += v[a][c];
    } else if (act_z) {
      const float* p = dps + mz * KP + kz;
      float v = 0.f;
#pragma unroll 8
      for (int j = 0; j < kBwdTile; ++j) v += p[j * DS];
      dzpm_part[(((size_t)(s0 + mz) * tiles + tile) * T + t) * K + kz] = v;
    }
    if (!XT && t + 1 < t1) {
      __syncthreads();  // phase B is done with the stage
      fwd_load(stage, XST, xrs, x, xr, t + 1, n0, s0, Ml, MB, T, F, N,
               kBwdTile);
      cp_async_commit();
    }
  }
  if (!act_b) return;
  float* out = dkT_part +
      ((((size_t)(s0 + mb) * gridDim.z + g) * tiles + tile) * K) * F;
#pragma unroll
  for (int a = 0; a < PB; ++a) {
    const int k = kq * PB + a;
    if (k >= K) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = XT ? fq * 4 + c : fq + c * FQ;
      if (f < F) out[k * F + f] = acc[a][c];
    }
  }
}

// -- backward, bf16 on the tensor cores -------------------------------------------

constexpr int kDpStride = kBwdTile + 8;  // bf16 dpre rows: 272 bytes

// Block (member group, 128-stock tile, period group) of `wpr` warps per row
// group × R/8/NT row groups; a warp owns 8/wpr of the tile's 16-stock
// sub-tiles. Phase A recomputes pre = x·kT on mma.sync (A = the panel
// stage's 16 stocks × 16 features, B = kT, NT n tiles of 8 stacked
// member-moments r = m·KP8 + k in registers), then h, dpre (bf16 [R][136]
// for phase B), and per sub-tile the dzp_m partials (shuffles over the
// stocks) and dxr partials (shuffles over the moments). Phase B forms dkT
// on mma.sync, A = dpre [16 rows × 16 stocks], B = the stage's [16 stocks ×
// 8 features], each warp owning at most two (row tile, feature tile)
// accumulators across all periods; the last sums (dzp_m over the 8
// sub-tiles, dxr over a member's n tiles) run in a fixed order. Shared
// memory: zp_m [tpg][R], the stages [NS][16·KS][132] (rows past F zero), xr
// [NS][MB][128], tinv [128], the dzp_m partials [8][R], the dxr partials
// [R/8][128], dpre [pad16(R)][136] bf16.
template <int NT, int KS, typename PX>
__global__ void __launch_bounds__(kFwdMaxThreads, 1)
cond_em_bwd_mma(const PX* __restrict__ x, const float* __restrict__ zpm,
                const float* __restrict__ xr, const float* __restrict__ tinv,
                const float* __restrict__ kT, const float* __restrict__ gem,
                float* __restrict__ dkT_part, float* __restrict__ dzpm_part,
                float* __restrict__ dxr, int S, int T, int F, int N, int K,
                int tpg, int MB, int NS, int wpr) {
  constexpr int XST = kStageStride, DPS = kDpStride;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int KP8 = pad8(K), R = MB * KP8, RM = (R + 15) / 16 * 16;
  const int xsz = 16 * KS * XST, FN = (F + 7) / 8;
  const int s0 = blockIdx.x * MB, tile = blockIdx.y, g = blockIdx.z;
  const int tiles = gridDim.y, Ml = min(MB, S - s0), n0 = tile * kBwdTile;
  const int t0 = g * tpg, t1 = min(T, t0 + tpg);
  float* zs = sm;
  float* stage = zs + tpg * R;
  float* xrs = stage + NS * xsz;
  float* tvs = xrs + NS * MB * kBwdTile;
  float* red = tvs + kBwdTile;
  float* dxp = red + 8 * R;
  __nv_bfloat16* dpb =
      reinterpret_cast<__nv_bfloat16*>(dxp + R / 8 * kBwdTile);
  const int ahead = NS > 1 ? NS - 1 : 1;
  for (int i = 0; i < ahead; ++i) {
    if (t0 + i < t1)
      fwd_load(stage + i * xsz, XST, xrs + i * MB * kBwdTile, x, xr, t0 + i,
               n0, s0, Ml, MB, T, F, N, kBwdTile);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < NS * (16 * KS - F) * XST; i += blockDim.x) {
    const int bi = i / ((16 * KS - F) * XST), e = i % ((16 * KS - F) * XST);
    stage[bi * xsz + F * XST + e] = 0.f;
  }
  for (int i = threadIdx.x; i < (RM - R) * DPS; i += blockDim.x)
    dpb[R * DPS + i] = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < tpg * R; i += blockDim.x) {
    const int tl = i / R, r = i % R, m = r / KP8, k = r % KP8;
    zs[i] = (m < Ml && k < K && t0 + tl < t1)
                ? zpm[((size_t)(s0 + m) * T + t0 + tl) * K + k]
                : 0.f;
  }
  for (int i = threadIdx.x; i < kBwdTile; i += blockDim.x)
    tvs[i] = n0 + i < N ? tinv[n0 + i] : 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp / wpr, wr = warp % wpr, subs = 8 / wpr;
  uint32_t bf[NT][KS][2];
  int col[NT], mw[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int r = (rg * NT + j) * 8 + gid, m = r / KP8, k = r % KP8;
    const bool ok = m < Ml && k < K;
    const float* kr = kT + ((size_t)(s0 + (ok ? m : 0)) * K + (ok ? k : 0)) * F;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 16 * kk + 2 * tig + (e & 1) + (e >> 1) * 8;
        v[e] = ok && f < F ? kr[f] : 0.f;
      }
      bf[j][kk][0] = pack_bf16(v[0], v[1]);
      bf[j][kk][1] = pack_bf16(v[2], v[3]);
    }
    col[j] = (rg * NT + j) * 8 + 2 * tig;
    mw[j] = col[j] / KP8;
  }
  // gem in the accumulator layout: sub-tile u, n tile j, element e = (stock
  // gid or gid + 8) × (row col[j] or col[j] + 1)
  float gm[2][NT][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + (wr * subs + u) * 16 + gid + (e >> 1) * 8;
        const int k = col[j] % KP8 + (e & 1);
        gm[u][j][e] = u < subs && mw[j] < Ml && k < K && n < N
                          ? gem[((size_t)(s0 + mw[j]) * K + k) * N + n]
                          : 0.f;
      }
  const int W = blockDim.x / 32, np = RM / 16 * FN;
  float acc2[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[q][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) % NS;
    cp_async_wait(NS > 1 ? NS - 2 : 0);
    __syncthreads();  // stage t has landed; phase B of t − 1 is done
    if (NS > 1) {
      if (t + NS - 1 < t1) {
        const int nb = (t - t0 + NS - 1) % NS;
        fwd_load(stage + nb * xsz, XST, xrs + nb * MB * kBwdTile, x, xr,
                 t + NS - 1, n0, s0, Ml, MB, T, F, N, kBwdTile);
      }
      cp_async_commit();
    }
    const float* xb = stage + b * xsz;
    const float* xrb = xrs + b * MB * kBwdTile;
    const float* zt = zs + (t - t0) * R;
    // -- phase A: pre on the tensor cores; h, dpre, the partial sums --------
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= subs) break;
      const int ws = wr * subs + u, nl = ws * 16 + gid;
      uint32_t a[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) x_frag(a[kk], xb + nl, kk, tig, XST);
      const float tv_lo = tvs[nl], tv_hi = tvs[nl + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_bf16(acc, a[kk], bf[j][kk][0], bf[j][kk][1]);
        const float2 z = *reinterpret_cast<const float2*>(zt + col[j]);
        const float w_lo = xrb[mw[j] * kBwdTile + nl] * tv_lo;
        const float w_hi = xrb[mw[j] * kBwdTile + nl + 8] * tv_hi;
        float h[4], dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = tanhf(acc[e] + ((e & 1) ? z.y : z.x));
          dp[e] = gm[u][j][e] * ((e >> 1) ? w_hi : w_lo) * (1.f - h[e] * h[e]);
        }
        // dxr: Σ over the moments of gem·h, here over this n tile's 8
        float p_lo = gm[u][j][0] * h[0] + gm[u][j][1] * h[1];
        float p_hi = gm[u][j][2] * h[2] + gm[u][j][3] * h[3];
        p_lo += __shfl_xor_sync(0xffffffffu, p_lo, 1);
        p_hi += __shfl_xor_sync(0xffffffffu, p_hi, 1);
        p_lo += __shfl_xor_sync(0xffffffffu, p_lo, 2);
        p_hi += __shfl_xor_sync(0xffffffffu, p_hi, 2);
        if (tig == 0) {
          dxp[(rg * NT + j) * kBwdTile + nl] = p_lo;
          dxp[(rg * NT + j) * kBwdTile + nl + 8] = p_hi;
        }
        // dzp_m: Σ over this sub-tile's 16 stocks of dpre
        float q0 = dp[0] + dp[2], q1 = dp[1] + dp[3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          q0 += __shfl_xor_sync(0xffffffffu, q0, o);
          q1 += __shfl_xor_sync(0xffffffffu, q1, o);
        }
        if (gid == 0) {
          red[ws * R + col[j]] = q0;
          red[ws * R + col[j] + 1] = q1;
        }
        __nv_bfloat16* dr = dpb + col[j] * DPS + nl;
        dr[0] = __float2bfloat16_rn(dp[0]);
        dr[DPS] = __float2bfloat16_rn(dp[1]);
        dr[8] = __float2bfloat16_rn(dp[2]);
        dr[DPS + 8] = __float2bfloat16_rn(dp[3]);
      }
    }
    __syncthreads();  // dpre and the partial sums are complete
    // -- phase B: dkT += dpre · x on the tensor cores; the last sums -------
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int p = warp + q * W;
      if (p >= np) break;
      const int mt = p / FN, nt = p % FN;
      const __nv_bfloat16* ar = dpb + (mt * 16 + gid) * DPS + 2 * tig;
      const float* xf = xb + (nt * 8 + gid) * XST + 2 * tig;
#pragma unroll
      for (int ks = 0; ks < kBwdTile / 16; ++ks) {
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(ar + 16 * ks),
            *reinterpret_cast<const uint32_t*>(ar + 8 * DPS + 16 * ks),
            *reinterpret_cast<const uint32_t*>(ar + 16 * ks + 8),
            *reinterpret_cast<const uint32_t*>(ar + 8 * DPS + 16 * ks + 8)};
        const float2 v0 = *reinterpret_cast<const float2*>(xf + 16 * ks);
        const float2 v1 = *reinterpret_cast<const float2*>(xf + 16 * ks + 8);
        mma_bf16(acc2[q], a, pack_bf16(v0.x, v0.y), pack_bf16(v1.x, v1.y));
      }
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const int m = r / KP8, k = r % KP8;
      if (m >= Ml || k >= K) continue;
      float v = 0.f;
#pragma unroll
      for (int ws = 0; ws < 8; ++ws) v += red[ws * R + r];
      dzpm_part[(((size_t)(s0 + m) * tiles + tile) * T + t) * K + k] = v;
    }
    for (int i = threadIdx.x; i < MB * kBwdTile; i += blockDim.x) {
      const int m = i / kBwdTile, nn = i % kBwdTile;
      if (m >= Ml || n0 + nn >= N) continue;
      float v = 0.f;
      for (int jj = 0; jj < KP8 / 8; ++jj)
        v += dxp[(m * KP8 / 8 + jj) * kBwdTile + nn];
      dxr[((size_t)(s0 + m) * T + t) * N + n0 + nn] = v * tvs[nn];
    }
    if (NS == 1 && t + 1 < t1) {
      __syncthreads();  // phase B is done with the stage
      fwd_load(stage, XST, xrs, x, xr, t + 1, n0, s0, Ml, MB, T, F, N,
               kBwdTile);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = warp + q * W;
    if (p >= np) break;
    const int mt = p / FN, nt = p % FN;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = mt * 16 + gid + (e >> 1) * 8, f = nt * 8 + 2 * tig + (e & 1);
      const int m = r / KP8, k = r % KP8;
      if (r < R && m < Ml && k < K && f < F)
        dkT_part[(((((size_t)(s0 + m) * gridDim.z + g) * tiles + tile) * K +
                   k) * F) + f] = acc2[q][e];
    }
  }
}

// -- panel cotangent --------------------------------------------------------------

constexpr int kDxMaxThreads = 512;  // launch bounds: ≤ 128 registers
constexpr int kDxStages = 2;        // panel tiles: one computes, one lands
constexpr int kDxFeatures = 6;      // route 0's dx tile: 6 features × 4 stocks

__host__ __device__ constexpr int pad16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int pad6(int v) { return (v + 5) / 6 * 6; }

// a cell c of the (stock tile, period) walk, the period innermost
struct DxCell {
  int t, n0;
};

__device__ __forceinline__ DxCell dx_cell(int c, int T, int tile) {
  return DxCell{c % T, c / T * tile};
}

// this block's contiguous run of cells [c0, c1) of `cells`, split evenly
__device__ __forceinline__ void dx_run(int cells, int& c0, int& c1) {
  c0 = (int)((long long)blockIdx.x * cells / gridDim.x);
  c1 = (int)((long long)(blockIdx.x + 1) * cells / gridDim.x);
}

// four consecutive floats p[0..3] of a row, where only `left` of them lie
// before the row's end N (zero past it): a float4 load where the row is
// 16-byte aligned and whole
__device__ __forceinline__ float4 ldg4(const float* p, int left, bool vec) {
  if (vec && left >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(left > 0 ? __ldg(p) : 0.f, left > 1 ? __ldg(p + 1) : 0.f,
                     left > 2 ? __ldg(p + 2) : 0.f,
                     left > 3 ? __ldg(p + 3) : 0.f);
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Route 0. Shared memory: kT [S][pad6(F)][KP] (rounded by the wrapper;
// features past F and moments past K zero), the panel tiles [2][F][tile],
// the xr rows [2][S][tile], dpre [S·KP][tile]. Phase A: item (member s,
// moments k0..k0 + RT, stocks 4·sc..) recomputes pre, h and dpre; phase B:
// item (features 6·fg.., stocks 4·sc..) forms that dx tile over all members.
// Items are dealt out to the block's threads in turn.
template <int RT, bool BF16, typename PX>
__global__ void __launch_bounds__(kDxMaxThreads, 1)
cond_em_dx_cores(const PX* __restrict__ x, const float* __restrict__ zpm,
                 const float* __restrict__ xr, const float* __restrict__ tinv,
                 const float* __restrict__ kT, const float* __restrict__ gem,
                 PX* __restrict__ dx, int S, int T, int F, int N, int K,
                 int tile, int cells) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int KP = pad4(K), FP = pad6(F), chunks = KP / RT, spt = tile / 4;
  float* kTs = sm;
  float* xs = kTs + S * FP * KP;
  float* xrs = xs + kDxStages * F * tile;
  float* dps = xrs + kDxStages * S * tile;
  const bool vec = (N & 3) == 0;
  int c0, c1;
  dx_run(cells, c0, c1);
  for (int i = 0; i < kDxStages; ++i) {  // cells c0 and c0 + 1 in flight
    if (c0 + i < c1) {
      const DxCell cl = dx_cell(c0 + i, T, tile);
      fwd_load(xs + i * F * tile, tile, xrs + i * S * tile, x, xr, cl.t,
               cl.n0, 0, S, S, T, F, N, tile);
    }
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < S * FP * KP; i += blockDim.x) {
    const int s = i / (FP * KP), f = (i / KP) % FP, k = i % KP;
    kTs[i] = f < F && k < K ? kT[((size_t)s * K + k) * F + f] : 0.f;
  }
  const int itemsA = S * chunks * spt, itemsB = FP / kDxFeatures * spt;
  for (int c = c0, it = 0; c < c1; ++c, ++it) {
    const int b = it & 1;
    const DxCell cl = dx_cell(c, T, tile);
    cp_async_wait(1);
    __syncthreads();  // cell c has landed; phase B of c − 1 is done
    const float* xb = xs + b * F * tile;
    const float* xrb = xrs + b * S * tile;
    // -- phase A: pre, h and dpre for RT member-moments × 4 stocks ---------
    for (int i = threadIdx.x; i < itemsA; i += blockDim.x) {
      const int sc = i % spt, rc = i / spt, s = rc / chunks;
      const int k0 = rc % chunks * RT, n = cl.n0 + 4 * sc;
      const float4 tv = ldg4(tinv + n, N - n, vec);
      float4 gm[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        gm[r] = k0 + r < K ? ldg4(gem + ((size_t)s * K + k0 + r) * N + n,
                                  N - n, vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      float pre[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) pre[r][j] = 0.f;
      const float4* kb =
          reinterpret_cast<const float4*>(kTs + (size_t)s * FP * KP + k0);
#pragma unroll 2
      for (int f = 0; f < F; ++f) {
        float4 xv = reinterpret_cast<const float4*>(xb + f * tile)[sc];
        if constexpr (BF16)
          xv = make_float4(round_bf16(xv.x), round_bf16(xv.y),
                           round_bf16(xv.z), round_bf16(xv.w));
#pragma unroll
        for (int q = 0; q < RT / 4; ++q) {
          const float4 w = kb[f * (KP / 4) + q];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xj = f4(xv, j);
            pre[4 * q][j] = fmaf(w.x, xj, pre[4 * q][j]);
            pre[4 * q + 1][j] = fmaf(w.y, xj, pre[4 * q + 1][j]);
            pre[4 * q + 2][j] = fmaf(w.z, xj, pre[4 * q + 2][j]);
            pre[4 * q + 3][j] = fmaf(w.w, xj, pre[4 * q + 3][j]);
          }
        }
      }
      const float4 xv = reinterpret_cast<const float4*>(xrb + s * tile)[sc];
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = f4(xv, j) * f4(tv, j);
      const float* z = zpm + ((size_t)s * T + cl.t) * K;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        if (k0 + r < K) {
          const float zk = __ldg(z + k0 + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float h = tanhf(pre[r][j] + zk);
            const float gmj = f4(gm[r], j);
            const float v = gmj * w[j] * (1.f - h * h);
            dp[j] = BF16 ? round_bf16(v) : v;
          }
        }
        reinterpret_cast<float4*>(dps + (size_t)(s * KP + k0 + r) * tile)[sc] =
            make_float4(dp[0], dp[1], dp[2], dp[3]);
      }
    }
    __syncthreads();  // dpre is complete; the panel tile b is spent
    if (c + kDxStages < c1) {
      const DxCell nx = dx_cell(c + kDxStages, T, tile);
      fwd_load(xs + b * F * tile, tile, xrs + b * S * tile, x, xr, nx.t,
               nx.n0, 0, S, S, T, F, N, tile);
    }
    cp_async_commit();
    // -- phase B: dx[f, n] = Σ_s (Σ_k kT[s,k,f] · dpre[s,k,n]) -------------
    for (int i = threadIdx.x; i < itemsB; i += blockDim.x) {
      const int sc = i % spt, f0 = i / spt * kDxFeatures;
      float acc[kDxFeatures][4];
#pragma unroll
      for (int a = 0; a < kDxFeatures; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
      for (int s = 0; s < S; ++s) {
        float v[kDxFeatures][4];
#pragma unroll
        for (int a = 0; a < kDxFeatures; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[a][j] = 0.f;
        const float4* kb = reinterpret_cast<const float4*>(
            kTs + ((size_t)s * FP + f0) * KP);
        const float4* db =
            reinterpret_cast<const float4*>(dps + (size_t)s * KP * tile) + sc;
        for (int kq = 0; kq < KP / 4; ++kq) {
          float4 d[4], kv[kDxFeatures];
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = db[(4 * kq + e) * spt];
#pragma unroll
          for (int a = 0; a < kDxFeatures; ++a) kv[a] = kb[a * (KP / 4) + kq];
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int a = 0; a < kDxFeatures; ++a)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                v[a][j] = fmaf(f4(kv[a], e), f4(d[e], j), v[a][j]);
        }
#pragma unroll
        for (int a = 0; a < kDxFeatures; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[a][j] += v[a][j];
      }
      const int n = cl.n0 + 4 * sc, left = N - n;
#pragma unroll
      for (int a = 0; a < kDxFeatures; ++a) {
        if (f0 + a >= F || left <= 0) continue;
        PX* o = dx + ((size_t)cl.t * F + f0 + a) * N + n;
        if (!panel::kBf16<PX> && vec && left >= 4) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < left) panel::st(o + j, acc[a][j]);
        }
      }
    }
  }
}

// Route 1 (bf16, F ≤ 64): tile / 16 warps, warp w on stocks 16·w.. of the
// tile. Shared memory (32-bit words): kT in the first product's B layout,
// bf16 [RP][16·KS + 8] (row r = s·K + k, features contiguous), and in the
// second's, bf16 [16·KS][RP + 8] (row f, member-moments contiguous), RP =
// pad16(S·K), rows padded so that a fragment load's 8 rows × 4 words hit 32
// banks; the member of each r [RP]; the panel slabs [2][16·KS][tile + 4]
// (rows past F zero), the xr rows [2][S][tile] and the period's zp_m
// [2][RP] (past S·K zero).
template <int KS, typename PX>
__global__ void __launch_bounds__(kDxMaxThreads, 1)
cond_em_dx_mma(const PX* __restrict__ x, const float* __restrict__ zpm,
               const float* __restrict__ xr, const float* __restrict__ tinv,
               const float* __restrict__ kT, const float* __restrict__ gem,
               PX* __restrict__ dx, int S, int T, int F, int N, int K,
               int tile, int cells) {
  constexpr int FN = 2 * KS;  // dx's n tiles of 8 features
  extern __shared__ float4 sm4[];
  uint32_t* smw = reinterpret_cast<uint32_t*>(sm4);
  const int R = S * K, RP = pad16(R), aw = 8 * KS + 4, bw = RP / 2 + 4;
  const int xst = tile + 4, xsz = 16 * KS * xst;
  uint32_t* ka = smw;           // [RP][aw]
  uint32_t* kb = ka + RP * aw;  // [16·KS][bw]
  int* mem = reinterpret_cast<int*>(kb + 16 * KS * bw);  // [RP]
  float* xs = reinterpret_cast<float*>(mem + RP);
  float* xrs = xs + kDxStages * xsz;
  float* zs = xrs + kDxStages * S * tile;
  // stage cell c into buffer i: the panel slab, the xr rows, zp_m[:, t, :]
  auto stage = [&](int c, int i) {
    const DxCell cl = dx_cell(c, T, tile);
    fwd_load(xs + i * xsz, xst, xrs + i * S * tile, x, xr, cl.t, cl.n0, 0, S,
             S, T, F, N, tile);
    for (int r = threadIdx.x; r < RP; r += blockDim.x) {
      const int sr = r / K;
      cp_async4(zs + i * RP + r,
                r < R ? zpm + ((size_t)sr * T + cl.t) * K + (r - sr * K)
                      : zpm,
                r < R);
    }
  };
  int c0, c1;
  dx_run(cells, c0, c1);
  if (c0 < c1) stage(c0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < kDxStages * (16 * KS - F) * xst;
       i += blockDim.x) {
    const int bi = i / ((16 * KS - F) * xst), e = i % ((16 * KS - F) * xst);
    xs[bi * xsz + F * xst + e] = 0.f;
  }
  __nv_bfloat16* kab = reinterpret_cast<__nv_bfloat16*>(ka);
  for (int i = threadIdx.x; i < RP * 2 * aw; i += blockDim.x) {
    const int r = i / (2 * aw), f = i % (2 * aw);
    kab[i] = __float2bfloat16_rn(r < R && f < F ? kT[(size_t)r * F + f] : 0.f);
  }
  __nv_bfloat16* kbb = reinterpret_cast<__nv_bfloat16*>(kb);
  for (int i = threadIdx.x; i < 16 * KS * 2 * bw; i += blockDim.x) {
    const int f = i / (2 * bw), r = i % (2 * bw);
    kbb[i] = __float2bfloat16_rn(r < R && f < F ? kT[(size_t)r * F + f] : 0.f);
  }
  for (int r = threadIdx.x; r < RP; r += blockDim.x) mem[r] = r < R ? r / K : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, nl = 16 * warp + gid;
  const bool vec = (N & 3) == 0;
  for (int c = c0, it = 0; c < c1; ++c, ++it) {
    const int b = it & 1;
    const DxCell cl = dx_cell(c, T, tile);
    __syncthreads();  // cell c − 1 is stored: its buffers b ^ 1 are free
    if (c + 1 < c1) stage(c + 1, b ^ 1);
    cp_async_commit();
    cp_async_wait(1);
    __syncthreads();  // cell c has landed
    float* xb = xs + b * xsz;
    const float* xrb = xrs + b * S * tile + nl;
    const float* zb = zs + b * RP;
    uint32_t a[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) x_frag(a[kk], xb + nl, kk, tig, xst);
    const int n_lo = cl.n0 + nl, n_hi = n_lo + 8;
    const float tv_lo = n_lo < N ? __ldg(tinv + n_lo) : 0.f;
    const float tv_hi = n_hi < N ? __ldg(tinv + n_hi) : 0.f;
    const float* g_lo = gem + (n_lo < N ? n_lo : 0);
    const float* g_hi = gem + (n_hi < N ? n_hi : 0);
    float acc[FN][4];
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int q = 0; q < RP / 16; ++q) {
      // member-moments 16·q .. 16·q + 15 (n tiles 2q, 2q + 1): this thread's
      // columns r = 16q + 8h + 2·tig (+ 1), stocks nl and nl + 8. Their
      // gem, zp_m and w = xr · tinv first, then pre on the tensor cores
      float gm[2][4], z[2][2], w[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int r = 16 * q + 8 * h + 2 * tig + o;
          const bool ok = r < R;
          const int m = mem[r];
          gm[h][o] = ok && n_lo < N ? __ldg(g_lo + (size_t)r * N) : 0.f;
          gm[h][o + 2] = ok && n_hi < N ? __ldg(g_hi + (size_t)r * N) : 0.f;
          z[h][o] = zb[r];
          w[h][o] = xrb[m * tile] * tv_lo;
          w[h][o + 2] = xrb[m * tile + 8] * tv_hi;
        }
      }
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t* br = ka + (16 * q + 8 * h + gid) * aw + tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) p[h][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_bf16(p[h], a[kk], br[8 * kk], br[8 * kk + 4]);
      }
      // dpre = gem · (xr · tinv) · (1 − h²), rounded to bf16: the two n
      // tiles' accumulators are, as they stand, the A fragment of one k
      // step of the second product
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dp[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hh = tanhf(p[h][e] + z[h][e & 1]);
          dp[e] = gm[h][e] * w[h][e] * (1.f - hh * hh);
        }
        pa[2 * h] = pack_bf16(dp[0], dp[1]);      // stock nl
        pa[2 * h + 1] = pack_bf16(dp[2], dp[3]);  // stock nl + 8
      }
      // dx += dpre[16 stocks × 16 r] · kT[16 r × 8 features], per n tile
      const uint32_t* bq = kb + gid * bw + 8 * q + tig;
#pragma unroll
      for (int j = 0; j < FN; ++j)
        mma_bf16(acc[j], pa, bq[8 * j * bw], bq[8 * j * bw + 4]);
    }
    // the dx tile through this warp's own columns of the spent slab b
    __syncwarp();
#pragma unroll
    for (int j = 0; j < FN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 8 * j + 2 * tig + (e & 1);
        if (f < F) xb[f * xst + nl + (e >> 1) * 8] = acc[j][e];
      }
    }
    __syncthreads();  // the dx tile [F][tile] is complete
    const int q4 = tile / 4;
    for (Walk wk = walk_start(q4); wk.r < F; walk_next(wk, q4)) {
      const int n = cl.n0 + 4 * wk.c, left = N - n;
      if (left <= 0) continue;
      const float4 v = *reinterpret_cast<const float4*>(xb + wk.r * xst +
                                                        4 * wk.c);
      PX* o = dx + ((size_t)cl.t * F + wk.r) * N + n;
      if (!panel::kBf16<PX> && vec && left >= 4) {
        *reinterpret_cast<float4*>(o) = v;
      } else {
        for (int j = 0; j < 4 && j < left; ++j) panel::st(o + j, f4(v, j));
      }
    }
  }
}

// The panel cotangent's plan: (route, tile, threads) → shared-memory floats,
// or kUnsupported. Route 0: tile a multiple of 4, threads whole warps; route
// 1 (bf16, F ≤ 64): tile a multiple of 16, one warp per 16 stocks.
int dx_geometry(int S, int F, int K, int bf16, int route, int tile,
                int threads, long long* floats) {
  if (tile < 4 || threads < 32 || threads % 32 || threads > kDxMaxThreads)
    return kUnsupported;
  if (route == kRouteMma) {
    if (!bf16 || F > kMmaMaxF || tile % 16 || threads != 2 * tile)
      return kUnsupported;
    const long long RP = pad16(S * K), ks = (F + 15) / 16;
    *floats = RP * (8 * ks + 4) + 16 * ks * (RP / 2 + 4) + RP +
              kDxStages * (16 * ks * (tile + 4) + (long long)S * tile + RP);
    return 0;
  }
  if (route != kRouteCores || tile % 4) return kUnsupported;
  const long long kp = pad4(K);
  *floats = S * pad6(F) * kp + kDxStages * (long long)(F + S) * tile +
            S * kp * tile;
  return 0;
}

// the panel cotangent's kernel instance on the panel type PX: route 0 by K
// (RT) and bf16, route 1 by KS = ⌈F/16⌉
template <typename PX>
const void* dx_kernel_of(int route, int F, int K, int bf16) {
  if (route == kRouteMma) {
    switch ((F + 15) / 16) {
      case 1: return (const void*)cond_em_dx_mma<1, PX>;
      case 2: return (const void*)cond_em_dx_mma<2, PX>;
      case 3: return (const void*)cond_em_dx_mma<3, PX>;
      case 4: return (const void*)cond_em_dx_mma<4, PX>;
      default: return nullptr;
    }
  }
  if (route != kRouteCores) return nullptr;
  if (pad4(K) % 8)
    return bf16 ? (const void*)cond_em_dx_cores<4, true, PX>
                : (const void*)cond_em_dx_cores<4, false, PX>;
  return bf16 ? (const void*)cond_em_dx_cores<8, true, PX>
              : (const void*)cond_em_dx_cores<8, false, PX>;
}

bool bad_shape(int S, int T, int F, int N, int K, int groups) {
  return S < 1 || T < 1 || F < 1 || N < 1 || K < 1 || K > kMaxK ||
         S > 65535 || groups < 1 || groups > 65535;
}

// -- plans (ops/cond_em.py::cem_plan computes them; this file checks them) ------

enum { kFwd = 0, kBwd = 1, kDx = 2 };

// the forward's kernel instance on the panel type PX: route 0 at RT (from
// K) and var = CT stocks per thread, route 1 at var = NT n tiles per warp
// and KS = ⌈F/16⌉ k steps
template <typename PX>
const void* fwd_kernel_of(int route, int F, int K, int var, int bf16) {
  if (route == kRouteMma) {
    const int ks = (F + 15) / 16;
#define CEM_MMA(nt, kss)        \
  if (var == nt && ks == kss) \
    return (const void*)cond_em_fwd_mma<nt, kss, PX>;
    CEM_MMA(1, 1) CEM_MMA(1, 2) CEM_MMA(1, 3) CEM_MMA(1, 4)
    CEM_MMA(2, 1) CEM_MMA(2, 2) CEM_MMA(2, 3) CEM_MMA(2, 4)
    CEM_MMA(3, 1) CEM_MMA(3, 2) CEM_MMA(3, 3) CEM_MMA(3, 4)
#undef CEM_MMA
    return nullptr;
  }
  if (route != kRouteCores) return nullptr;
  const int rt = pad4(K) % 8 ? 4 : 8;
#define CEM_CORES(r, c)                                                    \
  if (rt == r && var == c)                                                 \
    return bf16 ? (const void*)cond_em_fwd_cores<r, c, true, PX>           \
                : (const void*)cond_em_fwd_cores<r, c, false, PX>;
  CEM_CORES(8, 1) CEM_CORES(8, 2) CEM_CORES(4, 2)
#undef CEM_CORES
  return nullptr;
}

// the backward's kernel instance on the panel type PX: route 0 by K, bf16
// and var (0 through the stock-major xT, 1 without), route 1 (bf16) at var
// = NT n tiles per warp and KS = ⌈F/16⌉ k steps
template <typename PX>
const void* bwd_kernel_of(int route, int F, int K, int var, int bf16) {
  if (route == kRouteMma) {
    const int ks = (F + 15) / 16;
#define CEM_MMA(nt, kss)        \
  if (var == nt && ks == kss) \
    return (const void*)cond_em_bwd_mma<nt, kss, PX>;
    CEM_MMA(1, 1) CEM_MMA(1, 2) CEM_MMA(1, 3) CEM_MMA(1, 4)
    CEM_MMA(2, 1) CEM_MMA(2, 2) CEM_MMA(2, 3) CEM_MMA(2, 4)
    CEM_MMA(3, 1) CEM_MMA(3, 2) CEM_MMA(3, 3) CEM_MMA(3, 4)
#undef CEM_MMA
    return nullptr;
  }
  if (route != kRouteCores) return nullptr;
  // var 0: through the stock-major xT; 1: without it
  if (var != 0 && var != 1) return nullptr;
  switch (pad4(K) * 2 + var) {
#define CEM_BWD(kp, v)                                                   \
  case kp * 2 + v:                                                       \
    return bf16 ? (const void*)cond_em_bwd_kernel<kp, true, v == 0, PX>  \
                : (const void*)cond_em_bwd_kernel<kp, false, v == 0, PX>;
    CEM_BWD(4, 0) CEM_BWD(8, 0) CEM_BWD(12, 0) CEM_BWD(16, 0)
    CEM_BWD(4, 1) CEM_BWD(8, 1) CEM_BWD(12, 1) CEM_BWD(16, 1)
#undef CEM_BWD
    default:
      return nullptr;
  }
}

// the three kernels' instances on this library's panel dtype, or nullptr
// for a panel of the other (xb16 1: bf16, 0: f32)
using Panel = std::conditional_t<COND_EM_PANEL_BF16, __nv_bfloat16, float>;

const void* fwd_kernel_of(int route, int F, int K, int var, int bf16,
                          int xb16) {
  if (xb16 != COND_EM_PANEL_BF16) return nullptr;
  return fwd_kernel_of<Panel>(route, F, K, var, bf16);
}

const void* bwd_kernel_of(int route, int F, int K, int var, int bf16,
                          int xb16) {
  if (xb16 != COND_EM_PANEL_BF16) return nullptr;
  return bwd_kernel_of<Panel>(route, F, K, var, bf16);
}

const void* dx_kernel_of(int route, int F, int K, int bf16, int xb16) {
  if (xb16 != COND_EM_PANEL_BF16) return nullptr;
  return dx_kernel_of<Panel>(route, F, K, bf16);
}

// The forward's plan: (route, stock tile, members per block, var, stages)
// → threads and shared-memory floats, or kUnsupported
int fwd_geometry(int S, int F, int K, int tpg, int bf16, int route, int tile,
                 int M, int var, int NS, int* threads, long long* floats) {
  if (M < 1 || M > S || tile < 1 || NS < 2 || NS > 4) return kUnsupported;
  if (route == kRouteMma) {
    if (!bf16 || F > kMmaMaxF || tile % 16 || var != mma_nt(M, K))
      return kUnsupported;
    const long long R = (long long)M * pad8(K), ks = (F + 15) / 16;
    *threads = 32 * (int)(R / 8 / var) * (tile / 16);
    *floats = tpg * R + NS * 16 * ks * (tile + 4) + (long long)NS * M * tile;
  } else if (route == kRouteCores) {
    const int kp = pad4(K), rt = kp % 8 ? 4 : 8;
    if ((var != 2 && !(rt == 8 && var == 1)) || tile % 4 ||
        NS != kFwdCoresStages)
      return kUnsupported;
    *threads = (M * (kp / rt) * (tile / var) + 31) / 32 * 32;
    *floats = (long long)M * F * kp + (long long)tpg * M * kp +
              (long long)NS * F * tile + (long long)NS * M * tile;
  } else {
    return kUnsupported;
  }
  return *threads <= kFwdMaxThreads ? 0 : kUnsupported;
}

// The backward's plan: (route, members per block, var, stages) → threads
// and shared-memory floats, or kUnsupported. Route 1's var is its warps per
// row group (4 or 8); route 0's is 0 with the stock-major xT, 1 without.
int bwd_geometry(int S, int F, int K, int tpg, int bf16, int route, int MB,
                 int var, int NS, int* threads, long long* floats) {
  if (MB < 1 || MB > S || NS < 1 || NS > 2) return kUnsupported;
  if (route == kRouteMma) {
    if (!bf16 || F > kMmaMaxF || (var != 4 && var != 8)) return kUnsupported;
    const long long R = (long long)MB * pad8(K), ks = (F + 15) / 16;
    const int rg = (int)(R / 8 / mma_nt(MB, K));
    *threads = 32 * var * rg;
    if ((R + 15) / 16 * ((F + 7) / 8) > 2LL * var * rg) return kUnsupported;
    *floats = tpg * R + NS * 16 * ks * kStageStride +
              (long long)NS * MB * kBwdTile + kBwdTile + 8 * R +
              R / 8 * kBwdTile + (R + 15) / 16 * 16 * kDpStride / 2;
    return *threads <= kFwdMaxThreads ? 0 : kUnsupported;
  }
  // route 0: var 0 through the stock-major xT, 1 without it; one stage
  if (route != kRouteCores || (var != 0 && var != 1) || NS != 1)
    return kUnsupported;
  const int kp = pad4(K), fq = (F + 3) / 4, b = 4 * fq + K;
  const bool xt = var == 0;
  *threads = (MB * (b > kBwdPerMember ? b : kBwdPerMember) + 31) / 32 * 32;
  *floats = (long long)MB * F * kp + (long long)tpg * MB * kp +
            (long long)(xt ? F : 4 * fq) * kStageStride +
            (long long)MB * kBwdTile +
            (xt ? (long long)kBwdTile * pad4(F) : 0LL) +
            (bf16 ? 2LL : 1LL) * kBwdTile * odd4(MB * kp);
  return *threads <= kBwdMaxThreads ? 0 : kUnsupported;
}

// 0 if the card takes `kern` at `threads` and `smem` bytes: resident blocks
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and
// local-memory bytes per thread; else a cudaError_t value. It lets `kern`
// take the most shared memory a block may have, so that every plan of the
// kernel launches once one has been checked.
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

// the kernel of a plan, after checking it against this file: its threads
// and shared bytes must be what the geometry gives
const void* checked_plan(int kernel, int S, int T, int F, int N, int K,
                         int groups, int bf16, int route, int tile,
                         int members, int threads, int var, int stages,
                         long long smem_bytes, int xb16) {
  if (bad_shape(S, T, F, N, K, groups)) return nullptr;
  const int tpg = (T + groups - 1) / groups;
  int th = 0;
  long long floats = 0;
  const void* kern = nullptr;
  if (kernel == kFwd) {
    if (fwd_geometry(S, F, K, tpg, bf16, route, tile, members, var, stages,
                     &th, &floats) != 0)
      return nullptr;
    kern = fwd_kernel_of(route, F, K, var, bf16, xb16);
  } else if (kernel == kBwd) {
    if (tile != kBwdTile || bwd_geometry(S, F, K, tpg, bf16, route, members,
                                         var, stages, &th, &floats) != 0)
      return nullptr;
    kern = bwd_kernel_of(route, F, K,
                         route == kRouteMma ? mma_nt(members, K) : var, bf16,
                         xb16);
  }
  if (th != threads || 4 * floats != smem_bytes || smem_bytes > kMaxSmem)
    return nullptr;
  return kern;
}

// the panel cotangent's kernel for a plan, after checking it against this
// file: its shared bytes must be what the geometry gives, G at most the cells
const void* checked_dx_plan(int S, int T, int F, int N, int K, int bf16,
                            int route, int tile, int threads, int G,
                            long long smem_bytes, int xb16, int* cells) {
  if (bad_shape(S, T, F, N, K, 1) || G < 1) return nullptr;
  long long floats = 0;
  if (dx_geometry(S, F, K, bf16, route, tile, threads, &floats) != 0 ||
      4 * floats != smem_bytes || smem_bytes > kMaxSmem)
    return nullptr;
  const long long n = (long long)T * ((N + tile - 1) / tile);
  if (n > 0x7fffffffLL || G > n) return nullptr;
  *cells = (int)n;
  return dx_kernel_of(route, F, K, bf16, xb16);
}

}  // namespace

// Registers per thread of a kernel instance (kernel 0 forward: route, var as
// in the plan; kernel 1 backward: route 0 by K, bf16 and var, route 1 at
// var = NT n tiles per warp; kernel 2 the panel cotangent: route 0 by K and
// bf16, route 1 by F, var unused) on an f32 (xb16 0) or bf16 (1) panel, or
// -1.
extern "C" int cond_em_registers(int kernel, int F, int K, int bf16,
                                 int route, int var, int xb16) {
  if (F < 1 || K < 1 || K > kMaxK) return kUnsupported;
  const void* kern =
      kernel == kFwd   ? fwd_kernel_of(route, F, K, var, bf16, xb16)
      : kernel == kBwd ? bwd_kernel_of(route, F, K, var, bf16, xb16)
      : kernel == kDx  ? dx_kernel_of(route, F, K, bf16, xb16)
                       : nullptr;
  if (kern == nullptr) return kUnsupported;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kern) != cudaSuccess) return kUnsupported;
  return attr.numRegs;
}

// What the card makes of a plan: out = [resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
// local-memory bytes per thread]. var: the forward's CT (route 0) or NT
// (route 1), the backward's as in bwd_geometry; stages: the panel tiles in
// flight; xb16: the instance for an f32 (0) or bf16 (1) panel. Returns 0,
// a cudaError_t value, or -1 for a plan this file refuses. The wrapper
// calls it once for each plan, before the plan's first launch, and refuses
// a plan whose blocks the card does not hold.
extern "C" int cond_em_plan_info(int kernel, int S, int T, int F, int N,
                                 int K, int groups, int bf16, int route,
                                 int tile, int members, int threads, int var,
                                 int stages, long long smem_bytes, int xb16,
                                 int* out) {
  const void* kern =
      checked_plan(kernel, S, T, F, N, K, groups, bf16, route, tile, members,
                   threads, var, stages, smem_bytes, xb16);
  if (kern == nullptr) return kUnsupported;
  return kernel_info(kern, threads, (size_t)smem_bytes, &out[0], &out[1],
                     &out[2]);
}

// x: the panel [T, F, N], f32, or bf16 where xb16 is 1 (panel.cuh).
// em_part [S, groups, K, N] (fully written; the wrapper sums axis 1). kT
// [S, K, F] in f32, rounded to bf16 here in bf16. The plan (route, stock
// tile, members per block, threads, var, stages, shared bytes) comes from
// ops/cond_em.py::cem_plan, checked on the card by cond_em_plan_info; one
// that disagrees with this file is refused. Returns 0, a cudaError_t value,
// or -1 for an unsupported shape or plan.
extern "C" int cond_em_fwd(const void* x, int xb16, const float* zpm,
                           const float* xr, const float* tinv,
                           const float* kT, float* em_part, int S, int T,
                           int F, int N, int K, int groups, int bf16,
                           int route, int tile, int members, int threads,
                           int var, int stages, long long smem_bytes,
                           void* stream) {
  const void* kern =
      checked_plan(kFwd, S, T, F, N, K, groups, bf16, route, tile, members,
                   threads, var, stages, smem_bytes, xb16);
  if (kern == nullptr) return kUnsupported;
  int tpg = (T + groups - 1) / groups;
  dim3 grid((unsigned)((N + tile - 1) / tile), (unsigned)groups,
            (unsigned)((S + members - 1) / members));
  void* args[] = {&x, &zpm, &xr, &tinv, &kT, &em_part, &S, &T, &F, &N, &K,
                  &tpg, &members, &tile, &stages};
  return (int)cudaLaunchKernel(kern, grid, dim3(threads), args,
                               (size_t)smem_bytes,
                               static_cast<cudaStream_t>(stream));
}

// dkT_part [S, groups * tiles, K, F] and dzpm_part [S, tiles, T, K] (fully
// written; the wrapper sums axis 1), dxr [S, T, N] (written directly), on
// 128-stock tiles. The plan (route 0 CUDA cores or 1 bf16 tensor cores,
// members per block, threads, var, stages, shared bytes) comes from
// cem_plan and is checked as the forward's is.
extern "C" int cond_em_bwd(const void* x, int xb16, const float* zpm,
                           const float* xr, const float* tinv,
                           const float* kT, const float* gem,
                           float* dkT_part, float* dzpm_part, float* dxr,
                           int S, int T, int F, int N, int K, int groups,
                           int bf16, int route, int members, int threads,
                           int var, int stages, long long smem_bytes,
                           void* stream) {
  const void* kern =
      checked_plan(kBwd, S, T, F, N, K, groups, bf16, route, kBwdTile,
                   members, threads, var, stages, smem_bytes, xb16);
  if (kern == nullptr) return kUnsupported;
  int tpg = (T + groups - 1) / groups;
  dim3 grid((unsigned)((S + members - 1) / members),
            (unsigned)((N + kBwdTile - 1) / kBwdTile), (unsigned)groups);
  // the kernels' arguments; route 1 adds its stages and warps per row group
  // (var), which route 0 does not take
  void* args[] = {&x,    &zpm, &xr, &tinv, &kT, &gem, &dkT_part, &dzpm_part,
                  &dxr,  &S,   &T,  &F,    &N,  &K,   &tpg,      &members,
                  &stages, &var};
  return (int)cudaLaunchKernel(kern, grid, dim3(threads), args,
                               (size_t)smem_bytes,
                               static_cast<cudaStream_t>(stream));
}


// What the card makes of a panel-cotangent plan (route, stock tile,
// threads, G, shared bytes) of the instance for an f32 (xb16 0) or bf16 (1)
// panel: out as cond_em_plan_info's. Returns 0, a cudaError_t value, or -1
// for a plan this file refuses.
extern "C" int cond_em_dx_plan_info(int S, int T, int F, int N, int K,
                                    int bf16, int route, int tile,
                                    int threads, int G, long long smem_bytes,
                                    int xb16, int* out) {
  int cells = 0;
  const void* kern = checked_dx_plan(S, T, F, N, K, bf16, route, tile,
                                     threads, G, smem_bytes, xb16, &cells);
  if (kern == nullptr) return kUnsupported;
  return kernel_info(kern, threads, (size_t)smem_bytes, &out[0], &out[1],
                     &out[2]);
}

// dx [T, F, N] (fully written; bf16 where the panel is, xb16 1, else
// f32). kT [S, K, F] is already rounded to the
// compute dtype. The plan (route 0 CUDA cores or 1 bf16 tensor cores, stock
// tile, threads, G persistent blocks, shared bytes) comes from
// ops/cond_em.py::cem_dx_plan, checked on the card by cond_em_dx_plan_info;
// one that disagrees with this file is refused. Returns 0, a cudaError_t
// value, or -1 for an unsupported shape or plan.
extern "C" int cond_em_dx(const void* x, int xb16, const float* zpm,
                          const float* xr, const float* tinv, const float* kT,
                          const float* gem, void* dx, int S, int T, int F,
                          int N, int K, int bf16, int route, int tile,
                          int threads, int G, long long smem_bytes,
                          void* stream) {
  int cells = 0;
  const void* kern = checked_dx_plan(S, T, F, N, K, bf16, route, tile,
                                     threads, G, smem_bytes, xb16, &cells);
  if (kern == nullptr) return kUnsupported;
  void* args[] = {&x, &zpm, &xr, &tinv, &kT, &gem, &dx, &S, &T, &F, &N, &K,
                  &tile, &cells};
  return (int)cudaLaunchKernel(kern, dim3(G), dim3(threads), args,
                               (size_t)smem_bytes,
                               static_cast<cudaStream_t>(stream));
}
