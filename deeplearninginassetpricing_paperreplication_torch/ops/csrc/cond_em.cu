// Fused moment net + conditional empirical means for Hopper (sm_90a),
// forward, backward and panel cotangent.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/pallas_moment.py
// _fwd_kernel (:64), _bwd_kernel (:86) and _dx_kernel (:134) and, through
// the explicit member axis S, _fwd_kernel_members (:274) and
// _bwd_kernel_members (:302). For
// member s, moment k and stock n:
//
//   em[s,k,n] = Σ_t tanh(kT_s[k,:] · x[t,:,n] + zp_m[s,t,k]) · xr[s,t,n]·tinv[n]
//
// over the feature-major panel x [T, F, N]; h [K, T, N] never exists in
// device memory. The backward, from gem = dL/dem [S, K, N], recomputes h and
// emits dkT [S, K, F], dzp_m [S, T, K] and dxr [S, T, N] (the chain back
// into the SDF factor, and through it into the generator).
//
// Rounding points are the JAX kernel's (pallas_ffn._dot): with bf16 the
// operands of kT·x and of dpre·xᵀ are rounded, everything else is f32.
//
// What bounds it on this card: bytes. At the training shape (K = 8,
// F = 46) a stock-period costs 2·K·F = 736 FLOP against 184 bytes of panel,
// about 4 FLOP per byte, far below the f32 ridge (~20): the 88 MB panel
// read decides the time. Design: one thread per (member, stock) walks a
// range of periods with the K pre-activations and accumulators in
// registers, reading the panel coalesced along the stock axis; kT sits in
// shared memory. The period axis is cut into groups so enough blocks fill
// the card; each group writes a partial, summed in a fixed order by the
// wrapper. In the backward, the cross-stock sums (dkT, dzp_m) run over a
// 128-stock tile in shared memory into block-private accumulators, one
// partial per block: no float atomics, so two calls give bitwise-equal
// gradients. Ragged stock lanes read x = 0, xr = 0, tinv = 0 and gem = 0,
// masked before any product (NaN·0 would otherwise leak in).
//
// The panel cotangent (cond_em_dx, below) is
//
//   dx[t, f, n] = Σ_s Σ_k round(kT_s[k, f]) · round(dpre_s[t, k, n]),
//   dpre = gem · xr · tinv · (1 − h²)
//
// summed over the members, who share the panel. It reads the panel once
// per member and writes [T, F, N] once: bytes first, about 4 FLOP per byte
// per member. One thread per (period, stock); every member's kT sits in
// shared memory (9 × 8 × 46 floats ≈ 13 KB at the ensemble's shape),
// transposed so that one float4 broadcast serves four moments, and each
// thread stages its panel column in shared memory once for all members and
// adds member s's K-term products into its own dx column there, members in
// ascending order: no atomics, bitwise-equal repeated calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kFwdThreads = 64;
constexpr int kBwdThreads = 128;  // = the backward's stock tile
constexpr int kUnsupported = -1;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kFwdThreads)
cond_em_fwd_kernel(const float* __restrict__ x, const float* __restrict__ zpm,
                   const float* __restrict__ xr,
                   const float* __restrict__ tinv,
                   const float* __restrict__ kT, float* __restrict__ em_part,
                   int T, int F, int N, int K, int tpg, int bf16) {
  extern __shared__ float kTs[];  // [K][F], already rounded
  const int s = blockIdx.z, tg = blockIdx.y;
  for (int i = threadIdx.x; i < K * F; i += blockDim.x)
    kTs[i] = kT[(size_t)s * K * F + i];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int t0 = tg * tpg, t1 = min(T, t0 + tpg);
  const float tv = tinv[n];
  float em[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) em[k] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const float* xt = x + (size_t)t * F * N + n;
    float pre[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) pre[k] = 0.f;
    for (int f = 0; f < F; ++f) {
      float xf = __ldg(xt + (size_t)f * N);
      if (bf16) xf = round_bf16(xf);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) pre[k] = fmaf(kTs[k * F + f], xf, pre[k]);
    }
    const float w = xr[((size_t)s * T + t) * N + n] * tv;
    const float* z = zpm + ((size_t)s * T + t) * K;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) em[k] = fmaf(tanhf(pre[k] + z[k]), w, em[k]);
  }
  float* out = em_part + (((size_t)s * gridDim.y + tg) * K) * N + n;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < K) out[(size_t)k * N] = em[k];
}

__global__ void __launch_bounds__(kBwdThreads)
cond_em_bwd_kernel(const float* __restrict__ x, const float* __restrict__ zpm,
                   const float* __restrict__ xr,
                   const float* __restrict__ tinv,
                   const float* __restrict__ kT,
                   const float* __restrict__ gem, float* __restrict__ dkT_part,
                   float* __restrict__ dzpm_part, float* __restrict__ dxr,
                   int T, int F, int N, int K, int tpg, int bf16) {
  extern __shared__ float sm[];
  const int sx = F | 1, sd = K | 1;  // odd row strides: no bank conflicts
  float* kTs = sm;                   // [K][F]
  float* xs = kTs + K * F;           // [tile][sx]
  float* dps = xs + kBwdThreads * sx;  // [tile][sd]
  float* acc = dps + kBwdThreads * sd;  // [K][F] block-private dkT
  const int s = blockIdx.z, tg = blockIdx.y, tile = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < K * F; i += blockDim.x) {
    kTs[i] = kT[(size_t)s * K * F + i];
    acc[i] = 0.f;
  }
  const int n = tile * kBwdThreads + tid;
  const bool valid = n < N;
  const float tv = valid ? tinv[n] : 0.f;
  float gm[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    gm[k] = (valid && k < K) ? gem[((size_t)s * K + k) * N + n] : 0.f;
  const int t0 = tg * tpg, t1 = min(T, t0 + tpg);
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    // -- per stock: recompute h, then dpre and dxr ---------------------------
    const float* xt = x + (size_t)t * F * N + n;
    float* xrow = xs + tid * sx;
    float pre[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) pre[k] = 0.f;
    for (int f = 0; f < F; ++f) {
      float xf = valid ? __ldg(xt + (size_t)f * N) : 0.f;
      xrow[f] = xf;
      if (bf16) xf = round_bf16(xf);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) pre[k] = fmaf(kTs[k * F + f], xf, pre[k]);
    }
    const float w = (valid ? xr[((size_t)s * T + t) * N + n] : 0.f) * tv;
    const float* z = zpm + ((size_t)s * T + t) * K;
    float colsum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const float h = tanhf(pre[k] + z[k]);
        dps[tid * sd + k] = gm[k] * w * (1.f - h * h);
        colsum = fmaf(gm[k], h, colsum);
      }
    }
    if (valid) dxr[((size_t)s * T + t) * N + n] = colsum * tv;
    __syncthreads();

    // -- block: dkT += Σ_n round(dpre) ⊗ round(x); dzp_m[t] = Σ_n dpre --------
    for (int e = tid; e < K * F; e += blockDim.x) {
      const int k = e / F, f = e % F;
      float v = 0.f;
      for (int j = 0; j < kBwdThreads; ++j) {
        float dp = dps[j * sd + k], xv = xs[j * sx + f];
        if (bf16) {
          dp = round_bf16(dp);
          xv = round_bf16(xv);
        }
        v = fmaf(dp, xv, v);
      }
      acc[e] += v;
    }
    for (int k = tid; k < K; k += blockDim.x) {
      float v = 0.f;
      for (int j = 0; j < kBwdThreads; ++j) v += dps[j * sd + k];
      dzpm_part[(((size_t)s * gridDim.x + tile) * T + t) * K + k] = v;
    }
    __syncthreads();
  }
  float* out = dkT_part +
      (((size_t)s * gridDim.y + tg) * gridDim.x + tile) * K * F;
  for (int i = tid; i < K * F; i += blockDim.x) out[i] = acc[i];
}

constexpr int kDxThreads = 128;

// the dx kernel's shared memory: every member's kT transposed and padded to
// kp = ⌈K/4⌉·4 moments ([S][F][kp], one float4 broadcast per 4 moments),
// then this block's panel tile and dx columns ([F][kDxThreads] each)
inline size_t dx_smem_floats(int S, int F, int K) {
  return (size_t)S * F * ((K + 3) / 4 * 4) + (size_t)2 * F * kDxThreads;
}

__global__ void __launch_bounds__(kDxThreads)
cond_em_dx_kernel(const float* __restrict__ x, const float* __restrict__ zpm,
                  const float* __restrict__ xr,
                  const float* __restrict__ tinv,
                  const float* __restrict__ kT, const float* __restrict__ gem,
                  float* __restrict__ dx, int S, int T, int F, int N, int K,
                  int bf16) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int kp = (K + 3) / 4 * 4;
  float* kTs = sm;  // [S][F][kp], already rounded; moments past K are 0
  const int t = blockIdx.y, tid = threadIdx.x;
  float* xs = sm + (size_t)S * F * kp + tid;  // this thread's panel column
  float* dxs = xs + (size_t)F * kDxThreads;   // this thread's dx column
  for (int i = tid; i < S * F * kp; i += blockDim.x) {
    const int s = i / (F * kp), f = (i / kp) % F, k = i % kp;
    kTs[i] = k < K ? kT[((size_t)s * K + k) * F + f] : 0.f;
  }
  const int n = blockIdx.x * kDxThreads + tid;
  const bool valid = n < N;
  const float* xt = x + (size_t)t * F * N + n;
  for (int f = 0; f < F; ++f) {
    const float xf = valid ? __ldg(xt + (size_t)f * N) : 0.f;
    xs[f * kDxThreads] = bf16 ? round_bf16(xf) : xf;
    dxs[f * kDxThreads] = 0.f;
  }
  __syncthreads();
  const float tv = valid ? tinv[n] : 0.f;
  for (int s = 0; s < S; ++s) {
    const float4* ks = reinterpret_cast<const float4*>(kTs + (size_t)s * F * kp);
    const int q = kp / 4;  // float4s per feature row
    // recompute h, then dpre = gem · xr · tinv · (1 − h²), rounded
    float pre[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) pre[k] = 0.f;
    for (int f = 0; f < F; ++f) {
      const float xf = xs[f * kDxThreads];
#pragma unroll
      for (int k = 0; k < kMaxK; k += 4) {
        if (k < kp) {
          const float4 w = ks[f * q + k / 4];
          pre[k] = fmaf(w.x, xf, pre[k]);
          pre[k + 1] = fmaf(w.y, xf, pre[k + 1]);
          pre[k + 2] = fmaf(w.z, xf, pre[k + 2]);
          pre[k + 3] = fmaf(w.w, xf, pre[k + 3]);
        }
      }
    }
    const float w = (valid ? xr[((size_t)s * T + t) * N + n] : 0.f) * tv;
    const float* z = zpm + ((size_t)s * T + t) * K;
    float dp[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      dp[k] = 0.f;
      if (k < K) {
        const float h = tanhf(pre[k] + z[k]);
        const float gm = valid ? gem[((size_t)s * K + k) * N + n] : 0.f;
        const float v = gm * w * (1.f - h * h);
        dp[k] = bf16 ? round_bf16(v) : v;
      }
    }
    // dx[f] += Σ_k kT[k, f] · dpre[k]  (padded moments add 0 · 0)
    for (int f = 0; f < F; ++f) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxK; k += 4) {
        if (k < kp) {
          const float4 w4 = ks[f * q + k / 4];
          v = fmaf(w4.x, dp[k], v);
          v = fmaf(w4.y, dp[k + 1], v);
          v = fmaf(w4.z, dp[k + 2], v);
          v = fmaf(w4.w, dp[k + 3], v);
        }
      }
      dxs[f * kDxThreads] += v;
    }
  }
  if (valid)
    for (int f = 0; f < F; ++f)
      dx[(size_t)t * F * N + (size_t)f * N + n] = dxs[f * kDxThreads];
}

int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  if (smem > 227 * 1024) return kUnsupported;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int S, int T, int F, int N, int K, int groups) {
  return S < 1 || T < 1 || F < 1 || N < 1 || K < 1 || K > kMaxK ||
         S > 65535 || groups < 1 || groups > 65535;
}

}  // namespace

// em_part [S, groups, K, N] (fully written; the wrapper sums axis 1).
// kT [S, K, F] is already rounded to the compute dtype. Returns 0, a
// cudaError_t value, or -1 for an unsupported shape.
extern "C" int cond_em_fwd(const float* x, const float* zpm, const float* xr,
                           const float* tinv, const float* kT,
                           float* em_part, int S, int T, int F, int N, int K,
                           int groups, int bf16, void* stream) {
  if (bad_shape(S, T, F, N, K, groups)) return kUnsupported;
  const int tpg = (T + groups - 1) / groups;
  const size_t smem = sizeof(float) * (size_t)K * F;
  int rc = set_smem((const void*)cond_em_fwd_kernel, smem);
  if (rc != 0) return rc;
  dim3 grid((unsigned)((N + kFwdThreads - 1) / kFwdThreads),
            (unsigned)groups, (unsigned)S);
  cond_em_fwd_kernel<<<grid, kFwdThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, zpm, xr, tinv, kT, em_part, T, F, N, K, tpg, bf16);
  return (int)cudaGetLastError();
}

// dkT_part [S, groups * tiles, K, F] and dzpm_part [S, tiles, T, K] (fully
// written; the wrapper sums axis 1), dxr [S, T, N] (written directly).
extern "C" int cond_em_bwd(const float* x, const float* zpm, const float* xr,
                           const float* tinv, const float* kT,
                           const float* gem, float* dkT_part,
                           float* dzpm_part, float* dxr, int S, int T, int F,
                           int N, int K, int groups, int bf16, void* stream) {
  if (bad_shape(S, T, F, N, K, groups)) return kUnsupported;
  const int tpg = (T + groups - 1) / groups;
  const size_t smem = sizeof(float) *
      ((size_t)2 * K * F + (size_t)kBwdThreads * ((F | 1) + (K | 1)));
  int rc = set_smem((const void*)cond_em_bwd_kernel, smem);
  if (rc != 0) return rc;
  dim3 grid((unsigned)((N + kBwdThreads - 1) / kBwdThreads),
            (unsigned)groups, (unsigned)S);
  cond_em_bwd_kernel<<<grid, kBwdThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, zpm, xr, tinv, kT, gem, dkT_part, dzpm_part, dxr, T, F, N, K, tpg,
      bf16);
  return (int)cudaGetLastError();
}

// dx [T, F, N] (fully written). kT [S, K, F] is already rounded to the
// compute dtype. One block per (128-stock tile, period). Returns 0, a
// cudaError_t value, or -1 for an unsupported shape (shared memory holds
// every member's kT and two [F] columns per thread).
extern "C" int cond_em_dx(const float* x, const float* zpm, const float* xr,
                          const float* tinv, const float* kT,
                          const float* gem, float* dx, int S, int T, int F,
                          int N, int K, int bf16, void* stream) {
  if (bad_shape(S, T, F, N, K, 1) || T > 65535) return kUnsupported;
  const size_t smem = sizeof(float) * dx_smem_floats(S, F, K);
  int rc = set_smem((const void*)cond_em_dx_kernel, smem);
  if (rc != 0) return rc;
  dim3 grid((unsigned)((N + kDxThreads - 1) / kDxThreads), (unsigned)T);
  cond_em_dx_kernel<<<grid, kDxThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, zpm, xr, tinv, kT, gem, dx, S, T, F, N, K, bf16);
  return (int)cudaGetLastError();
}
