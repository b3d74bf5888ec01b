// Fused SDF-FFN forward for Hopper (sm_90a): the panel MLP of every ensemble
// member in one launch.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/pallas_ffn.py
// _fwd_kernel (:188, one member) and _fwd_kernel_members (:561, S members
// over one panel read). It computes, for member s, period t and stock n,
//
//   w[s,t,n] = kout_s . relu(W_L,s ... relu(K1_s^T x[t,:,n] + zp[s,t]) ... + b) + bout_s
//
// over the feature-major panel x [T, F, N] (f32). The output is the raw
// weight [S, T, N] in f32, before masking.
//
// What bounds it on this card: at the served shape (3 members, F = 46,
// hidden [64, 64]) each (member, period, stock) row costs
// 2*(F*H1 + H1*H2 + H2) = 14.2 kFLOP against 184 bytes of panel read once
// for all members, about 230 FLOP per byte. The products run as f32 FMAs
// on the CUDA cores (67 TFLOP/s), so the kernel is bound by operations, not
// by the 3.35 TB/s of device memory.
//
// Design (simple first; wgmma and TMA come later): one thread per
// (member, period, stock). A block owns one (member, period) pair and a
// strided set of stocks; it stages that member's packed weights and the
// period's first-layer bias zp in shared memory once, then every thread
// keeps its hidden activations in registers (fully unrolled loops over a
// compile-time width bound, so the arrays never spill to local memory at
// the paper's widths). Weights are read from shared memory as float4
// broadcasts, four FMAs per load, and the panel is read coalesced along the
// stock axis. The hidden activations never touch device memory.
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

#include "sdf_ffn_common.cuh"

// One library per width bound: the build passes -DSDF_FFN_MAXW=32|64|128
// (the widest padded hidden layer it serves), so each is compiled alone and
// only the one a model needs is built at first use.
#ifndef SDF_FFN_MAXW
#define SDF_FFN_MAXW 64
#endif

namespace {

using sdf_ffn::Dropout;
using sdf_ffn::FfnDims;
using sdf_ffn::kUnsupported;
using sdf_ffn::round_bf16;

constexpr int kThreads = 128;

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
sdf_ffn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ zp,
                   const float* __restrict__ params, float* __restrict__ out,
                   int T, int N, FfnDims d, int bf16, Dropout drop) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.z;
  const int t = blockIdx.y;

  // stage member s's packed weights, then the (s, t) first-layer bias
  const float4* src = reinterpret_cast<const float4*>(params + (size_t)s * d.P);
  for (int i = threadIdx.x; i < d.P / 4; i += blockDim.x) smem4[i] = src[i];
  float* zps = sm + d.P;
  const int h0 = d.h[0], hp0 = d.hp[0];
  const float* zrow = zp + ((size_t)s * T + t) * h0;
  for (int j = threadIdx.x; j < hp0; j += blockDim.x) zps[j] = j < h0 ? zrow[j] : 0.f;
  __syncthreads();

  const int F = d.F;
  const float* xt = x + (size_t)t * F * N;
  float* orow = out + ((size_t)s * T + t) * N;
  const uint32_t base = drop.on ? drop.member_base[s] : 0u;

  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += gridDim.x * blockDim.x) {
    const uint32_t row = drop.on ? sdf_ffn::row_hash(base, t, n) : 0u;
    // -- first layer: relu(K1^T x + zp), feature by feature ----------------
    float cur[MAXW];
#pragma unroll
    for (int j = 0; j < MAXW; ++j) cur[j] = 0.f;
    for (int f = 0; f < F; ++f) {
      float xf = __ldg(xt + (size_t)f * N + n);
      if (bf16) xf = round_bf16(xf);
      const float4* wrow = reinterpret_cast<const float4*>(sm + f * hp0);
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
    for (int j = 0; j < MAXW; ++j) {
      if (j < hp0) {
        float a = fmaxf(cur[j] + zps[j], 0.f);
        if (drop.on)
          a = sdf_ffn::keep_unit(row, 0, j, drop.threshold) ? a * drop.scale
                                                             : 0.f;
        cur[j] = bf16 ? round_bf16(a) : a;
      }
    }

    // -- later hidden layers: relu(W cur + b) ------------------------------
    for (int l = 1; l < d.n_hidden; ++l) {
      const int hin = d.hp[l - 1], hout = d.h[l];
      const float* W = sm + d.off_w[l];
      const float* b = sm + d.off_b[l];
      float nxt[MAXW];
#pragma unroll
      for (int k = 0; k < MAXW; ++k) {
        float acc = 0.f;
        if (k < hout) {
          const float4* wrow = reinterpret_cast<const float4*>(W + k * hin);
#pragma unroll
          for (int j = 0; j < MAXW; j += 4) {
            if (j < hin) {
              const float4 w = wrow[j / 4];
              acc = fmaf(w.x, cur[j], acc);
              acc = fmaf(w.y, cur[j + 1], acc);
              acc = fmaf(w.z, cur[j + 2], acc);
              acc = fmaf(w.w, cur[j + 3], acc);
            }
          }
          acc = fmaxf(acc + b[k], 0.f);
          if (drop.on)
            acc = sdf_ffn::keep_unit(row, l, k, drop.threshold)
                      ? acc * drop.scale : 0.f;
          if (bf16) acc = round_bf16(acc);
        }
        nxt[k] = acc;  // padded lanes stay exactly 0
      }
#pragma unroll
      for (int k = 0; k < MAXW; ++k) cur[k] = nxt[k];
    }

    // -- output projection --------------------------------------------------
    const float4* ko = reinterpret_cast<const float4*>(sm + d.off_kout);
    const int hpl = d.hp[d.n_hidden - 1];
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < MAXW; j += 4) {
      if (j < hpl) {
        const float4 w = ko[j / 4];
        o = fmaf(w.x, cur[j], o);
        o = fmaf(w.y, cur[j + 1], o);
        o = fmaf(w.z, cur[j + 2], o);
        o = fmaf(w.w, cur[j + 3], o);
      }
    }
    orow[n] = o + sm[d.off_bout];
  }
}

template <int MAXW>
int launch(const float* x, const float* zp, const float* params, float* out,
           int S, int T, int N, const FfnDims& d, int bf16,
           const Dropout& drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(d.P + d.hp[0]);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sdf_ffn_fwd_kernel<MAXW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks for ~8 per SM across all (member, period) pairs; each
  // thread then strides over the remaining stocks of its pair
  const int stock_blocks = (N + kThreads - 1) / kThreads;
  const long long pairs = (long long)S * T;
  long long gx = (8LL * sms + pairs - 1) / pairs;
  if (gx > stock_blocks) gx = stock_blocks;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)T, (unsigned)S);
  sdf_ffn_fwd_kernel<MAXW><<<grid, kThreads, smem, stream>>>(
      x, zp, params, out, T, N, d, bf16, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// layout: see sdf_ffn::read_dims. dropout: rate > 0 iff `dropout` is 1;
// then member s hashes from member_base[s] (a device array of S uint32),
// keeps a unit iff its hash >= `threshold`, and scales kept values by
// `scale`.
// Returns 0 on success, a cudaError_t value, or -1 for an unsupported shape.
extern "C" int sdf_ffn_fwd(const float* x, const float* zp,
                           const float* params, float* out, int S, int T,
                           int N, const int* layout, int bf16, int dropout,
                           const unsigned int* member_base,
                           unsigned int threshold, float scale,
                           void* stream) {
  FfnDims d;
  int maxw = 0;
  if (sdf_ffn::read_dims(layout, &d, &maxw) != 0) return kUnsupported;
  if (S < 1 || T < 1 || N < 1 || T > 65535 || S > 65535) return kUnsupported;
  if ((size_t)sizeof(float) * (d.P + d.hp[0]) > 227 * 1024) return kUnsupported;
  if (maxw > SDF_FFN_MAXW) return kUnsupported;
  const Dropout drop{dropout, member_base, threshold, scale};
  return launch<SDF_FFN_MAXW>(x, zp, params, out, S, T, N, d, bf16, drop,
                              static_cast<cudaStream_t>(stream));
}
