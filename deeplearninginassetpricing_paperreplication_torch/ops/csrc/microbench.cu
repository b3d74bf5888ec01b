// Matmul shape-ceiling microbench for Hopper (sm_90a): what the tensor
// cores sustain on the model's own narrow shapes.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/microbench.py
// _ceiling_kernel (:35). It computes
//
//   part[z] = (steps of group z) · repeats · Σ_s w[s] @ x
//
// for w [S, M, K] and x [K, BN] in bf16, accumulated in f32; the wrapper sums
// the step groups' partials in a fixed order, so the whole is
// G · repeats · Σ_s w[s] @ x, the TPU kernel's accumulator.
//
// What bounds it: operations, by design. Each block stages its rows of every
// member's w and its x tile in shared memory once, then issues nothing but
// shared-memory fragment loads and tensor-core products: the device-memory
// traffic is a few MB against GFLOPs of work. The products are warp-level
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (inline PTX), since
// the TPU kernel measures the matrix unit and a scalar-FMA loop would
// measure the wrong unit; wgmma and TMA are later work. K is padded with
// zeros to a multiple of 16 (46 → 48) and M to a multiple of 16 (8 → 16):
// the padded products are the price of the narrow shape, and the wrapper
// counts only the useful FLOPs of the true (M, K).
//
// Design: 8 warps per block, WM along M × WN along BN. A block owns up to 64
// rows of M (one row slice) and WN · NT · 8 columns of BN; each warp owns
// MT · 16 rows and NT · 8 columns, an MT × NT grid of 16 × 8 accumulator
// tiles in registers. The loop over 16-deep k steps is outside the member
// loop, so one B fragment (x, shared by all members) serves all S members'
// A fragments, and each A fragment serves NT products: at NT = 8 a product
// reads 64 bytes of shared memory, half the SM's 128 bytes per clock. Of
// the tilings a slice height allows, the host takes the one that keeps the
// most warps resident per SM (more NT on a tie).
// The G grid steps of the TPU kernel are spread over step groups (the grid's
// z axis) so the blocks fill every SM; each group writes its own partial.
// Shared rows are padded to ≡ 4 words (mod 8), so the 8 rows × 4 words of
// a fragment load hit 32 distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSliceRows = 64;  // rows of M one block holds
constexpr int kUnsupported = -1;
constexpr size_t kMaxSmem = 227 * 1024;

// the 32-bit-word stride of a shared row of kp bf16 values (kp a multiple
// of 16): kp/2 + 4 ≡ 4 (mod 8)
__host__ __device__ inline int row_words(int kp) { return kp / 2 + 4; }

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MT, int NT, int WM>
__global__ void __launch_bounds__(kThreads)
matmul_ceiling_kernel(const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ x,
                      float* __restrict__ part, int S, int M, int K, int BN,
                      int repeats, int G, int steps_per_group) {
  constexpr int WN = kWarps / WM;
  constexpr int kRows = WM * MT * 16, kCols = WN * NT * 8;
  extern __shared__ uint32_t smem[];
  const int kp = pad16(K), rw = row_words(kp);
  uint32_t* ws = smem;                             // [S][kRows][rw]
  uint32_t* xs = smem + (size_t)S * kRows * rw;    // [kCols][rw]: xᵀ
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // stage the slice's rows of every member's w and the x tile (transposed,
  // k contiguous), zero-padded
  __nv_bfloat16* wsb = reinterpret_cast<__nv_bfloat16*>(ws);
  for (int i = threadIdx.x; i < S * kRows * kp; i += kThreads) {
    const int s = i / (kRows * kp), r = (i / kp) % kRows, k = i % kp;
    const int m = m0 + r;
    wsb[((size_t)s * kRows + r) * 2 * rw + k] =
        (m < M && k < K) ? w[((size_t)s * M + m) * K + k] : zero;
  }
  __nv_bfloat16* xsb = reinterpret_cast<__nv_bfloat16*>(xs);
  for (int i = threadIdx.x; i < kp * kCols; i += kThreads) {
    const int k = i / kCols, c = i % kCols;  // coalesced along BN
    const int n = n0 + c;
    xsb[(size_t)c * 2 * rw + k] =
        (k < K && n < BN) ? x[(size_t)k * BN + n] : zero;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int gid = lane >> 2, tig = lane & 3;
  // A fragment base: row (warp rows + gid) of member 0, k pair tig; B:
  // column gid of the warp's first 8-column tile, k pair tig
  const uint32_t* wa = ws + (size_t)(wm * MT * 16 + gid) * rw + tig;
  const uint32_t* xb = xs + (size_t)(wn * NT * 8 + gid) * rw + tig;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int g0 = blockIdx.z * steps_per_group;
  const int g1 = min(G, g0 + steps_per_group);
  const int ksteps = kp / 16;
  for (int step = g0; step < g1; ++step) {
    for (int r = 0; r < repeats; ++r) {
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t* p = xb + (size_t)j * 8 * rw + kk * 8;
          b[j][0] = p[0];  // k 2·tig, 2·tig + 1
          b[j][1] = p[4];  // k 2·tig + 8, + 9
        }
        for (int s = 0; s < S; ++s) {
          const uint32_t* pa = wa + (size_t)s * kRows * rw + kk * 8;
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint32_t* p = pa + (size_t)i * 16 * rw;
            a[i][0] = p[0];           // row gid,     k 2·tig
            a[i][1] = p[8 * rw];      // row gid + 8, k 2·tig
            a[i][2] = p[4];           // row gid,     k 2·tig + 8
            a[i][3] = p[8 * rw + 4];  // row gid + 8, k 2·tig + 8
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
        }
      }
    }
  }

  // c0, c1: row gid, columns 2·tig, 2·tig + 1; c2, c3: row gid + 8
  float* out = part + (size_t)blockIdx.z * M * BN;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + (wn * NT + j) * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + i) * 16 + gid + 8 * h;
        if (row >= M) continue;
        if (col < BN) out[(size_t)row * BN + col] = acc[i][j][2 * h];
        if (col + 1 < BN) out[(size_t)row * BN + col + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// one instantiated tiling: MT 16-row tiles and NT 8-column tiles per warp,
// WM warps along M
struct Tiling {
  int mt, nt, wm;
  const void* fn;
  int rows() const { return mt * 16 * wm; }
  int cols() const { return (kWarps / wm) * nt * 8; }
};

template <int MT, int NT, int WM>
Tiling make_tiling() {
  return {MT, NT, WM, (const void*)matmul_ceiling_kernel<MT, NT, WM>};
}

// the tilings of each slice height (16, 32, 48, 64 padded rows)
int candidates(int M, Tiling* out) {
  const int rows = pad16(M) < kSliceRows ? pad16(M) : kSliceRows;
  switch (rows / 16) {
    case 1: out[0] = make_tiling<1, 4, 1>(); return 1;
    case 2: out[0] = make_tiling<1, 8, 2>(); out[1] = make_tiling<1, 4, 2>();
            return 2;
    case 3: out[0] = make_tiling<3, 2, 1>(); return 1;
    default: out[0] = make_tiling<2, 8, 2>(); out[1] = make_tiling<2, 4, 2>();
             return 2;
  }
}

inline size_t smem_bytes(int S, int K, const Tiling& tl) {
  const int rw = row_words(pad16(K));
  return sizeof(uint32_t) *
         ((size_t)S * tl.rows() * rw + (size_t)tl.cols() * rw);
}

bool bad_shape(int S, int M, int K, int BN) {
  return S < 1 || M < 1 || K < 1 || BN < 1 || S > 65535;
}

// the tiling with the most resident blocks per SM (ties: the larger NT,
// listed first), with its smem size and blocks per SM; -1 if none fits
int choose(int S, int M, int K, Tiling* tl, size_t* smem, int* per_sm) {
  Tiling cand[2];
  const int n = candidates(M, cand);
  int best = -1;
  for (int c = 0; c < n; ++c) {
    const size_t bytes = smem_bytes(S, K, cand[c]);
    if (bytes > kMaxSmem) continue;
    cudaError_t err = cudaFuncSetAttribute(
        cand[c].fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cand[c].fn,
                                                        kThreads, bytes);
    if (err != cudaSuccess) return (int)err;
    if (blocks > best) {
      best = blocks;
      *tl = cand[c];
      *smem = bytes;
    }
  }
  if (best <= 0) return kUnsupported;
  *per_sm = best;
  return 0;
}

}  // namespace

// The launch shape the wrapper plans with: blocks per step group (column
// tiles × row slices) and how many of them one SM holds at once (from the
// CUDA occupancy calculator). Returns 0, a cudaError_t value, or -1.
extern "C" int matmul_ceiling_occupancy(int S, int M, int K, int BN,
                                        int* blocks, int* per_sm) {
  if (bad_shape(S, M, K, BN)) return kUnsupported;
  Tiling tl{};
  size_t smem = 0;
  const int rc = choose(S, M, K, &tl, &smem, per_sm);
  if (rc != 0) return rc;
  *blocks = ((BN + tl.cols() - 1) / tl.cols()) *
            ((M + tl.rows() - 1) / tl.rows());
  return 0;
}

// part [groups, M, BN] (fully written; the wrapper sums axis 0): the G grid
// steps are cut into `groups` groups of ⌈G / groups⌉ steps. w [S, M, K] and
// x [K, BN] are bf16. Returns 0, a cudaError_t value, or -1 for an
// unsupported shape.
extern "C" int matmul_ceiling(const void* w, const void* x, float* part,
                              int S, int M, int K, int BN, int repeats, int G,
                              int groups, void* stream) {
  if (bad_shape(S, M, K, BN) || repeats < 1 || G < 1 || groups < 1 ||
      groups > G || groups > 65535)
    return kUnsupported;
  Tiling tl{};
  size_t smem = 0;
  int per_sm = 0;
  const int rc = choose(S, M, K, &tl, &smem, &per_sm);
  if (rc != 0) return rc;
  const dim3 grid((unsigned)((BN + tl.cols() - 1) / tl.cols()),
                  (unsigned)((M + tl.rows() - 1) / tl.rows()),
                  (unsigned)groups);
  const int per = (G + groups - 1) / groups;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  void* args[] = {(void*)&wb, (void*)&xb, (void*)&part, (void*)&S,
                  (void*)&M,  (void*)&K,  (void*)&BN,   (void*)&repeats,
                  (void*)&G,  (void*)&per};
  return (int)cudaLaunchKernel(tl.fn, grid, dim3(kThreads), args, smem,
                               static_cast<cudaStream_t>(stream));
}
