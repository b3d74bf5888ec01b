// Matmul shape-ceiling microbench for Hopper (sm_90a): what the tensor
// cores sustain on the model's own narrow shapes.
//
// Replaces deeplearninginassetpricing_paperreplication_tpu/ops/microbench.py
// _ceiling_kernel (:35). It computes
//
//   part[z] = (steps of group z, k chunk of z) · repeats · Σ_s w[s] @ x
//
// for w [S, M, K] and x [K, BN] in bf16, accumulated in f32; the wrapper sums
// the partials (step groups × k chunks) in a fixed order, so the whole is
// G · repeats · Σ_s w[s] @ x, the TPU kernel's accumulator.
//
// What bounds it: operations, by design. Each block stages every member's w
// in shared memory once, and each warpgroup its x tile in registers once;
// then it issues nothing but tensor-core products: the device-memory traffic
// is a few MB against GFLOPs of work.
//
// The products are wgmma (warpgroup MMA, inline PTX), the only way to the
// H100's full tensor-core rate; the first kernel here ran warp-level
// mma.sync and reached 464 TFLOP/s at 128 × 128 (NVIDIA H100 80GB HBM3,
// 700 W, as every rate below). wgmma's tile is 64 rows
// by a width that is any multiple of 8, so the kernel computes the
// transposed tile, acc[64 stocks × M] += x_tileᵀ · w[s]ᵀ, with the stock
// axis as the 64-row side and M, rounded up to 8, as each member's width:
// no padding of M = 8 (mma.sync padded it to 16). K is padded with zeros to
// a multiple of 16 only (46 → 48: three k steps); the wrapper counts only
// the useful FLOPs of the true (M, K).
//
// * A (xᵀ, 64 stocks × 16 k per k step) comes from registers, in the
//   warp-level fragment layout (warp i of the warpgroup holds stocks 16·i..):
//   the tile is reused by every member, repeat and step, and reading it from
//   shared memory would cost more than the product on the narrow widths.
// * B (w[s]ᵀ) is K-major as w is stored: 8-row × 16-byte core matrices,
//   without swizzle (each core matrix is 128 contiguous bytes, read without
//   bank conflicts), the two k halves of a k step 128 bytes apart (the
//   descriptor's leading byte offset) and the 8-row groups 256 bytes apart
//   (its stride byte offset), a k step's members adjacent. Nine members'
//   128 × 128 tiles (288 KB) exceed a block's shared memory, so K is cut
//   into chunks whose members' tiles fit (two chunks of 64 there), each
//   block holding one chunk and writing its own partial.
// * Products into one accumulator run one after another, and a short one
//   leaves the tensor cores idle for the pipeline's latency: with one
//   m64n8k16 (4 clocks of the SM's tensor cores) per member, 8 × 224 ran at
//   87 TFLOP/s. So one wgmma covers P members side by side (N = P·W: P = 9
//   at width 8, m64n72k16; P = 3 at width 64, m64n192k16), as the port's
//   bf16 kernels stack the members' weights, and the P column blocks are
//   summed in a fixed order once, at the end. The sum over the S members is
//   the same; each member's product is still its own (M, K) tile.
// * Each repeat issues its S/P × k-step wgmmas back to back under one
//   wgmma.fence and one commit group, and waits only for the group before
//   it: one group runs while the next is issued. A block runs 1 to 4
//   warpgroups, each on its own 64 stocks, sharing the block's B. A chunk's
//   k-step count is a template argument (1, 2, 3, 4, 7, 14 or 16), so the
//   products run unguarded.
//
// The launch plan (warpgroups, width, members a product, k chunks and
// steps, shared bytes, resident blocks, step groups) is Python arithmetic in
// ops/microbench.py::ceiling_plan; this file checks it and refuses a plan
// that disagrees, and matmul_ceiling_plan_info asks the card for the
// resident blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // stocks a warpgroup owns: wgmma's M
constexpr int kMaxWarpgroups = 4;
constexpr int kUnsupported = -1;
constexpr size_t kMaxSmem = 227 * 1024;

// the widths of a member's rows built (M rounded up to 8)
__host__ __device__ inline bool built_width(int w) {
  return w == 8 || w == 16 || w == 32 || w == 64 || w == 128;
}

// B's shared bytes: S members × width rows × the chunk's k steps × 32 bytes
inline size_t smem_bytes(int S, int width, int ksteps) {
  return (size_t)S * width * ksteps * 32;
}

// A shared-memory matrix descriptor: K-major, no swizzle, core matrices
// 8 rows × 16 bytes; the k halves `lbo` bytes apart, the 8-row groups `sbo`
__device__ __forceinline__ uint64_t desc_of(uint32_t addr) {
  constexpr uint64_t lbo = 128, sbo = 256;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) |
         ((sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async
// products
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc[64 × N] += A (registers) · B (descriptor), f32 from bf16
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<24>(float (&d)[12], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<72>(float (&d)[36], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<144>(float (&d)[72], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "{%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "
      "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// warpgroups a block of an instance may run: four (≤ 128 registers a
// thread) where its accumulators and A fragments take at most 80 registers,
// else two (≤ 255)
__host__ __device__ constexpr int max_warpgroups(int n, int ks) {
  return n / 2 + 4 * ks <= 80 ? kMaxWarpgroups : 2;
}

// Block (stock block, M slice × k chunk, step group) of `warpgroups` ×
// 128 threads; warpgroup g owns stocks n0 + 64·g ... One wgmma covers P
// members' W rows (N = P·W): its B is P adjacent members' rows of one k
// step. Shared memory: the slice's W rows of every member's w over the
// chunk's KS k steps, as core matrices [KS][S][W/8][2 k halves][8 rows][8 k]
// bf16 (a k step's members adjacent).
template <int W, int P, int KS>
__global__ void __launch_bounds__(128 * max_warpgroups(P * W, KS), 1)
matmul_ceiling_kernel(const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ x,
                      float* __restrict__ part, int S, int M, int K, int BN,
                      int repeats, int G, int steps_per_group, int kchunks) {
  constexpr int N = P * W, ND = N / 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int slices = (M + W - 1) / W;
  const int m0 = blockIdx.y % slices * W, kc = blockIdx.y / slices;
  const int k0 = kc * KS * 16;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = (blockIdx.x * (blockDim.x >> 7) + wg) * kRows;
  const uint16_t* wb = reinterpret_cast<const uint16_t*>(w);
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);

  // stage B: element (s, row r, chunk k) of w[s][m0 + r][k0 + k], zero past
  // M and K, k fastest (coalesced along w's rows)
  uint16_t* bs = reinterpret_cast<uint16_t*>(smem);
  constexpr int kw = KS * 16;
  for (int i = threadIdx.x; i < S * W * kw; i += blockDim.x) {
    const int k = i % kw, r = i / kw % W, s = i / (kw * W);
    const int m = m0 + r, kg = k0 + k;
    const uint16_t v =
        m < M && kg < K ? wb[((size_t)s * M + m) * K + kg] : (uint16_t)0;
    const int kk = k >> 4, h = (k >> 3) & 1;
    bs[(((kk * S + s) * (W / 8) + (r >> 3)) * 2 + h) * 64 + (r & 7) * 8 +
       (k & 7)] = v;
  }
  // A: this thread's fragments of xᵀ (stocks n0 + 16·warp + gid (+ 8), k
  // 16·kk + 2·tig (+ 1, + 8, + 9)), zero past BN and K
  uint32_t a[KS][4];
  const int na = n0 + 16 * warp + gid;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = na + (q & 1) * 8, k = k0 + 16 * kk + 2 * tig + (q >> 1) * 8;
      const uint32_t lo = n < BN && k < K ? xb[(size_t)k * BN + n] : 0u;
      const uint32_t hi = n < BN && k + 1 < K ? xb[(size_t)(k + 1) * BN + n]
                                              : 0u;
      a[kk][q] = lo | (hi << 16);
    }
  }
  // the generic-proxy stores of B, seen by the async proxy of wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float d[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) d[i] = 0.f;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t per_member = (W / 8) * 256;  // bytes of a member's k step
  const uint32_t per_kstep = S * per_member;
  const int g0 = blockIdx.z * steps_per_group;
  const int g1 = min(G, g0 + steps_per_group);
  fence_operand(d);
  for (int step = g0; step < g1; ++step) {
    for (int r = 0; r < repeats; ++r) {
      wgmma_fence();
      for (int s = 0; s < S; s += P) {
        const uint32_t sb = base + (uint32_t)s * per_member;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma<N>(d, a[kk], desc_of(sb + kk * per_kstep));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the group before this one is done
    }
  }
  wgmma_wait<0>();
  fence_operand(d);

  // d[4j + e]: stock 16·warp + gid (+ 8 for e ≥ 2), column 8j + 2·tig (+ 1
  // for odd e) of member j / (W/8); the P members summed in a fixed order
  float* out = part + (size_t)(blockIdx.z * kchunks + kc) * M * BN;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = d[4 * j + e];
#pragma unroll
      for (int p = 1; p < P; ++p) v += d[4 * (p * W / 8 + j) + e];
      const int m = m0 + 8 * j + 2 * tig + (e & 1), n = na + (e >> 1) * 8;
      if (m < M && n < BN) out[(size_t)m * BN + n] = v;
    }
  }
}

// the k-step counts a chunk is built for (ops/microbench.py CEILING_KSTEPS)
template <int W, int P>
const void* instance_of(int ks) {
  switch (ks) {
    case 1: return (const void*)matmul_ceiling_kernel<W, P, 1>;
    case 2: return (const void*)matmul_ceiling_kernel<W, P, 2>;
    case 3: return (const void*)matmul_ceiling_kernel<W, P, 3>;
    case 4: return (const void*)matmul_ceiling_kernel<W, P, 4>;
    case 7: return (const void*)matmul_ceiling_kernel<W, P, 7>;
    case 14: return (const void*)matmul_ceiling_kernel<W, P, 14>;
    case 16: return (const void*)matmul_ceiling_kernel<W, P, 16>;
    default: return nullptr;
  }
}

// the kernel instance of (width, members a product, k steps a chunk): the
// stacks of ops/microbench.py CEILING_STACKS within CEILING_MAX_N
const void* kernel_of(int width, int stack, int ksteps) {
#define CEIL_INST(wd, p) \
  if (width == wd && stack == p) return instance_of<wd, p>(ksteps);
  CEIL_INST(8, 1) CEIL_INST(8, 3) CEIL_INST(8, 9)
  CEIL_INST(16, 1) CEIL_INST(16, 3) CEIL_INST(16, 9)
  CEIL_INST(32, 1) CEIL_INST(32, 3)
  CEIL_INST(64, 1) CEIL_INST(64, 3)
  CEIL_INST(128, 1)
#undef CEIL_INST
  return nullptr;
}

// the kernel of a plan, after checking it against this file: a built
// instance, members a product dividing S, k chunks of `ksteps` steps that
// cover K with none empty, and the shared bytes the geometry gives
const void* checked_plan(int S, int M, int K, int BN, int warpgroups,
                         int width, int stack, int kchunks, int ksteps,
                         long long bytes) {
  if (S < 1 || M < 1 || K < 1 || BN < 1 || S > 65535) return nullptr;
  if (!built_width(width) || stack < 1 || S % stack || warpgroups < 1 ||
      warpgroups > max_warpgroups(stack * width, ksteps))
    return nullptr;
  if (kchunks < 1 || ksteps < 1 || (long long)kchunks * ksteps * 16 < K ||
      (long long)(kchunks - 1) * ksteps * 16 >= K)
    return nullptr;
  if (bytes != (long long)smem_bytes(S, width, ksteps) ||
      (size_t)bytes > kMaxSmem)
    return nullptr;
  return kernel_of(width, stack, ksteps);
}

}  // namespace

// Registers per thread of the instance of (width, members a product, k steps
// a chunk), or -1.
extern "C" int matmul_ceiling_registers(int width, int stack, int ksteps) {
  const void* kern = kernel_of(width, stack, ksteps);
  cudaFuncAttributes attr;
  if (kern == nullptr || cudaFuncGetAttributes(&attr, kern) != cudaSuccess)
    return kUnsupported;
  return attr.numRegs;
}

// What the card makes of a plan: out = [resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
// local-memory bytes per thread]. It lets the kernel take the plan's shared
// memory. Returns 0, a cudaError_t value, or -1 for a plan this file
// refuses.
extern "C" int matmul_ceiling_plan_info(int S, int M, int K, int BN,
                                        int warpgroups, int width, int stack,
                                        int kchunks, int ksteps,
                                        long long bytes, int* out) {
  const void* kern = checked_plan(S, M, K, BN, warpgroups, width, stack,
                                  kchunks, ksteps, bytes);
  if (kern == nullptr) return kUnsupported;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kern, 128 * warpgroups, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return 0;
}

// part [groups · kchunks, M, BN] (fully written; the wrapper sums axis 0):
// the G grid steps are cut into `groups` groups of ⌈G / groups⌉ steps, K
// into `kchunks` chunks of `ksteps` k steps. w [S, M, K] and x [K, BN] are
// bf16. The plan (warpgroups, width, members a product, kchunks, ksteps,
// shared bytes) comes
// from ops/microbench.py::ceiling_plan, checked on the card by
// matmul_ceiling_plan_info. Returns 0, a cudaError_t value, or -1 for an
// unsupported shape or plan.
extern "C" int matmul_ceiling(const void* w, const void* x, float* part,
                              int S, int M, int K, int BN, int repeats, int G,
                              int groups, int warpgroups, int width,
                              int stack, int kchunks, int ksteps,
                              long long bytes, void* stream) {
  const void* kern = checked_plan(S, M, K, BN, warpgroups, width, stack,
                                  kchunks, ksteps, bytes);
  if (kern == nullptr || repeats < 1 || G < 1 || groups < 1 || groups > G ||
      groups > 65535)
    return kUnsupported;
  const int stocks = kRows * warpgroups;
  const dim3 grid((unsigned)((BN + stocks - 1) / stocks),
                  (unsigned)(((M + width - 1) / width) * kchunks),
                  (unsigned)groups);
  int per = (G + groups - 1) / groups;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  void* args[] = {(void*)&wb, (void*)&xb,  (void*)&part,    (void*)&S,
                  (void*)&M,  (void*)&K,   (void*)&BN,      (void*)&repeats,
                  (void*)&G,  (void*)&per, (void*)&kchunks};
  return (int)cudaLaunchKernel(kern, grid, dim3(128 * warpgroups), args,
                               (size_t)bytes,
                               static_cast<cudaStream_t>(stream));
}
