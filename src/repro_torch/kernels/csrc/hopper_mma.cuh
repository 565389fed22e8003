// Hopper (sm_90a) building blocks of the port's bf16 tensor-core kernels:
// PTX wrappers for shared-memory addresses, mbarriers, TMA tensor loads,
// cp.async, warpgroup MMA (wgmma) with its shared-memory descriptors, and
// warp MMA (mma.sync m16n8k16 with ldmatrix, and its operands from tiles
// in shared memory).  Header-only; a kernel source includes it, and
// `_build` hashes it into every library's name.
//
// Fragment layouts used by the kernels (g = lane / 4, t = lane % 4):
//   * an m16n8 fp32 accumulator (mma.sync, and each 8-column block of a
//     wgmma m64nN accumulator for the warp's 16 rows) holds rows g and
//     g + 8, columns 2t and 2t + 1: d[0], d[1] on row g, d[2], d[3] on g + 8;
//   * a 16x16 bf16 A operand holds a0 = (g, 2t..), a1 = (g + 8, 2t..),
//     a2 = (g, 8 + 2t..), a3 = (g + 8, 8 + 2t..), two values a register,
//     the lower column in the low half -- so two neighbouring 8-column
//     accumulator blocks, packed to bf16, are the A operand of the next
//     product with no data movement.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mbarriers (one 8-byte word of shared memory each)

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a 4-D box of a tensor map into shared memory and
// the transfer completes on `bar`.  Boxes reaching past the tensor's extent
// are zero-filled.

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
        : "memory");
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes, zero-filled when !valid (src is then not read)

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes (through L1), zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and ldmatrix

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j receives matrix j in the accumulator layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// As ldsm_x4, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// ---------------------------------------------------------------------------
// mma.sync operands from bf16 tiles in shared memory.  A tile is addressed
// by its base, its row pitch in elements (a multiple of 8, so that every
// row starts on 16 bytes; 8 elements more than the row's width keeps the
// eight rows of an 8x8 matrix in distinct banks), and the first row and
// column of the fragment.  lane = threadIdx.x % 32.

// A (16 x 16) at rows m0.., columns k0.. of a tile stored [m][k].
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int pitch,
                                       int m0, int k0) {
    const int lane = threadIdx.x & 31;
    const int m = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int k = k0 + (lane >> 4) * 8;
    ldsm_x4(a, smem_u32(tile + m * pitch + k));
}

// A (16 x 16), rows m0.., k0.., from a tile stored transposed, [k][m].
__device__ __forceinline__ void ldsm_a_t(uint32_t (&a)[4],
                                         const __nv_bfloat16* tile,
                                         int pitch, int m0, int k0) {
    const int lane = threadIdx.x & 31, j = lane >> 3;
    const int k = k0 + (lane & 7) + (j >> 1) * 8;
    const int m = m0 + (j & 1) * 8;
    ldsm_x4_t(a, smem_u32(tile + k * pitch + m));
}

// The B operands (b0, b1) of two n8 tiles -- columns n0.. in r[0], r[1]
// and n0 + 8.. in r[2], r[3] -- for the k16 step at k0, from a tile stored
// [n][k] (each column's k values contiguous).
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4],
                                       const __nv_bfloat16* tile, int pitch,
                                       int n0, int k0) {
    const int lane = threadIdx.x & 31, j = lane >> 3;
    const int n = n0 + (lane & 7) + (j >> 1) * 8;
    const int k = k0 + (j & 1) * 8;
    ldsm_x4(r, smem_u32(tile + n * pitch + k));
}

// As ldsm_b, from a tile stored [k][n] (each row's n values contiguous).
__device__ __forceinline__ void ldsm_b_t(uint32_t (&r)[4],
                                         const __nv_bfloat16* tile,
                                         int pitch, int n0, int k0) {
    const int lane = threadIdx.x & 31, j = lane >> 3;
    const int k = k0 + (lane & 7) + (j & 1) * 8;
    const int n = n0 + (j >> 1) * 8;
    ldsm_x4_t(r, smem_u32(tile + k * pitch + n));
}

// The A operand of the k16 step kk of a product whose left factor is a
// 16-row accumulator d[n8 tile][4] (k = the accumulator's columns).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (*d)[4], int kk) {
    a[0] = pack_bf16(d[2 * kk][0], d[2 * kk][1]);
    a[1] = pack_bf16(d[2 * kk][2], d[2 * kk][3]);
    a[2] = pack_bf16(d[2 * kk + 1][0], d[2 * kk + 1][1]);
    a[3] = pack_bf16(d[2 * kk + 1][2], d[2 * kk + 1][3]);
}

// v = hi + lo with hi = bf16(v) and lo = bf16(v - hi): the pair carries
// about 16 bits of v's mantissa (bf16 alone 8), so an fp32 operand split so
// costs two bf16 products and keeps fp32-like accuracy.  Splits v0, v1 into
// the packed pairs hi = (hi0, hi1) and lo = (lo0, lo1).
__device__ __forceinline__ void split_bf16x2(float v0, float v1,
                                             uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(v0 - __bfloat162float(h.x), v1 - __bfloat162float(h.y));
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup (4 warps, 128 threads) multiplies a 64-row tile

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, and the swizzle of the tile (`row_bytes` = 128 or 64: the span
// the TMA wrote with CU_TENSOR_MAP_SWIZZLE_<row_bytes>B).  K-major
// operands: rows of `row_bytes` bytes, 8-row groups `sbo` bytes apart, the
// k16 steps inside a row 32 bytes apart (added to the start address).
// MN-major operands (the transposed B): `lbo` is the stride between
// row_bytes-wide column blocks, `sbo` between 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int row_bytes) {
    const uint64_t layout = row_bytes == 128 ? 1 : 2;
    return static_cast<uint64_t>((addr >> 4) & 0x3FFF)
           | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
           | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
           | layout << 62;
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem) . B (16 x 128, smem), both
// K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 registers) . B (16 x 32, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32_tb(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) . B (16 x 128, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    if constexpr (N == 32) wgmma_rs_n32_tb(d, a, db);
    else if constexpr (N == 64) wgmma_rs_n64_tb(d, a, db);
    else wgmma_rs_n128_tb(d, a, db);
}

}  // namespace hopper
