// Streaming passes over logit rows for the KL kernels (sm_90a): 16-byte
// loads and stores held as raw 32-bit words, one MUFU.EX2 per exponential,
// and one walk over a row that tiles it into full, masked and one-element
// steps.  Shared by kl_mutual_pair.cu (the Eq.-2 forwards and backwards)
// and sparse_kl.cu (the sparse forward).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the SFU: one MUFU.EX2 (inputs far below -126 give 0).
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// One load of a row: 16 bytes when VEC, else one element; held as raw
// 32-bit words and unpacked to fp32 where used.
template <typename T, bool VEC>
struct Pack {
    static constexpr int WORDS = VEC ? 4 : 1;
    static constexpr int W = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
    unsigned w[WORDS];
};

template <typename T, bool VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
    Pack<T, VEC> r;
    if constexpr (VEC) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        r.w[0] = q.x;
        r.w[1] = q.y;
        r.w[2] = q.z;
        r.w[3] = q.w;
    } else if constexpr (sizeof(T) == 2) {
        r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
        r.w[0] = __float_as_uint(__ldg(reinterpret_cast<const float*>(p)));
    }
    return r;
}

template <typename T, bool VEC>
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
    Pack<T, VEC> r;
#pragma unroll
    for (int k = 0; k < Pack<T, VEC>::WORDS; ++k) r.w[k] = 0u;
    return r;
}

// A streaming store (st.global.cs: the line is not kept for reuse) when
// VEC; else one element.
template <typename T, bool VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& pk) {
    if constexpr (VEC) {
        __stcs(reinterpret_cast<uint4*>(p),
               make_uint4(pk.w[0], pk.w[1], pk.w[2], pk.w[3]));
    } else if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<unsigned short*>(p) =
            static_cast<unsigned short>(pk.w[0]);
    } else {
        *reinterpret_cast<unsigned*>(p) = pk.w[0];
    }
}

// Element e of a pack as fp32 (a bf16 is the high half of an fp32).
template <typename T, bool VEC>
__device__ __forceinline__ float elem(const Pack<T, VEC>& pk, int e) {
    if constexpr (sizeof(T) == 2) {
        const unsigned w = pk.w[VEC ? e / 2 : 0];
        return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    } else {
        return __uint_as_float(pk.w[e]);
    }
}

// Sets element e of a pack to x rounded to T; a bf16 pack's elements are
// set in order (an even element starts its word).
template <typename T, bool VEC>
__device__ __forceinline__ void set_elem(Pack<T, VEC>& pk, int e, float x) {
    if constexpr (sizeof(T) == 2) {
        const unsigned h = __bfloat16_as_ushort(__float2bfloat16(x));
        unsigned& w = pk.w[VEC ? e / 2 : 0];
        w = (e & 1) ? (w | (h << 16)) : h;
    } else {
        pk.w[e] = __float_as_uint(x);
    }
}

// Packs a row a thread loads per full tile: 8 words of 16-byte loads for
// up to 4 rows, 4 for more, so the tile stays in registers; one element
// without VEC.
template <bool VEC, int ROWS>
__host__ __device__ constexpr int packs_per_tile() {
    return VEC && ROWS <= 4 ? 2 : 1;
}

// max over a tile's elements of one row, times c (log2 units); a masked
// tile (one pack) that is not `ok` gives NEG_INF * c
template <typename T, bool VEC, int NV>
__device__ __forceinline__ float tile_max(const Pack<T, VEC> (&pk)[NV],
                                          bool ok, float c) {
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < Pack<T, VEC>::W; ++e)
            mx = fmaxf(mx, elem(pk[n], e));
    return (ok ? mx : NEG_INF) * c;
}

// Streams one position range of R rows (rows(r) points at row r): full
// tiles of NTHREADS x NV packs a row through `full(packs, v)` (unmasked;
// pack n starts at element v + n NTHREADS W), the packs after the last
// full tile NTHREADS at a time through `part(packs, ok, v)` (masked), and
// the elements before the rows' first 16-byte boundary and after their
// last whole pack through `one(packs, ok, v)`, one element a thread.  Every
// row must share rows(0)'s 16-byte phase when VEC.
template <typename T, bool VEC, int R, int NV, class RowsT, class Full,
          class Part, class One>
__device__ __forceinline__ void stream_row(const RowsT& rows, int V,
                                           Full full, Part part, One one) {
    constexpr int W = Pack<T, VEC>::W;
    constexpr int TILE = NTHREADS * NV;
    const int tid = threadIdx.x;
    int head = 0;
    if constexpr (VEC) {
        const unsigned off = static_cast<unsigned>(
            reinterpret_cast<unsigned long long>(rows(0)) & 15ull);
        head = min(V, static_cast<int>(((16u - off) & 15u) / sizeof(T)));
    }
    const int nvec = (V - head) / W;
    const int tiled = nvec - nvec % TILE;           // packs in full tiles
    for (int q0 = 0; q0 < tiled; q0 += TILE) {
        Pack<T, VEC> pk[R][NV];
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int r = 0; r < R; ++r)
                pk[r][n] = load_pack<T, VEC>(
                    rows(r) + head + (q0 + n * NTHREADS + tid) * W);
        full(pk, head + (q0 + tid) * W);
    }
    for (int q0 = tiled; q0 < nvec; q0 += NTHREADS) {
        const int q = q0 + tid;
        const bool ok = q < nvec;
        Pack<T, VEC> pk[R][1];
#pragma unroll
        for (int r = 0; r < R; ++r)
            pk[r][0] = ok ? load_pack<T, VEC>(rows(r) + head + q * W)
                          : zero_pack<T, VEC>();
        part(pk, ok, head + q * W);
    }
    if constexpr (VEC) {
        const int rest = V - nvec * W;              // < 2 W
        if (rest > 0) {
            const bool ok = tid < rest;
            const int v = tid < head ? tid : tid + nvec * W;
            Pack<T, false> pk[R][1];
#pragma unroll
            for (int r = 0; r < R; ++r)
                pk[r][0] = ok ? load_pack<T, false>(rows(r) + v)
                              : zero_pack<T, false>();
            one(pk, ok, v);
        }
    }
}

int launched(cudaError_t err) {
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
