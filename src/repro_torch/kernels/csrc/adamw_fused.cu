// AdamW over a whole tree of leaves in two passes for Hopper (sm_90a): a
// global sum of squares of the gradients and a multi-tensor update.
//
// It replaces no Pallas kernel: the JAX package leaves AdamW
// (src/repro/optim/__init__.py) to XLA's fusion.  The eager version
// (`repro_torch.optim.adamw_update` on CPU leaves) walks every leaf in runs
// and launches one kernel per elementwise pass, each reading and writing a
// full fp32 run.  The update is bound by bytes on this card: per element it
// needs the gradient once for the norm, then p, g, mu and nu read once and
// p, mu and nu written once (24 bytes a parameter for bf16 params and
// gradients, fp32 moments), at about one flop a byte.  These kernels touch
// each of those bytes once and keep no temporary in device memory.
//
// A table of leaves (`Table`, passed by value as a kernel argument, so no
// host-to-device copy precedes a launch) cuts every leaf into chunks of
// CHUNK elements, numbered across the table; a block takes chunks
// grid-stride and finds each one's leaf by a binary search of the leaves'
// first chunks, so a 389 M-element embedding and a 2,560-element norm
// weight share one launch.  A table holds at most MAX_LEAVES leaves, which
// keeps the arguments under the 4 KB every toolkit takes; the wrapper
// launches one table after another.  Each leaf carries its dtypes (bf16 or
// fp32 params and gradients; fp32 moments), its decay flag and whether all
// its pointers are 16-byte aligned: then a thread moves 8 elements a step
// with 16-byte streaming loads and stores, else (and for a leaf's ragged
// end) one element a step.
//
// A tied head reads the embedding (rows x cols) through a transposed view,
// so its gradient comes back as the transpose of a dense (cols x rows)
// matrix a client.  Such a leaf (TRANS) is cut into TILE x TILE tiles of
// (rows, cols) instead: a block reads the tile's gradient along its rows,
// which are the gradient's contiguous axis, into shared memory, then
// updates the tile along the params' contiguous axis.  Every byte is still
// read once, and no transposed copy of the gradient is made.  The norm
// pass reads such a gradient as the dense run it is stored as.
//
//   adamw_sumsq: each of SUMSQ_BLOCKS blocks writes one fp32 partial sum
//     of g^2 over its chunks (a block with none writes 0).
//   adamw_norm: one block sums the partials in a fixed order and writes
//     the sum, its square root (the global norm) and the clip scale
//     min(1, clip / max(norm, 1e-9)).  No floating-point atomics anywhere:
//     a run repeats bit for bit.
//   adamw_apply: per element, in fp32 and in the order of the eager
//     version's passes (PyTorch divides by a host scalar through its fp32
//     reciprocal; every step rounds once, as its kernels do):
//       g32 = g * s;  mu = b1 mu + (1 - b1) g32;  nu = b2 nu + (1 - b2) g32^2
//       u = (mu / bc1) / (sqrt(nu / bc2) + eps);  u += wd p  (decayed leaves)
//       p = p - lr u
//     where s is 1, one device scalar, or a device vector with one entry
//     per client of the leaf's leading axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 48;
constexpr int THREADS = 256;
constexpr int VEC = 8;
constexpr long long CHUNK = 16384;
constexpr int TILE = 64;
constexpr int SUMSQ_BLOCKS = 1024;
constexpr int NORM_THREADS = 1024;

// Leaf::flags
constexpr int DECAY = 1, P_BF16 = 2, G_BF16 = 4, VEC_G = 8, VEC_ALL = 16,
              TRANS = 32;
// Hyper::scale_mode
constexpr int SCALE_NONE = 0, SCALE_ONE = 1, SCALE_CLIENT = 2;

struct Leaf {
    void* p;
    const void* g;
    float* mu;
    float* nu;
    long long n;           // elements
    long long per_client;  // elements of one client (SCALE_CLIENT)
    long long rows, cols;  // a TRANS leaf's matrices: g[c * rows + r]
    int chunk0;            // the table's number of the leaf's first chunk
    int flags;
};

struct Table {
    Leaf leaf[MAX_LEAVES];
    int n_leaves;
    int n_chunks;
};

struct Hyper {
    const float* scale;
    int scale_mode;
    float b1, one_minus_b1, b2, one_minus_b2;
    float inv_bc1, inv_bc2, eps, wd, neg_lr;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
    }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    __stcs(reinterpret_cast<uint4*>(p), r);
}

// The table's leaf that holds chunk c: the last whose chunk0 <= c.
__device__ __forceinline__ const Leaf& leaf_of(const Table& t, int c) {
    int lo = 0, hi = t.n_leaves - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.leaf[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    return t.leaf[lo];
}

// Sum over the block; the result is valid in thread 0.  Fixed order.
__device__ __forceinline__ float block_sum(float x) {
    __shared__ float warp_sums[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        x = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
    }
    return x;
}

template <typename G>
__device__ float sumsq_chunk(const Leaf& L, long long start, long long end) {
    const G* g = static_cast<const G*>(L.g);
    float acc = 0.f;
    long long vend = start;
    if (L.flags & VEC_G) {
        vend = start + ((end - start) & ~static_cast<long long>(VEC - 1));
#pragma unroll 4
        for (long long i = start + threadIdx.x * VEC; i < vend;
             i += THREADS * VEC) {
            float v[VEC];
            load8(g + i, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc = __fmaf_rn(v[j], v[j], acc);
        }
    }
    for (long long i = vend + threadIdx.x; i < end; i += THREADS) {
        const float x = to_f(g[i]);
        acc = __fmaf_rn(x, x, acc);
    }
    return acc;
}

__global__ void __launch_bounds__(THREADS)
sumsq_kernel(const __grid_constant__ Table t, float* partials) {
    float acc = 0.f;
    for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
        const Leaf& L = leaf_of(t, c);
        const long long start = static_cast<long long>(c - L.chunk0) * CHUNK;
        const long long end = min(start + CHUNK, L.n);
        acc += (L.flags & G_BF16) ? sumsq_chunk<bf16>(L, start, end)
                                  : sumsq_chunk<float>(L, start, end);
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// out[0] = sum of the n partials; for `what` >= 1, out[1] = sqrt(out[0]);
// for `what` = 2, out[2] = min(1, clip / max(out[1], 1e-9)), rounded as
// PyTorch's clip / t (t.reciprocal() * clip) and clamps round it.
__global__ void __launch_bounds__(NORM_THREADS)
norm_kernel(const float* partials, int n, float* out, int what, float clip) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < n; i += NORM_THREADS) acc += partials[i];
    acc = block_sum(acc);
    if (threadIdx.x != 0) return;
    out[0] = acc;
    if (what < 1) return;
    const float nrm = __fsqrt_rn(acc);
    out[1] = nrm;
    if (what == 2) {
        const float d = nrm < 1e-9f ? 1e-9f : nrm;     // NaN stays NaN
        const float s = __fmul_rn(__frcp_rn(d), clip);
        out[2] = s > 1.f ? 1.f : s;
    }
}

__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, float s, bool decay,
                                           const Hyper& h) {
    const float g32 = __fmul_rn(g, s);
    m = __fmaf_rn(h.one_minus_b1, g32, __fmul_rn(m, h.b1));
    v = __fmaf_rn(h.one_minus_b2, __fmul_rn(g32, g32), __fmul_rn(v, h.b2));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
    float u = __fdiv_rn(__fmul_rn(m, h.inv_bc1), den);
    if (decay) u = __fmaf_rn(h.wd, p, u);
    p = __fadd_rn(__fmul_rn(u, h.neg_lr), p);
}

__device__ __forceinline__ float scale_at(const Hyper& h, const Leaf& L,
                                          long long i, float s1) {
    return h.scale_mode == SCALE_CLIENT ? h.scale[i / L.per_client] : s1;
}

template <typename P, typename G>
__device__ void apply_chunk(const Leaf& L, long long start, long long end,
                            const Hyper& h, float s1) {
    P* p = static_cast<P*>(L.p);
    const G* g = static_cast<const G*>(L.g);
    float* mu = L.mu;
    float* nu = L.nu;
    const bool decay = L.flags & DECAY;
    long long vend = start;
    if (L.flags & VEC_ALL) {
        vend = start + ((end - start) & ~static_cast<long long>(VEC - 1));
        for (long long i = start + threadIdx.x * VEC; i < vend;
             i += THREADS * VEC) {
            float pv[VEC], gv[VEC], mv[VEC], vv[VEC];
            load8(p + i, pv);
            load8(g + i, gv);
            load8(mu + i, mv);
            load8(nu + i, vv);
            const float s = scale_at(h, L, i, s1);   // one client a vector
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                adamw_elem(pv[j], gv[j], mv[j], vv[j], s, decay, h);
            store8(p + i, pv);
            store8(mu + i, mv);
            store8(nu + i, vv);
        }
    }
    for (long long i = vend + threadIdx.x; i < end; i += THREADS) {
        float pv = to_f(p[i]), mv = mu[i], vv = nu[i];
        adamw_elem(pv, to_f(g[i]), mv, vv, scale_at(h, L, i, s1), decay, h);
        p[i] = from_f<P>(pv);
        mu[i] = mv;
        nu[i] = vv;
    }
}

// One TILE x TILE tile of a TRANS leaf: the gradient's tile through
// shared memory, then the update along the params' rows.  Where rows and
// cols are multiples of VEC and every pointer is aligned (VEC_ALL), both
// passes move 8 elements a thread at a time.
template <typename P, typename G>
__device__ void apply_tile(const Leaf& L, int tile, const Hyper& h,
                           float s1, float (*gs)[TILE + 1]) {
    const long long R = L.rows, C = L.cols;
    const int tiles_r = static_cast<int>((R + TILE - 1) / TILE);
    const int tiles_c = static_cast<int>((C + TILE - 1) / TILE);
    const int b = tile / (tiles_r * tiles_c);
    const int in_b = tile % (tiles_r * tiles_c);
    const long long r0 = static_cast<long long>(in_b / tiles_c) * TILE;
    const long long c0 = static_cast<long long>(in_b % tiles_c) * TILE;
    const long long base = static_cast<long long>(b) * R * C;
    const G* g = static_cast<const G*>(L.g) + base;
    P* p = static_cast<P*>(L.p) + base;
    float* mu = L.mu + base;
    float* nu = L.nu + base;
    const bool decay = L.flags & DECAY;
    const float s = h.scale_mode == SCALE_CLIENT ? h.scale[base / L.per_client]
                                                 : s1;
    __syncthreads();                              // the last tile is done
    if (L.flags & VEC_ALL) {
        for (int i = threadIdx.x; i < TILE * TILE / VEC; i += THREADS) {
            const int cc = i / (TILE / VEC), rr = i % (TILE / VEC) * VEC;
            float v[VEC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (r0 + rr < R && c0 + cc < C)
                load8(g + (c0 + cc) * R + r0 + rr, v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) gs[cc][rr + j] = v[j];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < TILE * TILE / VEC; i += THREADS) {
            const int rr = i / (TILE / VEC), cc = i % (TILE / VEC) * VEC;
            if (r0 + rr >= R || c0 + cc >= C) continue;
            const long long e = (r0 + rr) * C + c0 + cc;
            float pv[VEC], mv[VEC], vv[VEC];
            load8(p + e, pv);
            load8(mu + e, mv);
            load8(nu + e, vv);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                adamw_elem(pv[j], gs[cc + j][rr], mv[j], vv[j], s, decay, h);
            store8(p + e, pv);
            store8(mu + e, mv);
            store8(nu + e, vv);
        }
        return;
    }
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
        const int cc = i / TILE, rr = i % TILE;
        gs[cc][rr] = r0 + rr < R && c0 + cc < C
                         ? to_f(g[(c0 + cc) * R + r0 + rr]) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
        const int rr = i / TILE, cc = i % TILE;
        if (r0 + rr >= R || c0 + cc >= C) continue;
        const long long e = (r0 + rr) * C + c0 + cc;
        float pv = to_f(p[e]), mv = mu[e], vv = nu[e];
        adamw_elem(pv, gs[cc][rr], mv, vv, s, decay, h);
        p[e] = from_f<P>(pv);
        mu[e] = mv;
        nu[e] = vv;
    }
}

template <typename P, typename G>
__device__ __forceinline__ void apply_one(const Leaf& L, int c,
                                          const Hyper& h, float s1,
                                          float (*gs)[TILE + 1]) {
    if (L.flags & TRANS) {
        apply_tile<P, G>(L, c - L.chunk0, h, s1, gs);
        return;
    }
    const long long start = static_cast<long long>(c - L.chunk0) * CHUNK;
    apply_chunk<P, G>(L, start, min(start + CHUNK, L.n), h, s1);
}

__global__ void __launch_bounds__(THREADS)
apply_kernel(const __grid_constant__ Table t, const __grid_constant__ Hyper h) {
    __shared__ float gs[TILE][TILE + 1];          // a TRANS tile: [col][row]
    const float s1 = h.scale_mode == SCALE_ONE ? *h.scale : 1.f;
    for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
        const Leaf& L = leaf_of(t, c);
        switch (L.flags & (P_BF16 | G_BF16)) {
            case P_BF16 | G_BF16: apply_one<bf16, bf16>(L, c, h, s1, gs); break;
            case P_BF16: apply_one<bf16, float>(L, c, h, s1, gs); break;
            case G_BF16: apply_one<float, bf16>(L, c, h, s1, gs); break;
            default: apply_one<float, float>(L, c, h, s1, gs); break;
        }
    }
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// The layout the wrapper's ctypes structures must match: sizeof(Leaf),
// sizeof(Table), sizeof(Hyper), MAX_LEAVES, CHUNK, SUMSQ_BLOCKS, TILE.
extern "C" int adamw_abi(long long* out) {
    out[0] = sizeof(Leaf);
    out[1] = sizeof(Table);
    out[2] = sizeof(Hyper);
    out[3] = MAX_LEAVES;
    out[4] = CHUNK;
    out[5] = SUMSQ_BLOCKS;
    out[6] = TILE;
    return 0;
}

// Writes SUMSQ_BLOCKS partial sums of g^2 over the table's leaves.
extern "C" int adamw_sumsq(const void* table, float* partials, void* stream) {
    const Table& t = *static_cast<const Table*>(table);
    sumsq_kernel<<<SUMSQ_BLOCKS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(t, partials);
    return launched();
}

// Sums n partials into out[0]; `what` 1 writes the norm (out[1]) too, 2
// the norm and the clip scale (out[2]).
extern "C" int adamw_norm(const float* partials, int n, float* out, int what,
                          float clip, void* stream) {
    norm_kernel<<<1, NORM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        partials, n, out, what, clip);
    return launched();
}

// One AdamW step of the table's leaves, in place, on the current device.
extern "C" int adamw_apply(const void* table, const void* hyper,
                           void* stream) {
    const Table& t = *static_cast<const Table*>(table);
    if (t.n_chunks <= 0) return 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, apply_kernel, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int fill = sms * (per_sm > 0 ? per_sm : 1);
    const int grid = t.n_chunks < fill ? t.n_chunks : fill;
    apply_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        t, *static_cast<const Hyper*>(hyper));
    return launched();
}
