// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of causal GQA
// attention with an optional sliding window, from the forward's saved
// output and per-row logsumexp.
//
// Replaces src/repro/kernels/flash_attention.py:145-206
// (`_streaming_attn_bwd`, the plain-JAX backward inside the custom_vjp of
// the TPU kernel at :34).  It computes what that backward computes:
//
//     delta = sum_d dout * out                      (per query row)
//     p     = exp(s * scale - lse)                  (s = q.k, masked -> 0)
//     dv    = p^T dout ;  dp = dout v^T
//     ds    = p * (dp - delta) * scale
//     dq    = ds k ;  dk = ds^T q                   (dk, dv summed over the
//                                                    query heads of a group)
//
// -- not its schedule.  Three launches, no atomics, deterministic:
//   1. `attn_bwd_delta`: one warp per query row reduces dout * out.
//   2. `attn_bwd_dkdv`: one block per (batch, KV head, 64-key tile) keeps its
//      K and V tiles in shared memory and loops over the query tiles of ALL
//      G query heads of its group that can see the tile (causality bounds
//      them from below, the window from above).  dk and dv accumulate in
//      registers, so the group sum needs no atomics.
//   3. `attn_bwd_dq`: one block per (batch, query head, 64-row query tile)
//      loops over the key tiles the forward visited, recomputes p and ds and
//      accumulates dq in registers.
// Masks are the forward's: causal, window, and key positions >= T (query
// rows >= S are zero-filled and masked too).  Tiles that are fully masked
// are skipped.  Everything is fp32 FMAs from shared-memory tiles, which
// keeps one exact path for fp32 and bf16 inputs.
//
// Layout: q (B, S, Hq, hd) and k/v (B, T, Hkv, hd) with arbitrary batch,
// sequence and head strides and a unit stride on hd (v is a slice of the
// fused QKV); out, dout, dq contiguous (B, S, Hq, hd); dk, dv contiguous
// (B, T, Hkv, hd); lse and the delta scratch contiguous fp32 (B, Hq, S).
//
// What bounds it on the H100: the backward needs about 10 * hd flops per
// unmasked (query, key) pair (q.k, dout.v, and the three products dv, dk,
// dq; this version does q.k and dout.v twice, once in each pass) against
// q, k, v, out, dout, lse read and dq, dk, dv written once.  At the
// training shape (S = 512, hd = 128, Hq/Hkv = 4, bf16) that is about 256
// flop/byte, just under the card's 295 flop/byte ridge: HBM bytes bound
// it, with the tensor cores close behind, and from S ~ 600 up the tensor
// cores do.  This first version uses none of them (see the forward's
// note), so it runs at the fp32 FMA rate.  mma/wgmma, TMA and warp
// specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16 threads
constexpr int ROWS_PER_DELTA_BLOCK = NTHREADS / 32;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* out;
    const void* dout;
    const float* lse;
    float* delta;
    void* dq;
    void* dk;
    void* dv;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    int B, S, T, Hq, Hkv;
    int causal, window;  // window <= 0: no window
    float sm_scale;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// Whether query position s attends to key position t.
__device__ __forceinline__ bool visible(const Params& p, int s, int t) {
    bool ok = s < p.S && t < p.T;
    if (p.causal) ok = ok && t <= s;
    if (p.window > 0) ok = ok && s - t < p.window;
    return ok;
}

// Shared-memory plan, in floats; rows padded by one float against bank
// conflicts on the column walks.
template <int HD>
struct Smem {
    static constexpr int LD = HD + 1;
    static constexpr int LDP = BN + 1;
    static constexpr int Q = 0;
    static constexpr int DO = Q + BM * LD;
    static constexpr int K = DO + BM * LD;
    static constexpr int V = K + BN * LD;
    static constexpr int P = V + BN * LD;
    static constexpr int LSE = P + BM * LDP;
    static constexpr int DELTA = LSE + BM;
    static constexpr int TOTAL = DELTA + BM;
};

// ---------------------------------------------------------------------------
// 1. delta[b, h, s] = sum_d dout[b, s, h, d] * out[b, s, h, d]

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_delta(Params p) {
    const int lane = threadIdx.x % 32;
    const long long row =
        static_cast<long long>(blockIdx.x) * ROWS_PER_DELTA_BLOCK +
        threadIdx.x / 32;
    const long long n_rows = static_cast<long long>(p.B) * p.Hq * p.S;
    float acc = 0.f;
    if (row < n_rows) {
        const long long b = row / (static_cast<long long>(p.Hq) * p.S);
        const int h = static_cast<int>((row / p.S) % p.Hq);
        const int s = static_cast<int>(row % p.S);
        const long long off =
            ((b * p.S + s) * p.Hq + h) * static_cast<long long>(HD);
        const T* o = static_cast<const T*>(p.out) + off;
        const T* d = static_cast<const T*>(p.dout) + off;
        for (int i = lane; i < HD; i += 32) acc += load_f(o + i) * load_f(d + i);
    }
    for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (row < n_rows && lane == 0) p.delta[row] = acc;
}

// Loads rows [r0, r0 + 64) of a (len, HD) slab with row stride `ss` into a
// shared tile of row stride LD, zero-filling rows >= len.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int len) {
    constexpr int LD = HD + 1;
    for (int i = threadIdx.x; i < 64 * HD; i += NTHREADS) {
        const int r = i / HD, d = i % HD;
        const int s = r0 + r;
        dst[r * LD + d] = s < len ? load_f(src + s * ss + d) : 0.f;
    }
}

// ---------------------------------------------------------------------------
// 2. dk, dv for one (batch, KV head, key tile), summed over the query group

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dkdv(Params p) {
    using SM = Smem<HD>;
    constexpr int LD = SM::LD;
    constexpr int LDP = SM::LDP;
    constexpr int CN = HD / 16;
    extern __shared__ float smem[];
    float* Qs = smem + SM::Q;
    float* DOs = smem + SM::DO;
    float* Ks = smem + SM::K;
    float* Vs = smem + SM::V;
    float* Ps = smem + SM::P;
    float* row_lse = smem + SM::LSE;
    float* row_delta = smem + SM::DELTA;

    const int tid = threadIdx.x;
    const int n0 = blockIdx.x * BN;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int G = p.Hq / p.Hkv;
    const int rg = tid / 16, cg = tid % 16;
    const long long o_ss = static_cast<long long>(p.Hq) * HD;
    const long long o_sb = static_cast<long long>(p.S) * o_ss;

    load_tile<T, HD>(Ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh,
                     p.k_ss, n0, p.T);
    load_tile<T, HD>(Vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh,
                     p.v_ss, n0, p.T);

    // Query tiles that can see this key tile.
    const int m_begin = p.causal ? (n0 / BM) * BM : 0;
    const long long w_end = static_cast<long long>(n0) + BN - 1 + p.window;
    const int m_end =
        p.window > 0 && w_end < p.S ? static_cast<int>(w_end) : p.S;

    float dk[4][CN], dv[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) dk[i][j] = dv[i][j] = 0.f;

    for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
        const T* dog = static_cast<const T*>(p.dout) + b * o_sb + h * HD;
        const float* lse_g = p.lse + static_cast<long long>(b * p.Hq + h) * p.S;
        const float* delta_g =
            p.delta + static_cast<long long>(b * p.Hq + h) * p.S;
        for (int m0 = m_begin; m0 < m_end; m0 += BM) {
            __syncthreads();  // the previous tile's readers are done
            load_tile<T, HD>(Qs, qg, p.q_ss, m0, p.S);
            load_tile<T, HD>(DOs, dog, o_ss, m0, p.S);
            if (tid < BM) {
                const int s = m0 + tid;
                row_lse[tid] = s < p.S ? lse_g[s] : 0.f;
                row_delta[tid] = s < p.S ? delta_g[s] : 0.f;
            }
            __syncthreads();

            // s = q.k and dp = dout.v: query rows rg*4+i, keys cg+16*j
            float sc[4][4], dp[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
            for (int d = 0; d < HD; ++d) {
                float qa[4], da[4], kb[4], vb[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    qa[i] = Qs[(rg * 4 + i) * LD + d];
                    da[i] = DOs[(rg * 4 + i) * LD + d];
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    kb[j] = Ks[(cg + 16 * j) * LD + d];
                    vb[j] = Vs[(cg + 16 * j) * LD + d];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
                        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
                    }
            }
            float pr[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = rg * 4 + i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = cg + 16 * j;
                    pr[i][j] = visible(p, m0 + r, n0 + c)
                                   ? expf(sc[i][j] * p.sm_scale - row_lse[r])
                                   : 0.f;
                    Ps[r * LDP + c] = pr[i][j];
                }
            }
            __syncthreads();

            // dv += p^T dout: key rows rg*4+i, head-dim columns cg+16*j
            for (int m = 0; m < BM; ++m) {
                float pc[4], dd[CN];
#pragma unroll
                for (int i = 0; i < 4; ++i) pc[i] = Ps[m * LDP + rg * 4 + i];
#pragma unroll
                for (int j = 0; j < CN; ++j) dd[j] = DOs[m * LD + cg + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < CN; ++j)
                        dv[i][j] = fmaf(pc[i], dd[j], dv[i][j]);
            }
            __syncthreads();  // p is read; overwrite it with ds

#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = rg * 4 + i;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    Ps[r * LDP + cg + 16 * j] =
                        pr[i][j] * (dp[i][j] - row_delta[r]) * p.sm_scale;
            }
            __syncthreads();

            // dk += ds^T q
            for (int m = 0; m < BM; ++m) {
                float dc[4], qq[CN];
#pragma unroll
                for (int i = 0; i < 4; ++i) dc[i] = Ps[m * LDP + rg * 4 + i];
#pragma unroll
                for (int j = 0; j < CN; ++j) qq[j] = Qs[m * LD + cg + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < CN; ++j)
                        dk[i][j] = fmaf(dc[i], qq[j], dk[i][j]);
            }
        }
    }

    const long long g_ss = static_cast<long long>(p.Hkv) * HD;
    const long long g_sb = static_cast<long long>(p.T) * g_ss;
    T* dkg = static_cast<T*>(p.dk) + b * g_sb + hk * HD;
    T* dvg = static_cast<T*>(p.dv) + b * g_sb + hk * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = n0 + rg * 4 + i;
        if (t < p.T) {
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                store_f(dkg + t * g_ss + cg + 16 * j, dk[i][j]);
                store_f(dvg + t * g_ss + cg + 16 * j, dv[i][j]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dq for one (batch, query head, query tile)

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) attn_bwd_dq(Params p) {
    using SM = Smem<HD>;
    constexpr int LD = SM::LD;
    constexpr int LDP = SM::LDP;
    constexpr int CN = HD / 16;
    extern __shared__ float smem[];
    float* Qs = smem + SM::Q;
    float* DOs = smem + SM::DO;
    float* Ks = smem + SM::K;
    float* Vs = smem + SM::V;
    float* Ps = smem + SM::P;
    float* row_lse = smem + SM::LSE;
    float* row_delta = smem + SM::DELTA;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (p.Hq / p.Hkv);
    const int rg = tid / 16, cg = tid % 16;
    const long long o_ss = static_cast<long long>(p.Hq) * HD;
    const long long o_sb = static_cast<long long>(p.S) * o_ss;

    load_tile<T, HD>(Qs, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                     p.q_ss, q0, p.S);
    load_tile<T, HD>(DOs, static_cast<const T*>(p.dout) + b * o_sb + h * HD,
                     o_ss, q0, p.S);
    if (tid < BM) {
        const long long row = static_cast<long long>(b * p.Hq + h) * p.S;
        const int s = q0 + tid;
        row_lse[tid] = s < p.S ? p.lse[row + s] : 0.f;
        row_delta[tid] = s < p.S ? p.delta[row + s] : 0.f;
    }
    const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

    // The key tiles the forward visited for this query tile.
    const int q_last = min(q0 + BM, p.S) - 1;
    const int n_end = p.causal ? min(p.T, q_last + 1) : p.T;
    const int n_begin =
        p.window > 0 ? (max(0, q0 - p.window + 1) / BN) * BN : 0;

    float dq[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) dq[i][j] = 0.f;

    for (int n0 = n_begin; n0 < n_end; n0 += BN) {
        __syncthreads();  // the previous tile's readers are done
        load_tile<T, HD>(Ks, kg, p.k_ss, n0, p.T);
        load_tile<T, HD>(Vs, vg, p.v_ss, n0, p.T);
        __syncthreads();

        float sc[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
        for (int d = 0; d < HD; ++d) {
            float qa[4], da[4], kb[4], vb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                qa[i] = Qs[(rg * 4 + i) * LD + d];
                da[i] = DOs[(rg * 4 + i) * LD + d];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                kb[j] = Ks[(cg + 16 * j) * LD + d];
                vb[j] = Vs[(cg + 16 * j) * LD + d];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
                    dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
                }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = rg * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = cg + 16 * j;
                const float pr =
                    visible(p, q0 + r, n0 + c)
                        ? expf(sc[i][j] * p.sm_scale - row_lse[r])
                        : 0.f;
                Ps[r * LDP + c] = pr * (dp[i][j] - row_delta[r]) * p.sm_scale;
            }
        }
        __syncthreads();

        // dq += ds k: query rows rg*4+i, head-dim columns cg+16*j
        for (int c = 0; c < BN; ++c) {
            float dr[4], kk[CN];
#pragma unroll
            for (int i = 0; i < 4; ++i) dr[i] = Ps[(rg * 4 + i) * LDP + c];
#pragma unroll
            for (int j = 0; j < CN; ++j) kk[j] = Ks[c * LD + cg + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < CN; ++j)
                    dq[i][j] = fmaf(dr[i], kk[j], dq[i][j]);
        }
    }

    T* dqg = static_cast<T*>(p.dq) + b * o_sb + h * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = q0 + rg * 4 + i;
        if (s < p.S) {
#pragma unroll
            for (int j = 0; j < CN; ++j)
                store_f(dqg + s * o_ss + cg + 16 * j, dq[i][j]);
        }
    }
}

template <typename T, int HD>
int launch(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    const long long n_rows = static_cast<long long>(p.B) * p.Hq * p.S;
    const dim3 delta_grid(static_cast<unsigned>(
        (n_rows + ROWS_PER_DELTA_BLOCK - 1) / ROWS_PER_DELTA_BLOCK));
    cudaError_t err = cudaLaunchKernel(&attn_bwd_delta<T, HD>, delta_grid,
                                       dim3(NTHREADS), args, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);

    const int smem_bytes = Smem<HD>::TOTAL * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(&attn_bwd_dkdv<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(&attn_bwd_dq<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernel(&attn_bwd_dkdv<T, HD>,
                           dim3((p.T + BN - 1) / BN, p.Hkv, p.B),
                           dim3(NTHREADS), args, smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernel(&attn_bwd_dq<T, HD>,
                           dim3((p.S + BM - 1) / BM, p.Hq, p.B),
                           dim3(NTHREADS), args, smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int hd, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(p, stream);
        case 64: return launch<T, 64>(p, stream);
        case 128: return launch<T, 128>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launches the three passes on `stream`; returns the first CUDA error (0 on
// success).  The caller has checked shapes, dtypes, devices and strides and
// allocated dq, dk, dv and the (B, Hq, S) fp32 delta scratch.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int B, int S, int T, int Hq, int Hkv, int hd,
    int causal, int window, float sm_scale, int is_bf16, void* stream) {
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.out = out;
    p.dout = dout;
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<float*>(delta);
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
    p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
    p.B = B;
    p.S = S;
    p.T = T;
    p.Hq = Hq;
    p.Hkv = Hkv;
    p.causal = causal;
    p.window = window;
    p.sm_scale = sm_scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_hd<__nv_bfloat16>(p, hd, st)
                   : launch_hd<float>(p, hd, st);
}
