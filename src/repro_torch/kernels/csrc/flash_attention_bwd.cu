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
//   1. delta: dout * out reduced per query row.
//   2. dk/dv: one block per (batch, KV head, 64-key tile) keeps its K and V
//      tiles in shared memory and loops over the query tiles of ALL G query
//      heads of its group that can see the tile (causality bounds them from
//      below, the window from above).  dk and dv accumulate in registers,
//      so the group sum needs no atomics.
//   3. dq: one block per (batch, query head, 64-row query tile) loops over
//      the key tiles the forward visited, recomputes p and ds and
//      accumulates dq in registers.
// Masks are the forward's: causal, window, and key positions >= T (query
// rows >= S are zero-filled and masked too).  Tiles that are fully masked
// are skipped.
//
// Layout: q (B, S, Hq, hd) and k/v (B, T, Hkv, hd) with arbitrary batch,
// sequence and head strides and a unit stride on hd (v is a slice of the
// fused QKV); out, dout, dq contiguous (B, S, Hq, hd); dk, dv contiguous
// (B, T, Hkv, hd); lse and the delta scratch contiguous fp32 (B, Hq, S).
//
// What bounds it on the H100: the backward needs about 10 * hd flops per
// unmasked (query, key) pair (q.k, dout.v, and the three products dv, dk,
// dq; this schedule does q.k and dout.v twice, once in each pass) against
// q, k, v, out, dout, lse read and dq, dk, dv written once.  At the
// training shape (S = 512, hd = 128, Hq/Hkv = 4, bf16) that is about 256
// flop/byte, just under the card's 295 flop/byte ridge: HBM bytes bound
// it, with the tensor cores close behind, and from S ~ 600 up the tensor
// cores do.  So every product has to run on the tensor cores.
//
// bf16 inputs (namespace `tc`, the training path): every product -- s^T,
// dp^T, dv, dk in pass 2 and s, dp, dq in pass 3 -- is an mma.sync
// m16n8k16 with bf16 operands and fp32 accumulation; four warps a block,
// each owning 16 rows of the block's 64-row tile.  Operands come from
// shared memory by ldmatrix (the transposing form for the (k, n)-stored
// B operands dout, q and k), in tiles padded by 16 bytes a row so the
// ldmatrix rows fall in distinct banks.  Pass 2 computes the transposed
// scores s^T = k.q^T and dp^T = v.dout^T, so p^T and ds^T already sit in
// registers as the A operands of dv += p^T dout and dk += ds^T q, rounded
// to bf16 there, and no tile goes back through shared memory; pass 3 uses
// ds from registers the same way for dq += ds k.  Tiles arrive by
// cp.async 16-byte copies (zero-filled past S and T), double-buffered: the
// next (head, query tile) of pass 2 and the next key tile of pass 3 load
// while the current one multiplies.  The delta pass reads 16 bytes a
// thread.
//
// fp32 inputs keep the exact FMA kernels (`attn_bwd_delta`,
// `attn_bwd_dkdv`, `attn_bwd_dq`): fp32 FMAs from shared-memory tiles,
// 64-row tiles, which hold the fp32 checks to 1e-4; TF32 tensor cores would
// keep three digits.

#include "hopper_mma.cuh"

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

template <int HD>
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
        const float* o = static_cast<const float*>(p.out) + off;
        const float* d = static_cast<const float*>(p.dout) + off;
        for (int i = lane; i < HD; i += 32) acc += o[i] * d[i];
    }
    for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (row < n_rows && lane == 0) p.delta[row] = acc;
}

// Loads rows [r0, r0 + 64) of a (len, HD) slab with row stride `ss` into a
// shared tile of row stride LD, zero-filling rows >= len.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int len) {
    constexpr int LD = HD + 1;
    for (int i = threadIdx.x; i < 64 * HD; i += NTHREADS) {
        const int r = i / HD, d = i % HD;
        const int s = r0 + r;
        dst[r * LD + d] = s < len ? src[s * ss + d] : 0.f;
    }
}

// ---------------------------------------------------------------------------
// 2. dk, dv for one (batch, KV head, key tile), summed over the query group

template <int HD>
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

    const float* kg =
        static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const float* vg =
        static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
    load_tile<HD>(Ks, kg, p.k_ss, n0, p.T);
    load_tile<HD>(Vs, vg, p.v_ss, n0, p.T);

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
        const float* qg =
            static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
        const float* dog =
            static_cast<const float*>(p.dout) + b * o_sb + h * HD;
        const float* lse_g = p.lse + static_cast<long long>(b * p.Hq + h) * p.S;
        const float* delta_g =
            p.delta + static_cast<long long>(b * p.Hq + h) * p.S;
        for (int m0 = m_begin; m0 < m_end; m0 += BM) {
            __syncthreads();  // the previous tile's readers are done
            load_tile<HD>(Qs, qg, p.q_ss, m0, p.S);
            load_tile<HD>(DOs, dog, o_ss, m0, p.S);
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
    float* dkg = static_cast<float*>(p.dk) + b * g_sb + hk * HD;
    float* dvg = static_cast<float*>(p.dv) + b * g_sb + hk * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = n0 + rg * 4 + i;
        if (t < p.T) {
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                dkg[t * g_ss + cg + 16 * j] = dk[i][j];
                dvg[t * g_ss + cg + 16 * j] = dv[i][j];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 3. dq for one (batch, query head, query tile)

template <int HD>
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

    load_tile<HD>(Qs,
                  static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
                  p.q_ss, q0, p.S);
    load_tile<HD>(DOs, static_cast<const float*>(p.dout) + b * o_sb + h * HD,
                  o_ss, q0, p.S);
    if (tid < BM) {
        const long long row = static_cast<long long>(b * p.Hq + h) * p.S;
        const int s = q0 + tid;
        row_lse[tid] = s < p.S ? p.lse[row + s] : 0.f;
        row_delta[tid] = s < p.S ? p.delta[row + s] : 0.f;
    }
    const float* kg =
        static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const float* vg =
        static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

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
        load_tile<HD>(Ks, kg, p.k_ss, n0, p.T);
        load_tile<HD>(Vs, vg, p.v_ss, n0, p.T);
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

    float* dqg = static_cast<float*>(p.dq) + b * o_sb + h * HD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = q0 + rg * 4 + i;
        if (s < p.S) {
#pragma unroll
            for (int j = 0; j < CN; ++j)
                dqg[s * o_ss + cg + 16 * j] = dq[i][j];
        }
    }
}

template <int HD>
int launch_fma(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    const long long n_rows = static_cast<long long>(p.B) * p.Hq * p.S;
    const dim3 delta_grid(static_cast<unsigned>(
        (n_rows + ROWS_PER_DELTA_BLOCK - 1) / ROWS_PER_DELTA_BLOCK));
    cudaError_t err = cudaLaunchKernel(&attn_bwd_delta<HD>, delta_grid,
                                       dim3(NTHREADS), args, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);

    const int smem_bytes = Smem<HD>::TOTAL * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(&attn_bwd_dkdv<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(&attn_bwd_dq<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernel(&attn_bwd_dkdv<HD>,
                           dim3((p.T + BN - 1) / BN, p.Hkv, p.B),
                           dim3(NTHREADS), args, smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernel(&attn_bwd_dq<HD>,
                           dim3((p.S + BM - 1) / BM, p.Hq, p.B),
                           dim3(NTHREADS), args, smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

int launch_hd_fma(const Params& p, int hd, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch_fma<32>(p, stream);
        case 64: return launch_fma<64>(p, stream);
        case 128: return launch_fma<128>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core passes 2 and 3 (mma.sync m16n8k16, ldmatrix)

namespace tc {

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 128;  // four warps, 16 rows of the block's tile each
constexpr float LOG2E = 1.4426950408889634f;

// 1. delta = sum_d dout * out, reading 16 bytes a thread: HD / 8 lanes
// share a row, in the (B, S, Hq) order of out, and reduce by shuffles.
template <int HD>
__global__ void __launch_bounds__(256) attn_bwd_delta_tc(Params p) {
    constexpr int LPR = HD / 8;  // lanes a row
    const long long idx =
        static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
    const long long r = idx / LPR;  // row of out: (b * S + s) * Hq + h
    const long long n_rows = static_cast<long long>(p.B) * p.S * p.Hq;
    float acc = 0.f;
    if (r < n_rows) {
        const long long off = r * HD + (idx % LPR) * 8;
        const uint4 o = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.out) + off);
        const uint4 d = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.dout) + off);
        const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
        const uint32_t dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 of = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&ow[i]));
            const float2 df = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&dw[i]));
            acc += of.x * df.x + of.y * df.y;
        }
    }
#pragma unroll
    for (int m = LPR / 2; m > 0; m /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (r < n_rows && idx % LPR == 0) {
        const long long h = r % p.Hq, s = r / p.Hq % p.S,
                        b = r / (static_cast<long long>(p.Hq) * p.S);
        p.delta[(b * p.Hq + h) * p.S + s] = acc;
    }
}

// Shared-memory tiles are (64, HD) bf16 with rows padded by 16 bytes, so the
// eight row addresses of an ldmatrix fall in distinct banks.
template <int HD>
struct Tile {
    static constexpr int LD = HD + 8;            // elements
    static constexpr int BYTES = 64 * LD * 2;
};

// Issues the cp.async copies of rows [r0, r0 + 64) of a (len, HD) bf16
// slab of row stride `ss` into `dst`; rows >= len are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long ss, int r0,
                                                int len) {
    constexpr int CPR = HD / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < 64 * CPR; i += NTHREADS) {
        const int r = i / CPR, c = i % CPR;
        const bool ok = r0 + r < len;
        const __nv_bfloat16* g = src + (ok ? (r0 + r) * ss : 0) + c * 8;
        hopper::cp_async16(dst + (r * Tile<HD>::LD + c * 8) * 2, g, ok);
    }
}

// The 16-row A operand (rows row0.., k columns k0..k0+15) of a tile.
template <int HD>
__device__ __forceinline__ void lds_a(uint32_t (&a)[4], uint32_t tile,
                                      int row0, int k0) {
    const int lane = threadIdx.x % 32;
    const int r = row0 + lane % 8 + 8 * ((lane / 8) % 2);
    const int c = k0 + 8 * (lane / 16);
    hopper::ldsm_x4(a, tile + (r * Tile<HD>::LD + c) * 2);
}

// The B operands of two 8-column blocks n0.. and n0+8.. at depth k0..k0+15,
// from a tile stored (n, k): b[0], b[1] for the first block, b[2], b[3] for
// the second.
template <int HD>
__device__ __forceinline__ void lds_b_nk(uint32_t (&b)[4], uint32_t tile,
                                         int n0, int k0) {
    const int lane = threadIdx.x % 32;
    const int r = n0 + lane % 8 + 8 * (lane / 16);
    const int c = k0 + 8 * ((lane / 8) % 2);
    hopper::ldsm_x4(b, tile + (r * Tile<HD>::LD + c) * 2);
}

// As lds_b_nk from a tile stored (k, n), through the transposing ldmatrix.
template <int HD>
__device__ __forceinline__ void lds_b_kn(uint32_t (&b)[4], uint32_t tile,
                                         int n0, int k0) {
    const int lane = threadIdx.x % 32;
    const int r = k0 + lane % 8 + 8 * ((lane / 8) % 2);
    const int c = n0 + 8 * (lane / 16);
    hopper::ldsm_x4_t(b, tile + (r * Tile<HD>::LD + c) * 2);
}

// acc (16 x 64) = A-tile rows row0.. (16 x HD) times B-tile^T (64 x HD)^T:
// q.k^T, dout.v^T, and their transposes.
template <int HD>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], uint32_t a_tile,
                                           int row0, uint32_t b_tile) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        lds_a<HD>(a, a_tile, row0, kk * 16);
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
            uint32_t b[4];
            lds_b_nk<HD>(b, b_tile, n2 * 16, kk * 16);
            hopper::mma_bf16(acc[2 * n2], a, b[0], b[1]);
            hopper::mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
        }
    }
}

// acc (16 x HD) += X (16 x 64, the fp32 accumulator of product_nt, rounded
// to bf16 as the A operand) times a (64, HD) tile.
template <int HD>
__device__ __forceinline__ void product_nn(float (&acc)[HD / 8][4],
                                           const float (&x)[8][4],
                                           uint32_t b_tile) {
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
        const uint32_t a[4] = {
            hopper::pack_bf16(x[2 * k2][0], x[2 * k2][1]),
            hopper::pack_bf16(x[2 * k2][2], x[2 * k2][3]),
            hopper::pack_bf16(x[2 * k2 + 1][0], x[2 * k2 + 1][1]),
            hopper::pack_bf16(x[2 * k2 + 1][2], x[2 * k2 + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < HD / 16; ++n2) {
            uint32_t b[4];
            lds_b_kn<HD>(b, b_tile, n2 * 16, k2 * 16);
            hopper::mma_bf16(acc[2 * n2], a, b[0], b[1]);
            hopper::mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
        }
    }
}

// Writes the (16 x HD) fp32 accumulator of rows row0, row0 + 8 as bf16
// rows of a contiguous slab with row stride `ss`; rows >= len are dropped.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ss,
                                           const float (&acc)[HD / 8][4],
                                           int row0, int len) {
    const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < len) {
#pragma unroll
            for (int nb = 0; nb < HD / 8; ++nb)
                *reinterpret_cast<uint32_t*>(dst + row * ss + nb * 8 + col0) =
                    hopper::pack_bf16(acc[nb][2 * r], acc[nb][2 * r + 1]);
        }
    }
}

template <int HD>
struct DkdvSmem {
    static constexpr int K = 0;
    static constexpr int V = K + Tile<HD>::BYTES;
    static constexpr int Q = V + Tile<HD>::BYTES;       // two buffers
    static constexpr int DO = Q + 2 * Tile<HD>::BYTES;  // two buffers
    static constexpr int LSE = DO + 2 * Tile<HD>::BYTES;
    static constexpr int DELTA = LSE + 2 * BM * 4;
    static constexpr int TOTAL = DELTA + 2 * BM * 4;
};

// dk, dv for one (batch, KV head, 64-key tile), summed over the query heads
// of its group.  Warp w owns keys n0 + 16w ..: it computes the transposed
// scores s^T = k.q^T and dp^T = v.dout^T for each 64-row query tile, so
// p^T and ds^T are already the A operands of dv += p^T dout and
// dk += ds^T q, and no tile goes back through shared memory.  The next
// (head, query tile)'s q, dout, lse and delta load while this one computes.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 2) attn_bwd_dkdv_tc(Params p) {
    using SM = DkdvSmem<HD>;
    extern __shared__ __align__(16) uint8_t tc_smem[];
    const uint32_t base = hopper::smem_u32(tc_smem);
    float* lse_s = reinterpret_cast<float*>(tc_smem + SM::LSE);
    float* delta_s = reinterpret_cast<float*>(tc_smem + SM::DELTA);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int n0 = blockIdx.x * BN;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int G = p.Hq / p.Hkv;
    const long long o_ss = static_cast<long long>(p.Hq) * HD;
    const long long o_sb = static_cast<long long>(p.S) * o_ss;
    using bf16 = __nv_bfloat16;

    load_tile_async<HD>(base + SM::K,
                        static_cast<const bf16*>(p.k) + b * p.k_sb +
                            hk * p.k_sh,
                        p.k_ss, n0, p.T);
    load_tile_async<HD>(base + SM::V,
                        static_cast<const bf16*>(p.v) + b * p.v_sb +
                            hk * p.v_sh,
                        p.v_ss, n0, p.T);

    // Query tiles that can see this key tile, for each head of the group.
    const int m_begin = p.causal ? (n0 / BM) * BM : 0;
    const long long w_end = static_cast<long long>(n0) + BN - 1 + p.window;
    const int m_end =
        p.window > 0 && w_end < p.S ? static_cast<int>(w_end) : p.S;
    const int n_m = max(0, (m_end - m_begin + BM - 1) / BM);
    const int steps = G * n_m;

    // stage `it` = (head hk * G + it / n_m, query tile it % n_m) into buf
    auto stage = [&](int it, int buf) {
        const int h = hk * G + it / n_m;
        const int m0 = m_begin + (it % n_m) * BM;
        load_tile_async<HD>(base + SM::Q + buf * Tile<HD>::BYTES,
                            static_cast<const bf16*>(p.q) + b * p.q_sb +
                                h * p.q_sh,
                            p.q_ss, m0, p.S);
        load_tile_async<HD>(base + SM::DO + buf * Tile<HD>::BYTES,
                            static_cast<const bf16*>(p.dout) + b * o_sb +
                                h * HD,
                            o_ss, m0, p.S);
        if (tid < BM) {
            const long long row = static_cast<long long>(b * p.Hq + h) * p.S;
            const int s = m0 + tid;
            lse_s[buf * BM + tid] = s < p.S ? p.lse[row + s] * LOG2E : 0.f;
            delta_s[buf * BM + tid] = s < p.S ? p.delta[row + s] : 0.f;
        }
    };

    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

    if (steps > 0) stage(0, 0);
    hopper::cp_async_commit();
    const float scale_log2 = p.sm_scale * LOG2E;
    const int key0 = n0 + warp * 16 + lane / 4;  // and key0 + 8
    for (int it = 0; it < steps; ++it) {
        const int buf = it % 2;
        if (it + 1 < steps) stage(it + 1, buf ^ 1);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
        __syncthreads();

        const int m0 = m_begin + (it % n_m) * BM;
        const uint32_t q_t = base + SM::Q + buf * Tile<HD>::BYTES;
        const uint32_t do_t = base + SM::DO + buf * Tile<HD>::BYTES;
        const float* lse_b = lse_s + buf * BM;
        const float* delta_b = delta_s + buf * BM;

        // p^T (keys x queries)
        float pt[8][4];
        product_nt<HD>(pt, base + SM::K, warp * 16, q_t);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = key0 + 8 * (e / 2);
                const int c = j * 8 + 2 * (lane % 4) + e % 2;
                const int s = m0 + c;
                bool ok = s < p.S && t < p.T;
                if (p.causal) ok = ok && t <= s;
                if (p.window > 0) ok = ok && s - t < p.window;
                pt[j][e] = ok ? exp2f(pt[j][e] * scale_log2 - lse_b[c]) : 0.f;
            }
        product_nn<HD>(dv, pt, do_t);

        // ds^T = p^T (dp^T - delta) * scale
        float dpt[8][4];
        product_nt<HD>(dpt, base + SM::V, warp * 16, do_t);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = j * 8 + 2 * (lane % 4) + e % 2;
                dpt[j][e] = pt[j][e] * (dpt[j][e] - delta_b[c]) * p.sm_scale;
            }
        product_nn<HD>(dk, dpt, q_t);
        __syncthreads();  // buf is read; the next stage may overwrite it
    }
    hopper::cp_async_wait<0>();

    const long long g_ss = static_cast<long long>(p.Hkv) * HD;
    const long long g_sb = static_cast<long long>(p.T) * g_ss;
    store_rows<HD>(static_cast<bf16*>(p.dk) + b * g_sb + hk * HD, g_ss, dk,
                   key0, p.T);
    store_rows<HD>(static_cast<bf16*>(p.dv) + b * g_sb + hk * HD, g_ss, dv,
                   key0, p.T);
}

template <int HD>
struct DqSmem {
    static constexpr int Q = 0;
    static constexpr int DO = Q + Tile<HD>::BYTES;
    static constexpr int K = DO + Tile<HD>::BYTES;      // two buffers
    static constexpr int V = K + 2 * Tile<HD>::BYTES;   // two buffers
    static constexpr int LSE = V + 2 * Tile<HD>::BYTES;
    static constexpr int DELTA = LSE + BM * 4;
    static constexpr int TOTAL = DELTA + BM * 4;
};

// dq for one (batch, query head, 64-row query tile): warp w owns query rows
// q0 + 16w ..; the key tiles the forward visited stream through two
// buffers, the next loading while this one computes.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 2) attn_bwd_dq_tc(Params p) {
    using SM = DqSmem<HD>;
    extern __shared__ __align__(16) uint8_t tc_smem[];
    const uint32_t base = hopper::smem_u32(tc_smem);
    float* lse_s = reinterpret_cast<float*>(tc_smem + SM::LSE);
    float* delta_s = reinterpret_cast<float*>(tc_smem + SM::DELTA);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int q0 = blockIdx.x * BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (p.Hq / p.Hkv);
    const long long o_ss = static_cast<long long>(p.Hq) * HD;
    const long long o_sb = static_cast<long long>(p.S) * o_ss;
    using bf16 = __nv_bfloat16;

    load_tile_async<HD>(base + SM::Q,
                        static_cast<const bf16*>(p.q) + b * p.q_sb +
                            h * p.q_sh,
                        p.q_ss, q0, p.S);
    load_tile_async<HD>(base + SM::DO,
                        static_cast<const bf16*>(p.dout) + b * o_sb + h * HD,
                        o_ss, q0, p.S);
    if (tid < BM) {
        const long long row = static_cast<long long>(b * p.Hq + h) * p.S;
        const int s = q0 + tid;
        lse_s[tid] = s < p.S ? p.lse[row + s] * LOG2E : 0.f;
        delta_s[tid] = s < p.S ? p.delta[row + s] : 0.f;
    }
    const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

    // The key tiles the forward visited for this query tile.
    const int q_last = min(q0 + BM, p.S) - 1;
    const int n_end = p.causal ? min(p.T, q_last + 1) : p.T;
    const int n_begin =
        p.window > 0 ? (max(0, q0 - p.window + 1) / BN) * BN : 0;
    const int steps = max(0, (n_end - n_begin + BN - 1) / BN);

    auto stage = [&](int it, int buf) {
        const int k0 = n_begin + it * BN;
        load_tile_async<HD>(base + SM::K + buf * Tile<HD>::BYTES, kg, p.k_ss,
                            k0, p.T);
        load_tile_async<HD>(base + SM::V + buf * Tile<HD>::BYTES, vg, p.v_ss,
                            k0, p.T);
    };

    float dq[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

    if (steps > 0) stage(0, 0);
    hopper::cp_async_commit();
    const float scale_log2 = p.sm_scale * LOG2E;
    const int r0 = warp * 16 + lane / 4;  // this thread's rows r0, r0 + 8
    for (int it = 0; it < steps; ++it) {
        const int buf = it % 2;
        if (it + 1 < steps) stage(it + 1, buf ^ 1);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
        __syncthreads();

        const int k0 = n_begin + it * BN;
        const uint32_t k_t = base + SM::K + buf * Tile<HD>::BYTES;
        const uint32_t v_t = base + SM::V + buf * Tile<HD>::BYTES;
        float sc[8][4], dp[8][4];
        product_nt<HD>(sc, base + SM::Q, warp * 16, k_t);
        product_nt<HD>(dp, base + SM::DO, warp * 16, v_t);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = r0 + 8 * (e / 2);
                const int s = q0 + r;
                const int t = k0 + j * 8 + 2 * (lane % 4) + e % 2;
                bool ok = s < p.S && t < p.T;
                if (p.causal) ok = ok && t <= s;
                if (p.window > 0) ok = ok && s - t < p.window;
                const float pr =
                    ok ? exp2f(sc[j][e] * scale_log2 - lse_s[r]) : 0.f;
                sc[j][e] = pr * (dp[j][e] - delta_s[r]) * p.sm_scale;
            }
        product_nn<HD>(dq, sc, k_t);
        __syncthreads();  // buf is read; the next stage may overwrite it
    }
    hopper::cp_async_wait<0>();

    store_rows<HD>(static_cast<bf16*>(p.dq) + b * o_sb + h * HD, o_ss, dq,
                   q0 + r0, p.S);
}

template <int HD>
int launch(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    const long long threads =
        static_cast<long long>(p.B) * p.Hq * p.S * (HD / 8);
    cudaError_t err = cudaLaunchKernel(
        &attn_bwd_delta_tc<HD>,
        dim3(static_cast<unsigned>((threads + 255) / 256)), dim3(256), args,
        0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(&attn_bwd_dkdv_tc<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvSmem<HD>::TOTAL);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(&attn_bwd_dq_tc<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DqSmem<HD>::TOTAL);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernel(&attn_bwd_dkdv_tc<HD>,
                           dim3((p.T + BN - 1) / BN, p.Hkv, p.B),
                           dim3(NTHREADS), args, DkdvSmem<HD>::TOTAL, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernel(&attn_bwd_dq_tc<HD>,
                           dim3((p.S + BM - 1) / BM, p.Hq, p.B),
                           dim3(NTHREADS), args, DqSmem<HD>::TOTAL, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

int launch_hd(const Params& p, int hd, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<32>(p, stream);
        case 64: return launch<64>(p, stream);
        case 128: return launch<128>(p, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace tc


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
    return is_bf16 ? tc::launch_hd(p, hd, st)
                   : launch_hd_fma(p, hd, st);
}
