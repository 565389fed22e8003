// Flash-attention forward for Hopper (sm_90a): causal GQA attention with an
// optional sliding window, emitting the output and the per-row logsumexp.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_attn_kernel`, launched by `_flash_forward` at :91).  It computes what
// that kernel computes -- not its grid: one block owns one (batch, query
// head, 64-row query tile) and loops over the key tiles that tile can reach
// (lower bound from the window, upper bound from causality), carrying the
// online-softmax state (running max m, running sum l, fp32 accumulator) in
// registers.  Query head h reads KV head h / (Hq / Hkv).  Scores, max, sum
// and accumulator are fp32; out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)), as at flash_attention.py:85-88.  Keys at
// positions >= T are masked here, so padding never relies on causality.
//
// Layout: q (B, S, Hq, hd), k/v (B, T, Hkv, hd) with arbitrary batch, sequence
// and head strides and a unit stride on hd, so q/k/v may be slices of the
// fused QKV projection.  out is a contiguous (B, S, Hq, hd) tensor of the
// input type; lse is a contiguous fp32 (B, Hq, S) tensor.
//
// What bounds it on the H100: at the full-width qwen3-4b heads (Hq 32,
// Hkv 8, hd 128) causal attention does 4 * hd flops per unmasked (query,
// key) pair, S^2/2 pairs per head, against q, k, v and out moved once: about
// 0.4 * S flop per byte in bf16.  At the serving prompts (S = 512, 205
// flop/byte) that is under the card's 295 flop/byte ridge, so HBM bytes
// bound it, with the tensor-core bound (989 TFLOP/s) close behind; from
// S ~ 740 up the tensor cores bound it.  This first version reaches for
// neither: scores and P.V are fp32 FMAs from shared-memory tiles (a 4x4
// score and a 4 x hd/16 output micro-tile per thread), which keeps one code
// path exact for both fp32 and bf16 inputs.  It reads each q tile once and
// skips the key tiles that are fully masked, which halves the causal work.
// mma/wgmma, TMA and warp specialisation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16 threads; 4 per softmax row
constexpr float NEG_INF = -1e30f;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    float* lse;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    int S, T, Hq, Hkv;
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

// Shared-memory plan, in floats.  Rows are padded by one float so that the
// column walks of the score and P.V loops hit distinct banks.
template <int HD>
struct Smem {
    static constexpr int LD = HD + 1;   // q/k/v tile row stride
    static constexpr int LDP = BN + 1;  // score/probability tile row stride
    static constexpr int Q = 0;
    static constexpr int K = Q + BM * LD;
    static constexpr int V = K + BN * LD;
    static constexpr int P = V + BN * LD;
    static constexpr int ALPHA = P + BM * LDP;
    static constexpr int M = ALPHA + BM;
    static constexpr int L = M + BM;
    static constexpr int TOTAL = L + BM;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) attn_fwd(Params p) {
    using SM = Smem<HD>;
    constexpr int LD = SM::LD;
    constexpr int LDP = SM::LDP;
    constexpr int CN = HD / 16;  // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem + SM::Q;
    float* Ks = smem + SM::K;
    float* Vs = smem + SM::V;
    float* Ps = smem + SM::P;
    float* row_alpha = smem + SM::ALPHA;
    float* row_m = smem + SM::M;
    float* row_l = smem + SM::L;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (p.Hq / p.Hkv);

    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

    for (int i = tid; i < BM * HD; i += NTHREADS) {
        const int r = i / HD, d = i % HD;
        const int s = q0 + r;
        Qs[r * LD + d] = s < p.S ? load_f(qg + s * p.q_ss + d) : 0.f;
    }

    // Key tiles this query tile can reach.
    const int q_last = min(q0 + BM, p.S) - 1;
    const int n_end = p.causal ? min(p.T, q_last + 1) : p.T;
    const int n_begin =
        p.window > 0 ? (max(0, q0 - p.window + 1) / BN) * BN : 0;

    const int rg = tid / 16, cg = tid % 16;  // score / P.V micro-tiles
    const int sr = tid / 4, sl = tid % 4;    // softmax: row, quarter
    const int sq = q0 + sr;                  // query position of that row

    float m_run = NEG_INF, l_run = 0.f;
    float acc[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

    for (int n0 = n_begin; n0 < n_end; n0 += BN) {
        __syncthreads();  // the previous tile's readers are done
        for (int i = tid; i < BN * HD; i += NTHREADS) {
            const int c = i / HD, d = i % HD;
            const int t = n0 + c;
            const bool ok = t < p.T;
            Ks[c * LD + d] = ok ? load_f(kg + t * p.k_ss + d) : 0.f;
            Vs[c * LD + d] = ok ? load_f(vg + t * p.v_ss + d) : 0.f;
        }
        __syncthreads();

        // scores: rows rg*4+i, keys cg+16*j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int d = 0; d < HD; ++d) {
            float qa[4], kb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = Qs[(rg * 4 + i) * LD + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kb[j] = Ks[(cg + 16 * j) * LD + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                Ps[(rg * 4 + i) * LDP + cg + 16 * j] = s[i][j] * p.sm_scale;
        __syncthreads();

        // online softmax: four threads per row, sixteen keys each
        float x[16];
        unsigned valid = 0u;
        float mt = NEG_INF;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int c = sl * 16 + j;
            const int t = n0 + c;
            bool ok = t < p.T;
            if (p.causal) ok = ok && t <= sq;
            if (p.window > 0) ok = ok && sq - t < p.window;
            x[j] = Ps[sr * LDP + c];
            if (ok) {
                valid |= 1u << j;
                mt = fmaxf(mt, x[j]);
            }
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m_run, mt);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const float e = ((valid >> j) & 1u) ? expf(x[j] - m_new) : 0.f;
            Ps[sr * LDP + sl * 16 + j] = e;
            ls += e;
        }
        ls += __shfl_xor_sync(0xffffffffu, ls, 1);
        ls += __shfl_xor_sync(0xffffffffu, ls, 2);
        const float alpha = expf(m_run - m_new);
        l_run = l_run * alpha + ls;
        m_run = m_new;
        if (sl == 0) row_alpha[sr] = alpha;
        __syncthreads();

        // acc = acc * alpha + P . V
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float a = row_alpha[rg * 4 + i];
#pragma unroll
            for (int j = 0; j < CN; ++j) acc[i][j] *= a;
        }
        for (int c = 0; c < BN; ++c) {
            float pr[4], vv[CN];
#pragma unroll
            for (int i = 0; i < 4; ++i) pr[i] = Ps[(rg * 4 + i) * LDP + c];
#pragma unroll
            for (int j = 0; j < CN; ++j) vv[j] = Vs[c * LD + cg + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < CN; ++j)
                    acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
        }
    }

    if (sl == 0) {
        row_m[sr] = m_run;
        row_l[sr] = l_run;
    }
    __syncthreads();

    T* og = static_cast<T*>(p.out);
    const long long o_ss = static_cast<long long>(p.Hq) * HD;
    const long long o_sb = static_cast<long long>(p.S) * o_ss;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const int s = q0 + r;
        if (s < p.S) {
            const float denom = fmaxf(row_l[r], 1e-30f);
            T* orow = og + b * o_sb + s * o_ss + h * HD;
#pragma unroll
            for (int j = 0; j < CN; ++j)
                store_f(orow + cg + 16 * j, acc[i][j] / denom);
        }
    }
    if (tid < BM && q0 + tid < p.S) {
        const long long row = static_cast<long long>(b * p.Hq + h) * p.S;
        p.lse[row + q0 + tid] =
            row_m[tid] + logf(fmaxf(row_l[tid], 1e-30f));
    }
}

template <typename T, int HD>
int launch(Params p, int B, cudaStream_t stream) {
    const int smem_bytes = Smem<HD>::TOTAL * static_cast<int>(sizeof(float));
    const void* fn = reinterpret_cast<const void*>(&attn_fwd<T, HD>);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.S + BM - 1) / BM, p.Hq, B);
    void* args[] = {&p};
    err = cudaLaunchKernel(fn, grid, dim3(NTHREADS), args, smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<T, 32>(p, B, stream);
        case 64: return launch<T, 64>(p, B, stream);
        case 128: return launch<T, 128>(p, B, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  The caller has checked shapes, dtypes, devices and strides.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
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
    p.lse = static_cast<float*>(lse);
    p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
    p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
    p.S = S;
    p.T = T;
    p.Hq = Hq;
    p.Hkv = Hkv;
    p.causal = causal;
    p.window = window;
    p.sm_scale = sm_scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_hd<__nv_bfloat16>(p, B, hd, st)
                   : launch_hd<float>(p, B, hd, st);
}
