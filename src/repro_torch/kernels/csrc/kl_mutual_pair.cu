// Pair-weighted mutual-learning KL (the paper's Eq. 2 at vocabulary scale)
// for Hopper (sm_90a): a square and a pair kernel each way.
//
// The pair forward replaces src/repro/kernels/kl_mutual.py:68
// (`_kl_pair_kernel`, launched by `_kl_pair_forward` at :124):
//
//     out[i, b] = sum_j w[i, j] * KL(softmax(live_i / T) || softmax(fixed_j / T))
//
// for live (Kl, B, V) and fixed (Kg, B, V).  The square forward replaces
// :32 (`_kl_kernel`): the same sum for ONE tensor x (K, B, V), live = fixed,
// read once.  With w = (1 - I) / (K - 1) it is `_kl_kernel`; with the
// participation mask it is the DML round's Eq.-2 term, which the JAX
// training path computes by `_kl_pair_kernel` with fixed = stop_gradient(
// live) (:76-79), and which the wrapper sends here whenever fixed is live's
// storage viewed alike.  The backwards replace `_streaming_pair_bwd`
// (:178-232, plain JAX inside the custom_vjp at :235-256), the square one
// for that same call.
//
// Forwards: one block owns one row b and makes ONE streaming pass over V
// for all clients.  Each thread keeps, per client, a running max m and
// partition A = sum 2^{x c - m} in log2 units (c = log2(e) / T, so every
// exponential is one MUFU.EX2 of fma(x, c, -m)), and the cross accumulator
// T_ij = sum_v e_i (x_i - y_j) on the raw logits (the reference's
// (g_i - h_j) form, scaled by 1/T once at the end); then
//     KL_ij = (Z_j - Z_i) + T_ij / (T A_i),   Z = ln 2 (m + log2 A).
// The square kernel needs one exponential per client and element, keeps
// T_ij for i != j only, and takes x_i - x_j once for each pair i < j.  The
// 256 threads' states are merged (warp shuffles, then shared memory), and
// the logsumexps Z (natural log, units of logits / T) are written for the
// backward; the square kernel's lse serves both sides.
//
// Backwards: an elementwise pass over (b, v) that reads the saved Z's, out
// and the cotangent g_bar (Kl, B):
//     dlive[i]  = s g_bar_i p_i (R_i lp_i - sum_j w_ij lq_j - out_i)
//     dfixed[j] = -s (sum_i w_ij g_bar_i p_i - q_j sum_i w_ij g_bar_i)
// with s = 1/T, R_i = sum_j w_ij, lp/lq the live/fixed log-softmax and p/q
// their exponentials; dfixed only when asked for (the training path holds
// the fixed side constant).  One block owns one row b, streams it as the
// forwards do and writes the gradients at the same positions.  The per-row
// constants (BwdRow: s g_bar_i, s R_i, -s w_ij and
// kap_i = -R_i Z_i + sum_j w_ij Zf_j - out_i) go into registers once a
// block, so that on the raw logits an element costs
//     dlive_i = s g_bar_i 2^(x_i c - Z_i log2 e) (s R_i x_i - s sum_j w_ij y_j + kap_i):
// one MUFU.EX2 and K FMAs a live client.  The square kernel reads x once,
// takes y = x and leaves out the pairs i = j (KL_ii = 0 for every x), and
// writes dfixed of the same x from the same loads (q = p) when autograd
// asks for it.  dfixed is a uniform run-time flag, not a template argument
// (the library's 128 kernels are the build's long pole), computed in
// passes of its own after dlive's; the output packs of at most 4 clients
// (2 past 8 rows a tile) are held at a time, so every instance stays in
// registers.
//
// Loads are 16 bytes (8 bf16 or 4 fp32, `ld.global.nc`), neighbouring
// threads on neighbouring vectors, in full tiles of NTHREADS x NV vectors a
// client (NV = 2 for up to 4 client rows, else 1; kl_stream.cuh).  A tile
// takes one max and one rescale a client, then its elements run
// unpredicated.  The vectors after the last full tile go NTHREADS at a
// time under a mask, and the elements before the row's first 16-byte
// boundary (a view such as x[..., 1:]) and after its last vector one per
// thread, inside the same kernel.  The backwards store 16 bytes a client
// (`st.global.cs`) at the loads' positions.  Vector loads need every row
// of a row b (live, fixed, dlive, dfixed) at one 16-byte phase; where they
// are not (a contiguous tensor with B V not a multiple of 8, say) the same
// kernels are instantiated with one-element loads.  The client counts are
// template arguments, so every state lives in registers and no loop
// carries a client predicate: each kernel has one instance per K = 1..8
// (square) or N = 1..8 with Kl = Kg = N (pair).  A pair with Kl != Kg (past
// 8 clients, the wrapper's off-diagonal client blocks) runs the instance
// of N = max(Kl, Kg) with the shorter side's first row read again in the
// padded rows, whose results are not written or weighted: the same bytes,
// more instructions, off every training and serving path.  The wrapper
// cuts more than 8 clients into blocks.
//
// What bounds them on the H100: bytes.  At the DML round's shape (K = 3,
// B = 1024, V = 151,936, bf16) the square forward reads 0.93 GB (0.279 ms
// at 3.35 TB/s) and the pair forward 1.87 GB (0.557 ms); the square
// backward reads 0.93 GB and writes 0.93 GB (0.557 ms), the pair backward
// reads 1.87 GB and writes 0.93 GB (0.836 ms).  Per element they issue
// ~8-12 instructions and one MUFU.EX2 a client, ~0.13-0.2 ms of the SMs'
// issue and SFU rates for the square case's 4.7e8 elements.
// `chip_smoke.py` measures them there (NVIDIA H100 80GB HBM3, 700.00 W):
// the square forward at 89-92% of its byte bound and the pair forward at
// 90%; at (3, 2048, 50,280), where a row's start and merge weigh more,
// 83-87% and 86%.  The pair forward handed ONE tensor as live and fixed
// reads one plane but issues the pair's 2K exponentials and K^2 cross
// terms a position: 0.44 ms at the shape above against the square
// kernel's 0.30, which is why the square kernel takes that call.  The
// square backward takes 0.65 ms (86% of its bound; one read and one write
// of the plane by torch.mul, 0.61 ms) and 0.45 ms at (3, 2048, 50,280)
// (82%), the pair backward 0.94 ms (88%) and 0.64 ms (86%): up to 3
// clients a side, two blocks an SM (128 registers) hide each other's
// loads, which with the streaming stores took the square backward from
// 0.675 to 0.651 ms.

#include <type_traits>

#include "kl_stream.cuh"

namespace {

struct Params {
    const void* live;
    const void* fixed;
    const float* w;         // (Kl, Kg)
    float* out;             // (Kl, B)
    float* lse_live;        // (Kl, B)
    float* lse_fixed;       // (Kg, B)
    const float* gbar;      // (Kl, B), backward only
    void* dlive;            // (Kl, B, V), backward only
    void* dfixed;           // (Kg, B, V), backward only; may be null
    long long l_sk, l_sb;   // live strides: client, row (v has unit stride)
    long long f_sk, f_sb;   // fixed strides
    int Kl, Kg, B, V;
    float inv_temp;
};

// ---------------------------------------------------------------------------
// forward

// Square state: per client the running max m (log2 units), partition A and
// the cross sums t[i][j] = sum e_i (x_i - x_j) for j != i (t[i][i] unused).
template <int K>
struct SquareState {
    float m[K], a[K], t[K][K];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int i = 0; i < K; ++i) {
            m[i] = NEG_INF;
            a[i] = 0.f;
#pragma unroll
            for (int j = 0; j < K; ++j) t[i][j] = 0.f;
        }
    }

    // One tile of NV packs a client; MASKED (one pack): it counts only
    // when `ok`.
    template <typename T, bool VEC, int NV, bool MASKED>
    __device__ __forceinline__ void tile(const Pack<T, VEC> (&pk)[K][NV],
                                         bool ok, float c) {
        static_assert(!MASKED || NV == 1, "a masked tile is one pack");
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const float mx = fmaxf(
                m[i], tile_max<T, VEC, NV>(pk[i], !MASKED || ok, c));
            const float sc = fast_exp2(m[i] - mx);
            a[i] *= sc;
#pragma unroll
            for (int j = 0; j < K; ++j)
                if (j != i) t[i][j] *= sc;
            m[i] = mx;
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
#pragma unroll
            for (int e = 0; e < Pack<T, VEC>::W; ++e) {
                float x[K], ex[K];
#pragma unroll
                for (int i = 0; i < K; ++i) {
                    x[i] = elem(pk[i][n], e);
                    ex[i] = fast_exp2(fmaf(x[i], c, -m[i]));
                    if (MASKED && !ok) ex[i] = 0.f;
                    a[i] += ex[i];
                }
#pragma unroll
                for (int i = 0; i < K; ++i)
#pragma unroll
                    for (int j = i + 1; j < K; ++j) {
                        const float d = x[i] - x[j];
                        t[i][j] = fmaf(ex[i], d, t[i][j]);
                        t[j][i] = fmaf(-ex[j], d, t[j][i]);
                    }
            }
        }
    }

    __device__ __forceinline__ void merge(const SquareState& o) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const float mn = fmaxf(m[i], o.m[i]);
            const float s1 = fast_exp2(m[i] - mn), s2 = fast_exp2(o.m[i] - mn);
            a[i] = a[i] * s1 + o.a[i] * s2;
#pragma unroll
            for (int j = 0; j < K; ++j)
                if (j != i) t[i][j] = t[i][j] * s1 + o.t[i][j] * s2;
            m[i] = mn;
        }
    }

    __device__ __forceinline__ SquareState shfl_xor(int lane_mask) const {
        SquareState o;
#pragma unroll
        for (int i = 0; i < K; ++i) {
            o.m[i] = __shfl_xor_sync(0xffffffffu, m[i], lane_mask);
            o.a[i] = __shfl_xor_sync(0xffffffffu, a[i], lane_mask);
#pragma unroll
            for (int j = 0; j < K; ++j)
                o.t[i][j] = j == i ? 0.f
                    : __shfl_xor_sync(0xffffffffu, t[i][j], lane_mask);
        }
        return o;
    }
};

// Pair state: the live side's m, A and cross sums t[i][j] =
// sum e_i (x_i - y_j), and the fixed side's m and A.
template <int KL, int KG>
struct PairState {
    float m[KL], a[KL], mf[KG], af[KG], t[KL][KG];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int i = 0; i < KL; ++i) {
            m[i] = NEG_INF;
            a[i] = 0.f;
#pragma unroll
            for (int j = 0; j < KG; ++j) t[i][j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < KG; ++j) {
            mf[j] = NEG_INF;
            af[j] = 0.f;
        }
    }

    // One tile as SquareState's: the live rows' packs are pk[0..KL), the
    // fixed rows' pk[KL..KL+KG).
    template <typename T, bool VEC, int NV, bool MASKED>
    __device__ __forceinline__ void tile(
        const Pack<T, VEC> (&pk)[KL + KG][NV], bool ok, float c) {
        static_assert(!MASKED || NV == 1, "a masked tile is one pack");
#pragma unroll
        for (int i = 0; i < KL; ++i) {
            const float mx = fmaxf(
                m[i], tile_max<T, VEC, NV>(pk[i], !MASKED || ok, c));
            const float sc = fast_exp2(m[i] - mx);
            a[i] *= sc;
#pragma unroll
            for (int j = 0; j < KG; ++j) t[i][j] *= sc;
            m[i] = mx;
        }
#pragma unroll
        for (int j = 0; j < KG; ++j) {
            const float mx = fmaxf(
                mf[j], tile_max<T, VEC, NV>(pk[KL + j], !MASKED || ok, c));
            af[j] *= fast_exp2(mf[j] - mx);
            mf[j] = mx;
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
#pragma unroll
            for (int e = 0; e < Pack<T, VEC>::W; ++e) {
                float x[KL], ex[KL], y[KG];
#pragma unroll
                for (int i = 0; i < KL; ++i) {
                    x[i] = elem(pk[i][n], e);
                    ex[i] = fast_exp2(fmaf(x[i], c, -m[i]));
                    if (MASKED && !ok) ex[i] = 0.f;
                    a[i] += ex[i];
                }
#pragma unroll
                for (int j = 0; j < KG; ++j) {
                    y[j] = elem(pk[KL + j][n], e);
                    float ey = fast_exp2(fmaf(y[j], c, -mf[j]));
                    if (MASKED && !ok) ey = 0.f;
                    af[j] += ey;
                }
#pragma unroll
                for (int i = 0; i < KL; ++i)
#pragma unroll
                    for (int j = 0; j < KG; ++j)
                        t[i][j] = fmaf(ex[i], x[i] - y[j], t[i][j]);
            }
        }
    }

    __device__ __forceinline__ void merge(const PairState& o) {
#pragma unroll
        for (int i = 0; i < KL; ++i) {
            const float mn = fmaxf(m[i], o.m[i]);
            const float s1 = fast_exp2(m[i] - mn), s2 = fast_exp2(o.m[i] - mn);
            a[i] = a[i] * s1 + o.a[i] * s2;
#pragma unroll
            for (int j = 0; j < KG; ++j) t[i][j] = t[i][j] * s1 + o.t[i][j] * s2;
            m[i] = mn;
        }
#pragma unroll
        for (int j = 0; j < KG; ++j) {
            const float mn = fmaxf(mf[j], o.mf[j]);
            af[j] = af[j] * fast_exp2(mf[j] - mn) + o.af[j] * fast_exp2(o.mf[j] - mn);
            mf[j] = mn;
        }
    }

    __device__ __forceinline__ PairState shfl_xor(int lane_mask) const {
        PairState o;
#pragma unroll
        for (int i = 0; i < KL; ++i) {
            o.m[i] = __shfl_xor_sync(0xffffffffu, m[i], lane_mask);
            o.a[i] = __shfl_xor_sync(0xffffffffu, a[i], lane_mask);
#pragma unroll
            for (int j = 0; j < KG; ++j)
                o.t[i][j] = __shfl_xor_sync(0xffffffffu, t[i][j], lane_mask);
        }
#pragma unroll
        for (int j = 0; j < KG; ++j) {
            o.mf[j] = __shfl_xor_sync(0xffffffffu, mf[j], lane_mask);
            o.af[j] = __shfl_xor_sync(0xffffffffu, af[j], lane_mask);
        }
        return o;
    }
};

// Merges the block's states into thread 0's; returns whether this thread
// is thread 0.
template <class S>
__device__ __forceinline__ bool block_merge(S& st) {
    __shared__ S warp_states[NWARPS];
    for (int lane_mask = 16; lane_mask > 0; lane_mask /= 2)
        st.merge(st.shfl_xor(lane_mask));
    const int tid = threadIdx.x;
    if (tid % 32 == 0) warp_states[tid / 32] = st;
    __syncthreads();
    if (tid != 0) return false;
    for (int w = 1; w < NWARPS; ++w) st.merge(warp_states[w]);
    return true;
}

// The client rows of one row b: rows 0..KL-1 are live's, KL.. fixed's.  A
// side with fewer than KL (live) or than the rest (fixed) clients, kl or
// kg, repeats its first row in the rows past them.
template <typename T, int KL>
struct Rows {
    const T* live;
    const T* fixed;
    long long l_sk, f_sk;
    int kl, kg;

    __device__ __forceinline__ const T* operator()(int r) const {
        return r < KL ? live + (r < kl ? r : 0) * l_sk
                      : fixed + (r - KL < kg ? r - KL : 0) * f_sk;
    }
};

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1) kl_square_fwd(Params p) {
    constexpr int NV = packs_per_tile<VEC, K>();
    const int b = blockIdx.x;
    const float c = LOG2E * p.inv_temp;
    const T* x = static_cast<const T*>(p.live) + b * p.l_sb;
    const Rows<T, K> rows{x, x, p.l_sk, p.l_sk, K, K};

    SquareState<K> st;
    st.init();
    stream_row<T, VEC, K, NV>(
        rows, p.V,
        [&](const Pack<T, VEC> (&pk)[K][NV], int) {
            st.template tile<T, VEC, NV, false>(pk, true, c);
        },
        [&](const Pack<T, VEC> (&pk)[K][1], bool ok, int) {
            st.template tile<T, VEC, 1, true>(pk, ok, c);
        },
        [&](const Pack<T, false> (&pk)[K][1], bool ok, int) {
            st.template tile<T, false, 1, true>(pk, ok, c);
        });
    if (!block_merge(st)) return;

    float z[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
        z[i] = LN2 * (st.m[i] + log2f(st.a[i]));
        p.lse_live[static_cast<long long>(i) * p.B + b] = z[i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const float s = p.inv_temp / st.a[i];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j)
            if (j != i)
                acc += p.w[i * K + j] * ((z[j] - z[i]) + st.t[i][j] * s);
        p.out[static_cast<long long>(i) * p.B + b] = acc;
    }
}

// N clients a side, of which p.Kl live and p.Kg fixed are real (Rows pads
// the others); only the real ones are weighted and written.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1) kl_pair_fwd(Params p) {
    constexpr int NV = packs_per_tile<VEC, 2 * N>();
    const int b = blockIdx.x;
    const float c = LOG2E * p.inv_temp;
    const Rows<T, N> rows{static_cast<const T*>(p.live) + b * p.l_sb,
                          static_cast<const T*>(p.fixed) + b * p.f_sb,
                          p.l_sk, p.f_sk, p.Kl, p.Kg};

    PairState<N, N> st;
    st.init();
    stream_row<T, VEC, 2 * N, NV>(
        rows, p.V,
        [&](const Pack<T, VEC> (&pk)[2 * N][NV], int) {
            st.template tile<T, VEC, NV, false>(pk, true, c);
        },
        [&](const Pack<T, VEC> (&pk)[2 * N][1], bool ok, int) {
            st.template tile<T, VEC, 1, true>(pk, ok, c);
        },
        [&](const Pack<T, false> (&pk)[2 * N][1], bool ok, int) {
            st.template tile<T, false, 1, true>(pk, ok, c);
        });
    if (!block_merge(st)) return;

    float zf[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
        zf[j] = LN2 * (st.mf[j] + log2f(st.af[j]));
        if (j < p.Kg) p.lse_fixed[static_cast<long long>(j) * p.B + b] = zf[j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if (i < p.Kl) {
            const float z = LN2 * (st.m[i] + log2f(st.a[i]));
            const float s = p.inv_temp / st.a[i];
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < N; ++j)
                if (j < p.Kg)
                    acc += p.w[i * p.Kg + j] * ((zf[j] - z) + st.t[i][j] * s);
            p.out[static_cast<long long>(i) * p.B + b] = acc;
            p.lse_live[static_cast<long long>(i) * p.B + b] = z;
        }
    }
}

// ---------------------------------------------------------------------------
// backward

// The per-row constants of the backward for KL live and KG fixed rows, in
// registers once per block.  With s = 1/T, the live side's gradient is
//     dlive_i = gs_i p_i (rs_i x_i + sum_j nws_ij y_j + kap_i),
// gs_i = s g_bar_i, rs_i = s R_i, nws_ij = -s w_ij and the per-row constant
// kap_i = -R_i Z_i + sum_j w_ij Zf_j - out_i, which is
// s g_bar_i p_i (R_i lp_i - sum_j w_ij lq_j - out_i) on the raw logits x
// (live) and y (fixed).  The fixed side's is
//     dfixed_j = T (col_j q_j + sum_i nws_ij gs_i p_i),
// col_j = s^2 sum_i w_ij g_bar_i.  p_i = 2^(x_i c - zl_i), c = log2(e) s,
// zl_i = Z_i log2(e); q likewise from y and zfl.  The square case has y = x
// and q = p, and leaves out the pairs i = j, whose KL is 0 for every x.
template <int KL, int KG>
struct BwdRow {
    float gs[KL], rs[KL], kap[KL], zl[KL];
    float zfl[KG], col[KG];
    float nws[KL][KG];

    // The rows past p.Kl (live) and p.Kg (fixed) are padding (weight 0, and
    // row 0's Z, since Rows reads row 0 again there).  SQUARE: fixed is
    // live (p.lse_fixed is p.lse_live), and the pairs i = j are left out.
    template <bool SQUARE>
    __device__ __forceinline__ void load(const Params& p, int b) {
        const float s = p.inv_temp;
        float z[KL], zf[KG];
#pragma unroll
        for (int j = 0; j < KG; ++j) {
            zf[j] = p.lse_fixed[static_cast<long long>(j < p.Kg ? j : 0) * p.B
                                + b];
            zfl[j] = zf[j] * LOG2E;
            col[j] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < KL; ++i) {
            const bool real = i < p.Kl;
            const long long o = static_cast<long long>(real ? i : 0) * p.B + b;
            z[i] = p.lse_live[o];
            zl[i] = z[i] * LOG2E;
            gs[i] = real ? s * p.gbar[o] : 0.f;
            float r = 0.f, k = real ? -p.out[o] : 0.f;
#pragma unroll
            for (int j = 0; j < KG; ++j) {
                const bool on = real && j < p.Kg && !(SQUARE && j == i);
                const float w = on ? p.w[i * p.Kg + j] : 0.f;
                r += w;
                k = fmaf(w, zf[j], k);
                nws[i][j] = -s * w;
                col[j] = fmaf(w, gs[i], col[j]);
            }
            rs[i] = s * r;
            kap[i] = fmaf(-r, z[i], k);
        }
#pragma unroll
        for (int j = 0; j < KG; ++j) col[j] *= s;
    }
};

// Clients whose output packs one pass holds: 4, or 2 past 8 rows a tile,
// so that the 8-client pair kernels stay in registers.
template <int R>
__host__ __device__ constexpr int out_clients() {
    return R > 8 ? 2 : 4;
}

// dlive of live clients i0 .. i0 + OC - 1 (those below KL) at pack position
// n: pk[0..KL) are the live rows' packs, pk[KL..KL+KG) the fixed rows' (the
// square case passes KG = 0 and takes y = x).
template <int KL, int KG, int OC, typename T, bool VEC, int R, int NV>
__device__ __forceinline__ void dlive_pack(
    const Pack<T, VEC> (&pk)[R][NV], int n, int i0,
    const BwdRow<KL, KG ? KG : KL>& k, float c, Pack<T, VEC> (&dl)[OC]) {
    constexpr bool SQUARE = KG == 0;
    constexpr int NF = SQUARE ? KL : KG;
#pragma unroll
    for (int e = 0; e < Pack<T, VEC>::W; ++e) {
        float y[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) y[j] = elem(pk[SQUARE ? j : KL + j][n], e);
#pragma unroll
        for (int ii = 0; ii < OC; ++ii) {
            const int i = i0 + ii;
            if (i >= KL) break;
            const float x = SQUARE ? y[i] : elem(pk[i][n], e);
            const float pr = fast_exp2(fmaf(x, c, -k.zl[i]));
            float t = fmaf(k.rs[i], x, k.kap[i]);
#pragma unroll
            for (int j = 0; j < NF; ++j)
                if (!SQUARE || j != i) t = fmaf(k.nws[i][j], y[j], t);
            set_elem(dl[ii], e, k.gs[i] * pr * t);
        }
    }
}

// dfixed of fixed clients j0 .. j0 + OC - 1 at pack position n, as
// dlive_pack; in passes of their own, after dlive's.
template <int KL, int KG, int OC, typename T, bool VEC, int R, int NV>
__device__ __forceinline__ void dfixed_pack(
    const Pack<T, VEC> (&pk)[R][NV], int n, int j0,
    const BwdRow<KL, KG ? KG : KL>& k, float c, float temp,
    Pack<T, VEC> (&df)[OC]) {
    constexpr bool SQUARE = KG == 0;
    constexpr int NF = SQUARE ? KL : KG;
#pragma unroll
    for (int e = 0; e < Pack<T, VEC>::W; ++e) {
        float gp[KL];                   // s g_bar_i p_i
#pragma unroll
        for (int i = 0; i < KL; ++i)
            gp[i] = k.gs[i]
                    * fast_exp2(fmaf(elem(pk[i][n], e), c, -k.zl[i]));
#pragma unroll
        for (int jj = 0; jj < OC; ++jj) {
            const int j = j0 + jj;
            if (j >= NF) break;
            const float y = elem(pk[SQUARE ? j : KL + j][n], e);
            float t = k.col[j] * fast_exp2(fmaf(y, c, -k.zfl[j]));
#pragma unroll
            for (int i = 0; i < KL; ++i)
                if (!SQUARE || i != j) t = fmaf(k.nws[i][j], gp[i], t);
            set_elem(df[jj], e, temp * t);
        }
    }
}

// Blocks of the backward an SM must hold at once: two (at most 128
// registers a thread) for up to 3 clients a side, where the registers
// allow it without spilling and the second block's loads hide the
// first's; one above.
__host__ __device__ constexpr int bwd_blocks(int clients) {
    return clients <= 3 ? 2 : 1;
}

// One row b of the backward for KL live rows (and KG fixed rows, 0 in the
// square case): streams the rows as the forward does and writes dlive (and
// dfixed) at the same positions, rows at or past kl (kg) left unwritten.
template <typename T, bool VEC, int KL, int KG, class RowsT>
__device__ __forceinline__ void bwd_row(const Params& p, const RowsT& rows,
                                        const BwdRow<KL, KG ? KG : KL>& k,
                                        int kl, int kg) {
    constexpr int NF = KG ? KG : KL;
    constexpr int R = KL + KG;
    constexpr int NV = packs_per_tile<VEC, R>();
    constexpr int OC = out_clients<R>();
    constexpr int W = Pack<T, VEC>::W;
    const int b = blockIdx.x;
    const float c = LOG2E * p.inv_temp, temp = 1.f / p.inv_temp;
    const bool want_fixed = p.dfixed != nullptr;
    const long long plane = static_cast<long long>(p.B) * p.V;
    T* dl = static_cast<T*>(p.dlive) + static_cast<long long>(b) * p.V;
    T* df = want_fixed
        ? static_cast<T*>(p.dfixed) + static_cast<long long>(b) * p.V
        : nullptr;

    // writes the gradients of pack n of `pk` at element v of each row, OC
    // rows at a time
    auto emit = [&](const auto& pk, int n, int v) {
        std::decay_t<decltype(pk[0][0])> g[OC];
#pragma unroll
        for (int i0 = 0; i0 < KL; i0 += OC) {
            dlive_pack<KL, KG, OC>(pk, n, i0, k, c, g);
#pragma unroll
            for (int ii = 0; ii < OC && i0 + ii < KL; ++ii)
                if (KG == 0 || i0 + ii < kl)
                    store_pack(dl + (i0 + ii) * plane + v, g[ii]);
        }
        if (want_fixed) {
#pragma unroll
            for (int j0 = 0; j0 < NF; j0 += OC) {
                dfixed_pack<KL, KG, OC>(pk, n, j0, k, c, temp, g);
#pragma unroll
                for (int jj = 0; jj < OC && j0 + jj < NF; ++jj)
                    if (KG == 0 || j0 + jj < kg)
                        store_pack(df + (j0 + jj) * plane + v, g[jj]);
            }
        }
    };
    stream_row<T, VEC, R, NV>(
        rows, p.V,
        [&](const Pack<T, VEC> (&pk)[R][NV], int v) {
#pragma unroll
            for (int n = 0; n < NV; ++n) emit(pk, n, v + n * NTHREADS * W);
        },
        [&](const Pack<T, VEC> (&pk)[R][1], bool ok, int v) {
            if (ok) emit(pk, 0, v);
        },
        [&](const Pack<T, false> (&pk)[R][1], bool ok, int v) {
            if (ok) emit(pk, 0, v);
        });
}

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(NTHREADS, bwd_blocks(K))
    kl_square_bwd(Params p) {
    const T* x = static_cast<const T*>(p.live) + blockIdx.x * p.l_sb;
    BwdRow<K, K> k;
    k.template load<true>(p, blockIdx.x);
    bwd_row<T, VEC, K, 0>(p, Rows<T, K>{x, x, p.l_sk, p.l_sk, K, K}, k, K,
                          K);
}

// N rows a side, of which p.Kl live and p.Kg fixed are real.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(NTHREADS, bwd_blocks(N))
    kl_pair_bwd(Params p) {
    const int b = blockIdx.x;
    BwdRow<N, N> k;
    k.template load<false>(p, b);
    bwd_row<T, VEC, N, N>(
        p,
        Rows<T, N>{static_cast<const T*>(p.live) + b * p.l_sb,
                   static_cast<const T*>(p.fixed) + b * p.f_sb, p.l_sk,
                   p.f_sk, p.Kl, p.Kg},
        k, p.Kl, p.Kg);
}

// ---------------------------------------------------------------------------
// launch

// The instantiation for runtime client counts 1..8: F<N>::run(...) for
// N = n.
template <template <int> class F, class... A>
int by_count(int n, A... a) {
    switch (n) {
        case 1: return F<1>::run(a...);
        case 2: return F<2>::run(a...);
        case 3: return F<3>::run(a...);
        case 4: return F<4>::run(a...);
        case 5: return F<5>::run(a...);
        case 6: return F<6>::run(a...);
        case 7: return F<7>::run(a...);
        case 8: return F<8>::run(a...);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// One block a row b, for every kernel here.
template <typename T, bool VEC, bool SQUARE, bool BWD>
struct Kernel {
    template <int N>
    struct Of {
        static int run(Params p, cudaStream_t s) {
            void (*kernel)(Params);
            if constexpr (SQUARE)
                kernel = BWD ? &kl_square_bwd<T, N, VEC>
                             : &kl_square_fwd<T, N, VEC>;
            else
                kernel = BWD ? &kl_pair_bwd<T, N, VEC>
                             : &kl_pair_fwd<T, N, VEC>;
            void* args[] = {&p};
            return launched(cudaLaunchKernel(kernel, dim3(p.B),
                                             dim3(NTHREADS), args, 0, s));
        }
    };
};

template <typename T, bool SQUARE, bool BWD>
int launch(Params p, bool vec, cudaStream_t s) {
    const int n = p.Kl > p.Kg ? p.Kl : p.Kg;
    return vec ? by_count<Kernel<T, true, SQUARE, BWD>::template Of>(n, p, s)
               : by_count<Kernel<T, false, SQUARE, BWD>::template Of>(n, p,
                                                                      s);
}

// Whether a stride of `elems` elements keeps the 16-byte phase.
bool keeps_phase(long long elems, int esize) {
    return ((static_cast<unsigned long long>(elems) * esize) & 15ull) == 0;
}

// Whether every row (k, b) of the K client rows at `a` (strides sk, sb)
// starts at the 16-byte phase of live's row b (live at `ref`, row stride
// ref_sb).
bool in_phase(const void* a, long long sk, long long sb, int K,
              const void* ref, long long ref_sb, int B, int es) {
    const unsigned long long base =
        reinterpret_cast<unsigned long long>(a)
        - reinterpret_cast<unsigned long long>(ref);
    return keeps_phase(static_cast<long long>(base), 1) && (K == 1 || keeps_phase(sk, es))
           && (B == 1 || keeps_phase(sb - ref_sb, es));
}

// Launches the square or pair forward (BWD false) or backward on p.
// Vector loads and stores when every live, fixed, dlive and dfixed row of
// a row b shares one 16-byte phase; else the one-element instances.
int run(Params p, bool square, bool bwd, int is_bf16, void* stream) {
    const int es = is_bf16 ? 2 : 4;
    const long long plane = static_cast<long long>(p.B) * p.V;
    bool vec = in_phase(p.live, p.l_sk, p.l_sb, p.Kl, p.live, p.l_sb, p.B, es)
               && in_phase(p.fixed, p.f_sk, p.f_sb, p.Kg, p.live, p.l_sb,
                           p.B, es);
    if (bwd) {
        vec = vec && in_phase(p.dlive, plane, p.V, p.Kl, p.live, p.l_sb,
                              p.B, es);
        if (p.dfixed != nullptr)
            vec = vec && in_phase(p.dfixed, plane, p.V, p.Kg, p.live, p.l_sb,
                                  p.B, es);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        using T = __nv_bfloat16;
        if (square)
            return bwd ? launch<T, true, true>(p, vec, st)
                       : launch<T, true, false>(p, vec, st);
        return bwd ? launch<T, false, true>(p, vec, st)
                   : launch<T, false, false>(p, vec, st);
    }
    if (square)
        return bwd ? launch<float, true, true>(p, vec, st)
                   : launch<float, true, false>(p, vec, st);
    return bwd ? launch<float, false, true>(p, vec, st)
               : launch<float, false, false>(p, vec, st);
}

Params make_params(const void* live, const void* fixed, const void* w,
                   long long l_sk, long long l_sb, long long f_sk,
                   long long f_sb, int Kl, int Kg, int B, int V,
                   float inv_temp) {
    Params p = {};
    p.live = live;
    p.fixed = fixed;
    p.w = static_cast<const float*>(w);
    p.l_sk = l_sk; p.l_sb = l_sb;
    p.f_sk = f_sk; p.f_sb = f_sb;
    p.Kl = Kl;
    p.Kg = Kg;
    p.B = B;
    p.V = V;
    p.inv_temp = inv_temp;
    return p;
}

}  // namespace

// Every entry returns the first CUDA error (0 on success).  The caller has
// checked shapes (client counts <= 8), dtypes, devices and strides; the
// gradients dlive (Kl, B, V) and dfixed (Kg, B, V) are contiguous in the
// input dtype.

// Square forward: x (K, B, V), live = fixed; writes out (K, B) and lse
// (K, B), the logsumexp of both sides.
extern "C" int kl_mutual_square_fwd(
    const void* x, const void* w, void* out, void* lse, long long sk,
    long long sb, int K, int B, int V, float inv_temp, int is_bf16,
    void* stream) {
    Params p = make_params(x, x, w, sk, sb, sk, sb, K, K, B, V, inv_temp);
    p.out = static_cast<float*>(out);
    p.lse_live = p.lse_fixed = static_cast<float*>(lse);
    return run(p, true, false, is_bf16, stream);
}

// Pair forward: writes out, lse_live and lse_fixed.
extern "C" int kl_mutual_pair_fwd(
    const void* live, const void* fixed, const void* w, void* out,
    void* lse_live, void* lse_fixed,
    long long l_sk, long long l_sb, long long f_sk, long long f_sb,
    int Kl, int Kg, int B, int V, float inv_temp, int is_bf16,
    void* stream) {
    Params p = make_params(live, fixed, w, l_sk, l_sb, f_sk, f_sb, Kl, Kg, B,
                           V, inv_temp);
    p.out = static_cast<float*>(out);
    p.lse_live = static_cast<float*>(lse_live);
    p.lse_fixed = static_cast<float*>(lse_fixed);
    return run(p, false, false, is_bf16, stream);
}

// Square backward, after the square forward on x: reads its out and lse
// once; writes dlive and, when dfixed is not null, dfixed (the gradient of
// the same x as the fixed side).
extern "C" int kl_mutual_square_bwd(
    const void* x, const void* w, const void* out, const void* gbar,
    const void* lse, void* dlive, void* dfixed, long long sk, long long sb,
    int K, int B, int V, float inv_temp, int is_bf16, void* stream) {
    Params p = make_params(x, x, w, sk, sb, sk, sb, K, K, B, V, inv_temp);
    p.out = const_cast<float*>(static_cast<const float*>(out));
    p.gbar = static_cast<const float*>(gbar);
    p.lse_live = p.lse_fixed =
        const_cast<float*>(static_cast<const float*>(lse));
    p.dlive = dlive;
    p.dfixed = dfixed;
    return run(p, true, true, is_bf16, stream);
}

// Pair backward: writes dlive and, when dfixed is not null, dfixed.
extern "C" int kl_mutual_pair_bwd(
    const void* live, const void* fixed, const void* w, const void* out,
    const void* gbar, const void* lse_live, const void* lse_fixed,
    void* dlive, void* dfixed,
    long long l_sk, long long l_sb, long long f_sk, long long f_sb,
    int Kl, int Kg, int B, int V, float inv_temp, int is_bf16,
    void* stream) {
    Params p = make_params(live, fixed, w, l_sk, l_sb, f_sk, f_sb, Kl, Kg, B,
                           V, inv_temp);
    p.out = const_cast<float*>(static_cast<const float*>(out));
    p.gbar = static_cast<const float*>(gbar);
    p.lse_live = const_cast<float*>(static_cast<const float*>(lse_live));
    p.lse_fixed = const_cast<float*>(static_cast<const float*>(lse_fixed));
    p.dlive = dlive;
    p.dfixed = dfixed;
    return run(p, false, true, is_bf16, stream);
}
