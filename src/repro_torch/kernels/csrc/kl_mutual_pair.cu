// Pair-weighted mutual-learning KL (the paper's Eq. 2 at vocabulary scale)
// for Hopper (sm_90a): two forward kernels and a backward.
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
// storage viewed alike.
//
// Both forwards: one block owns one row b and makes ONE streaming pass over
// V for all clients.  Each thread keeps, per client, a running max m and
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
// Loads are 16 bytes (8 bf16 or 4 fp32, `ld.global.nc`), neighbouring
// threads on neighbouring vectors, in full tiles of NTHREADS x NV vectors a
// client (NV = 2 for up to 4 client rows, else 1).  A tile takes one max
// and one rescale a client, then its elements run unpredicated.  The
// vectors after the last full tile go NTHREADS at a time under a mask, and
// the elements before the row's first 16-byte boundary (a view such as
// x[..., 1:]) and after its last vector one per thread, inside the same
// kernel.  Vector loads need every client's row at one 16-byte phase;
// where they are not (a contiguous tensor with V not a multiple of 8, say)
// the same kernel is instantiated with one-element loads.  The client
// counts are template arguments, so every state lives in registers and no
// loop carries a client predicate: the square kernel has one instance per
// K = 1..8, the pair kernel one per N = 1..8 with Kl = Kg = N.  A pair with
// Kl != Kg (past 8 clients, the wrapper's off-diagonal client blocks) runs
// the instance of N = max(Kl, Kg) with the shorter side's first row read
// again in the padded rows, whose results are not written or weighted: the
// same bytes, more instructions, off every training and serving path.  The
// wrapper cuts more than 8 clients into blocks.
//
// What bounds the forwards on the H100: bytes.  At the DML round's shape
// (K = 3, B = 1024, V = 151,936, bf16) the square kernel reads 0.93 GB
// (0.279 ms at 3.35 TB/s) and the pair kernel 1.87 GB (0.557 ms).  Per
// element they issue ~8-9 instructions (unpack, max, FFMA, MUFU.EX2, add,
// and per position K(K-1)/2 subtractions and K(K-1) FMAs; pair: Kl Kg of
// each) and one MUFU.EX2, ~0.13 ms each of the SMs' issue and SFU rates
// for the square case's 4.7e8 elements.  `chip_smoke.py` measures them
// there (H100 80GB HBM3, 700 W): the square kernel at 89-92% of its byte
// bound and the pair kernel at 90%; at (3, 2048, 50,280), where a row's
// start and merge weigh more, 83-87% and 86%.  The pair kernel handed ONE
// tensor as live and fixed reads one plane but issues the pair's 2K
// exponentials and K^2 cross terms a position: 0.44 ms at the shape above
// against the square kernel's 0.30, which is why the square kernel takes
// that call.
//
// Backward replaces `_streaming_pair_bwd` (kl_mutual.py:178-232, plain JAX
// inside the custom_vjp at :235-256): an elementwise pass over (b, v) that
// reads the saved Z's, out and the cotangent g_bar (Kl, B):
//     dlive[i]  = s g_bar_i p_i (R_i lp_i - sum_j w_ij lq_j - out_i)
//     dfixed[j] = -s (sum_i w_ij g_bar_i p_i - q_j sum_i w_ij g_bar_i)
// with s = 1/T, R_i = sum_j w_ij, lp/lq the live/fixed log-softmax and p/q
// their exponentials.  dfixed is written only when asked for (the training
// path holds the fixed side constant).  It reads live and fixed and writes
// dlive: 1.87 GB read and 0.93 GB written at the shape above (0.84 ms), or
// 0.93 GB each way (0.56 ms) when fixed is live.  Its loads are coalesced
// scalars; clients are a compile-time bound KM (4 or 8) with runtime
// Kl, Kg <= KM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

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

// 2^x on the SFU: one MUFU.EX2 (inputs far below -126 give 0).
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// One load of a client's row: 16 bytes when VEC, else one element; held as
// raw 32-bit words and unpacked to fp32 where used.
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

// Packs a client a thread loads per full tile: 8 words of 16-byte loads for
// up to 4 client rows, 4 for more, so the tile stays in registers; one
// element without VEC.
template <bool VEC, int ROWS>
__host__ __device__ constexpr int packs_per_tile() {
    return VEC && ROWS <= 4 ? 2 : 1;
}

// max over a tile's elements of one client, times c (log2 units); a
// masked tile (one pack) that is not `ok` gives NEG_INF * c
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

// Streams one row of the R client rows: full tiles of NTHREADS x NV packs
// a client through `full(packs)` (unmasked), the packs after the last full
// tile NTHREADS at a time through `part(packs, ok)` (masked), and the
// elements before the row's first 16-byte boundary and after its last
// whole pack through `one(packs, ok)`, one element a thread.
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
        full(pk);
    }
    for (int q0 = tiled; q0 < nvec; q0 += NTHREADS) {
        const int q = q0 + tid;
        const bool ok = q < nvec;
        Pack<T, VEC> pk[R][1];
#pragma unroll
        for (int r = 0; r < R; ++r)
            pk[r][0] = ok ? load_pack<T, VEC>(rows(r) + head + q * W)
                          : zero_pack<T, VEC>();
        part(pk, ok);
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
            one(pk, ok);
        }
    }
}

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
        [&](const Pack<T, VEC> (&pk)[K][NV]) {
            st.template tile<T, VEC, NV, false>(pk, true, c);
        },
        [&](const Pack<T, VEC> (&pk)[K][1], bool ok) {
            st.template tile<T, VEC, 1, true>(pk, ok, c);
        },
        [&](const Pack<T, false> (&pk)[K][1], bool ok) {
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
        [&](const Pack<T, VEC> (&pk)[2 * N][NV]) {
            st.template tile<T, VEC, NV, false>(pk, true, c);
        },
        [&](const Pack<T, VEC> (&pk)[2 * N][1], bool ok) {
            st.template tile<T, VEC, 1, true>(pk, ok, c);
        },
        [&](const Pack<T, false> (&pk)[2 * N][1], bool ok) {
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

template <typename T, int KM, int EPT>
__global__ void __launch_bounds__(NTHREADS) kl_pair_bwd(Params p) {
    const int b = blockIdx.y;
    const float s = p.inv_temp;
    const T* live = static_cast<const T*>(p.live) + b * p.l_sb;
    const T* fixed = static_cast<const T*>(p.fixed) + b * p.f_sb;
    const long long row = static_cast<long long>(b) * p.V;
    const long long plane = static_cast<long long>(p.B) * p.V;

    // per-row constants
    float gb[KM], z[KM], r[KM], o[KM], zf[KM], col[KM];
#pragma unroll
    for (int i = 0; i < KM; ++i) {
        gb[i] = z[i] = r[i] = o[i] = zf[i] = col[i] = 0.f;
        if (i < p.Kl) {
            gb[i] = p.gbar[static_cast<long long>(i) * p.B + b];
            z[i] = p.lse_live[static_cast<long long>(i) * p.B + b];
            o[i] = p.out[static_cast<long long>(i) * p.B + b];
        }
        if (i < p.Kg) zf[i] = p.lse_fixed[static_cast<long long>(i) * p.B + b];
    }
#pragma unroll
    for (int i = 0; i < KM; ++i)
#pragma unroll
        for (int j = 0; j < KM; ++j)
            if (i < p.Kl && j < p.Kg) {
                const float wij = p.w[i * p.Kg + j];
                r[i] += wij;
                col[j] += wij * gb[i];
            }

#pragma unroll
    for (int e = 0; e < EPT; ++e) {
        const int v = (blockIdx.x * EPT + e) * NTHREADS + threadIdx.x;
        if (v >= p.V) continue;
        float lp[KM], pp[KM], lq[KM];
#pragma unroll
        for (int i = 0; i < KM; ++i) {
            lp[i] = pp[i] = lq[i] = 0.f;
            if (i < p.Kl) {
                lp[i] = load_f(live + i * p.l_sk + v) * s - z[i];
                pp[i] = expf(lp[i]);
            }
            if (i < p.Kg) lq[i] = load_f(fixed + i * p.f_sk + v) * s - zf[i];
        }
#pragma unroll
        for (int i = 0; i < KM; ++i) {
            if (i < p.Kl) {
                float wlq = 0.f;
#pragma unroll
                for (int j = 0; j < KM; ++j)
                    if (j < p.Kg) wlq = fmaf(p.w[i * p.Kg + j], lq[j], wlq);
                store_f(static_cast<T*>(p.dlive) + i * plane + row + v,
                        s * gb[i] * pp[i] * (r[i] * lp[i] - wlq - o[i]));
            }
        }
        if (p.dfixed != nullptr) {
#pragma unroll
            for (int j = 0; j < KM; ++j) {
                if (j < p.Kg) {
                    float wgp = 0.f;
#pragma unroll
                    for (int i = 0; i < KM; ++i)
                        if (i < p.Kl)
                            wgp = fmaf(p.w[i * p.Kg + j], gb[i] * pp[i], wgp);
                    store_f(static_cast<T*>(p.dfixed) + j * plane + row + v,
                            -s * (wgp - expf(lq[j]) * col[j]));
                }
            }
        }
    }
}

// Elements per thread per tile of the backward: more for few clients, fewer
// for many, so the per-thread tiles stay in registers.
template <int KM>
constexpr int ept() { return KM <= 4 ? 8 : 4; }

int launched(cudaError_t err) {
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool VEC>
int launch_square(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    return launched(cudaLaunchKernel(&kl_square_fwd<T, K, VEC>, dim3(p.B),
                                     dim3(NTHREADS), args, 0, stream));
}

template <typename T, int N, bool VEC>
int launch_pair(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    return launched(cudaLaunchKernel(&kl_pair_fwd<T, N, VEC>, dim3(p.B),
                                     dim3(NTHREADS), args, 0, stream));
}

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

template <typename T, bool VEC>
struct Square {
    template <int K>
    struct Of {
        static int run(Params p, cudaStream_t s) {
            return launch_square<T, K, VEC>(p, s);
        }
    };
};

template <typename T, bool VEC>
struct Pair {
    template <int N>
    struct Of {
        static int run(Params p, cudaStream_t s) {
            return launch_pair<T, N, VEC>(p, s);
        }
    };
};

template <typename T>
int square_fwd(Params p, bool vec, cudaStream_t s) {
    return vec ? by_count<Square<T, true>::template Of>(p.Kl, p, s)
               : by_count<Square<T, false>::template Of>(p.Kl, p, s);
}

template <typename T>
int pair_fwd(Params p, bool vec, cudaStream_t s) {
    const int n = p.Kl > p.Kg ? p.Kl : p.Kg;
    return vec ? by_count<Pair<T, true>::template Of>(n, p, s)
               : by_count<Pair<T, false>::template Of>(n, p, s);
}

template <typename T, int KM>
int launch_bwd(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    constexpr int per_block = NTHREADS * ept<KM>();
    const dim3 grid((p.V + per_block - 1) / per_block, p.B);
    return launched(cudaLaunchKernel(&kl_pair_bwd<T, KM, ept<KM>()>, grid,
                                     dim3(NTHREADS), args, 0, stream));
}

// Whether a stride of `elems` elements keeps the 16-byte phase.
bool keeps_phase(long long elems, int esize) {
    return ((static_cast<unsigned long long>(elems) * esize) & 15ull) == 0;
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

// Square forward: x (K, B, V), K <= 8, live = fixed; writes out (K, B) and
// lse (K, B), the logsumexp of both sides.  Returns the first CUDA error
// (0 on success).  Vector loads when every client's row shares a 16-byte
// phase (the client stride keeps it).
extern "C" int kl_mutual_square_fwd(
    const void* x, const void* w, void* out, void* lse, long long sk,
    long long sb, int K, int B, int V, float inv_temp, int is_bf16,
    void* stream) {
    Params p = make_params(x, x, w, sk, sb, sk, sb, K, K, B, V, inv_temp);
    p.out = static_cast<float*>(out);
    p.lse_live = p.lse_fixed = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int es = is_bf16 ? 2 : 4;
    const bool vec = K == 1 || keeps_phase(sk, es);
    return is_bf16 ? square_fwd<__nv_bfloat16>(p, vec, st)
                   : square_fwd<float>(p, vec, st);
}

// Pair forward: writes out, lse_live and lse_fixed.  The caller has checked
// shapes (Kl, Kg <= 8), dtypes, devices and strides.  Vector loads when
// every live and fixed row of a row b shares one 16-byte phase.
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int es = is_bf16 ? 2 : 4;
    const long long base = static_cast<long long>(
        reinterpret_cast<const char*>(fixed) -
        reinterpret_cast<const char*>(live));
    const bool vec = (Kl == 1 || keeps_phase(l_sk, es))
                     && (Kg == 1 || keeps_phase(f_sk, es))
                     && keeps_phase(base, 1)
                     && (B == 1 || keeps_phase(f_sb - l_sb, es));
    return is_bf16 ? pair_fwd<__nv_bfloat16>(p, vec, st)
                   : pair_fwd<float>(p, vec, st);
}

// Backward: writes dlive (Kl, B, V) and, when dfixed is not null, dfixed
// (Kg, B, V), both contiguous in the input dtype.
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool small = Kl <= 4 && Kg <= 4;
    if (is_bf16)
        return small ? launch_bwd<__nv_bfloat16, 4>(p, st)
                     : launch_bwd<__nv_bfloat16, 8>(p, st);
    return small ? launch_bwd<float, 4>(p, st) : launch_bwd<float, 8>(p, st);
}
