// Pair-weighted mutual-learning KL (the paper's Eq. 2 at vocabulary scale)
// for Hopper (sm_90a): a forward and a backward entry point.
//
// Forward replaces src/repro/kernels/kl_mutual.py:68 (`_kl_pair_kernel`,
// launched by `_kl_pair_forward` at :124):
//
//     out[i, b] = sum_j w[i, j] * KL(softmax(live_i / T) || softmax(fixed_j / T))
//
// for live (Kl, B, V) and fixed (Kg, B, V).  One block owns one row b and
// makes ONE streaming pass over V for all Kl + Kg clients: each thread keeps
// a running max m and partition A = sum e^{g - m} per client on both sides
// and the (Kl, Kg) cross accumulator T_ij = sum_v e^{g_i - m_i} (g_i - h_j),
// rescaled when m_i grows (kl_mutual.py:91-121); the 256 threads' states are
// then merged (warp shuffles, then shared memory) and
//     KL_ij = (Z_j - Z_i) + T_ij / A_i,   Z = m + log A.
// Positions v >= V are masked, not padded.  The live and fixed logsumexps
// Z (in units of logits / T) are written out for the backward.
//
// Backward replaces `_streaming_pair_bwd` (kl_mutual.py:178-232, plain JAX
// inside the custom_vjp at :235-256): an elementwise pass over (b, v) that
// reads the saved Z's, out and the cotangent g_bar (Kl, B):
//     dlive[i]  = s g_bar_i p_i (R_i lp_i - sum_j w_ij lq_j - out_i)
//     dfixed[j] = -s (sum_i w_ij g_bar_i p_i - q_j sum_i w_ij g_bar_i)
// with s = 1/T, R_i = sum_j w_ij, lp/lq the live/fixed log-softmax and p/q
// their exponentials.  dfixed is written only when asked for (the training
// path holds the fixed side constant).
//
// What bounds it on the H100: a handful of flops per element against 2 or 4
// bytes read, so HBM bytes.  At the training shape (K = 3, B = 1024,
// V = 151,936, bf16) the forward reads 1.87 GB (0.56 ms at 3.35 TB/s) and
// the backward reads 1.87 GB and writes 0.93 GB (0.84 ms).  Loads are
// coalesced scalars (neighbouring threads, neighbouring v); wider vector
// loads are later work.  Clients are a compile-time bound KM (4 or 8) with
// runtime Kl, Kg <= KM, so the per-client state stays in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;

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

// Per-thread streaming state of the forward.
template <int KM>
struct State {
    float m[KM], a[KM];     // live running max / partition
    float mf[KM], af[KM];   // fixed running max / partition
    float t[KM][KM];        // cross accumulator
};

// Merges `o` (another thread's state) into `s`.
template <int KM>
__device__ __forceinline__ void merge(State<KM>& s, const State<KM>& o,
                                      int Kl, int Kg) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
        if (i < Kl) {
            const float mn = fmaxf(s.m[i], o.m[i]);
            const float s1 = expf(s.m[i] - mn), s2 = expf(o.m[i] - mn);
            s.a[i] = s.a[i] * s1 + o.a[i] * s2;
#pragma unroll
            for (int j = 0; j < KM; ++j)
                if (j < Kg) s.t[i][j] = s.t[i][j] * s1 + o.t[i][j] * s2;
            s.m[i] = mn;
        }
        if (i < Kg) {
            const float mn = fmaxf(s.mf[i], o.mf[i]);
            s.af[i] = s.af[i] * expf(s.mf[i] - mn) + o.af[i] * expf(o.mf[i] - mn);
            s.mf[i] = mn;
        }
    }
}

template <int KM>
__device__ __forceinline__ State<KM> shfl_state(const State<KM>& s, int lane_mask) {
    State<KM> o;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
        o.m[i] = __shfl_xor_sync(0xffffffffu, s.m[i], lane_mask);
        o.a[i] = __shfl_xor_sync(0xffffffffu, s.a[i], lane_mask);
        o.mf[i] = __shfl_xor_sync(0xffffffffu, s.mf[i], lane_mask);
        o.af[i] = __shfl_xor_sync(0xffffffffu, s.af[i], lane_mask);
#pragma unroll
        for (int j = 0; j < KM; ++j)
            o.t[i][j] = __shfl_xor_sync(0xffffffffu, s.t[i][j], lane_mask);
    }
    return o;
}

template <typename T, int KM, int EPT>
__global__ void __launch_bounds__(NTHREADS) kl_pair_fwd(Params p) {
    extern __shared__ float smem[];   // NWARPS states
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    const T* live = static_cast<const T*>(p.live) + b * p.l_sb;
    const T* fixed = static_cast<const T*>(p.fixed) + b * p.f_sb;

    State<KM> st;
#pragma unroll
    for (int i = 0; i < KM; ++i) {
        st.m[i] = st.mf[i] = NEG_INF;
        st.a[i] = st.af[i] = 0.f;
#pragma unroll
        for (int j = 0; j < KM; ++j) st.t[i][j] = 0.f;
    }

    for (int v0 = 0; v0 < p.V; v0 += NTHREADS * EPT) {
        float g[KM][EPT], h[KM][EPT];
        unsigned ok = 0u;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
            const int v = v0 + e * NTHREADS + tid;
            if (v < p.V) ok |= 1u << e;
#pragma unroll
            for (int i = 0; i < KM; ++i) {
                g[i][e] = i < p.Kl && v < p.V
                              ? load_f(live + i * p.l_sk + v) * p.inv_temp
                              : NEG_INF;
                h[i][e] = i < p.Kg && v < p.V
                              ? load_f(fixed + i * p.f_sk + v) * p.inv_temp
                              : NEG_INF;
            }
        }
        if (!ok) continue;
#pragma unroll
        for (int i = 0; i < KM; ++i) {
            if (i < p.Kl) {
                float mx = st.m[i];
#pragma unroll
                for (int e = 0; e < EPT; ++e)
                    if ((ok >> e) & 1u) mx = fmaxf(mx, g[i][e]);
                const float sc = expf(st.m[i] - mx);
                st.a[i] *= sc;
#pragma unroll
                for (int j = 0; j < KM; ++j) st.t[i][j] *= sc;
#pragma unroll
                for (int e = 0; e < EPT; ++e) {
                    if ((ok >> e) & 1u) {
                        const float ex = expf(g[i][e] - mx);
                        st.a[i] += ex;
#pragma unroll
                        for (int j = 0; j < KM; ++j)
                            if (j < p.Kg)
                                st.t[i][j] = fmaf(ex, g[i][e] - h[j][e],
                                                  st.t[i][j]);
                    }
                }
                st.m[i] = mx;
            }
            if (i < p.Kg) {
                float mx = st.mf[i];
#pragma unroll
                for (int e = 0; e < EPT; ++e)
                    if ((ok >> e) & 1u) mx = fmaxf(mx, h[i][e]);
                float acc = st.af[i] * expf(st.mf[i] - mx);
#pragma unroll
                for (int e = 0; e < EPT; ++e)
                    if ((ok >> e) & 1u) acc += expf(h[i][e] - mx);
                st.af[i] = acc;
                st.mf[i] = mx;
            }
        }
    }

    // merge the 32 lanes of each warp, then the warps
    for (int lane_mask = 16; lane_mask > 0; lane_mask /= 2) {
        const State<KM> o = shfl_state(st, lane_mask);
        merge(st, o, p.Kl, p.Kg);
    }
    State<KM>* warp_states = reinterpret_cast<State<KM>*>(smem);
    if (tid % 32 == 0) warp_states[tid / 32] = st;
    __syncthreads();
    if (tid != 0) return;
    for (int w = 1; w < NWARPS; ++w) merge(st, warp_states[w], p.Kl, p.Kg);

    float zf[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) {
        if (j < p.Kg) {
            zf[j] = st.mf[j] + logf(st.af[j]);
            p.lse_fixed[static_cast<long long>(j) * p.B + b] = zf[j];
        }
    }
#pragma unroll
    for (int i = 0; i < KM; ++i) {
        if (i < p.Kl) {
            const float z = st.m[i] + logf(st.a[i]);
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < KM; ++j)
                if (j < p.Kg)
                    acc += p.w[i * p.Kg + j] *
                           ((zf[j] - z) + st.t[i][j] / st.a[i]);
            p.out[static_cast<long long>(i) * p.B + b] = acc;
            p.lse_live[static_cast<long long>(i) * p.B + b] = z;
        }
    }
}

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

// Elements per thread per tile: more for few clients, fewer for many, so
// the per-thread tiles stay in registers.
template <int KM>
constexpr int ept() { return KM <= 4 ? 8 : 4; }

template <typename T, int KM>
int launch_fwd(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    const int smem_bytes = NWARPS * static_cast<int>(sizeof(State<KM>));
    cudaError_t err = cudaLaunchKernel(&kl_pair_fwd<T, KM, ept<KM>()>,
                                       dim3(p.B), dim3(NTHREADS), args,
                                       smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int KM>
int launch_bwd(Params p, cudaStream_t stream) {
    void* args[] = {&p};
    constexpr int per_block = NTHREADS * ept<KM>();
    const dim3 grid((p.V + per_block - 1) / per_block, p.B);
    cudaError_t err = cudaLaunchKernel(&kl_pair_bwd<T, KM, ept<KM>()>, grid,
                                       dim3(NTHREADS), args, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
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

// Forward: writes out, lse_live and lse_fixed.  Returns the first CUDA
// error (0 on success).  The caller has checked shapes (Kl, Kg <= 8),
// dtypes, devices and strides.
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
    const bool small = Kl <= 4 && Kg <= 4;
    if (is_bf16)
        return small ? launch_fwd<__nv_bfloat16, 4>(p, st)
                     : launch_fwd<__nv_bfloat16, 8>(p, st);
    return small ? launch_fwd<float, 4>(p, st) : launch_fwd<float, 8>(p, st);
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
