// Pair-weighted Eq. 2 against RECEIVED sparse (top-k) predictions -- the
// SparseDML hot path -- for Hopper (sm_90a): a forward and a backward entry
// point.
//
// Forward replaces src/repro/kernels/sparse_kl.py:47 (`_sparse_kl_kernel`,
// launched by `_sparse_kl_forward` at :122):
//
//     out[i, b] = sum_j w[i, j] * KL(P_i(b) || ~Q_j(b))
//
// for live logits (Kl, B, V) against J received top-k sets idx/logp (J, B, k)
// with pair weights w (Kl, J).  ~Q_j is the received top-k mass plus a
// uniform tail over the other V - k entries, so per pair
//
//     KL_ij = -H(P_i) - c_j (1 - s_ij) - sum_t p_i[idx_jt] logp_jt,
//     s_ij = sum_t p_i[idx_jt],  c_j = log(clip(1 - sum_t e^logp_jt, 1e-9, 1)
//                                          / max(V - k, 1)).
//
// One block owns one (row b, live client i).  It makes ONE streaming pass
// over V carrying the running max m, the partition sum A = sum e^{g - m} and
// the entropy sum U = sum e^{g - m} (g - m), all fp32 (g = logit / T; U is
// kept relative to m, which spares the cancellation of U/A against Z), so
// that Z = m + log A and -H = U/A - log A.  The TPU kernel finds the received
// logits by one-hot matching inside each vocab block (sparse_kl.py:75-81);
// here every index is simply read, live[i, b, idx[j, b, t]], after the pass
// (the row was just streamed, so the J*k reads mostly hit L2).  Sums across
// the block's threads go through shared memory in a fixed tree order:
// deterministic, no atomics, no warp shuffles.  Z, -H and
// C1 = sum_j w_ij (c_j s_ij - cross_ij) are written for the backward, as the
// pair-KL forward writes its logsumexps.
//
// Backward replaces `_streaming_sparse_bwd` (sparse_kl.py:167-226, plain JAX
// inside the custom VJP at :229-253), the gradient of the live side only:
//
//     dlive[i,b,v] = s gbar_ib p_v [R_i (lp_v - (-H_ib)) - C1_ib]
//                  + s gbar_ib p_v sum_j w_ij (c_jb a^j_v - l^j_v)
//
// with s = 1/T, lp/p the live log-softmax and softmax, R_i = sum_j w_ij,
// a^j_v the multiplicity of v in sender j's set and l^j_v the sum of its
// log-probs there.  The first term is dense: one elementwise pass over V.
// The second is nonzero only at the J*k received indices, and the senders'
// sets overlap heavily, so several entries land on one v: a parallel scatter
// would lose updates.  After the dense pass (and a barrier) each entry sums
// the contributions of every entry with its index -- (J*k)^2 comparisons in
// shared memory, ~37k a row at J*k = 192 -- and only the first such entry
// rewrites dlive[v] with the dense and sparse terms in one fp32 expression.
// Deterministic, no atomics, and dlive is rounded once.  A launch takes at
// most MAX_J senders and MAX_ENTRIES entries; the wrapper cuts more senders
// into blocks (the loss and dlive are sums over senders).  One sender whose
// k alone exceeds the table is read in place: the entries then come from
// the (contiguous) idx and logp in device memory instead of shared memory,
// by the same comparisons in the same order.
//
// What bounds it on the H100: a few flops and one exp per element against 2
// or 4 bytes, so HBM bytes.  At the SparseDML path's shape (Kl = J = 3,
// B = 1024, V = 151,936, k = 64, bf16) the forward reads live once,
// 933.6 MB (0.279 ms at 3.35 TB/s), and the backward reads live and writes
// dlive, 1.867 GB (0.557 ms); the ~4.7e8 exps take ~0.11 ms on the SFUs.
// Loads are coalesced scalars (neighbouring threads, neighbouring v), EPT of
// them in flight per thread; wider vector loads are later work.  Indices
// outside [0, V) are clamped (top-k never makes them).

#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int EPT = 8;
constexpr int MAX_J = 64;          // senders; the backward's c_j table
constexpr int MAX_ENTRIES = 4096;  // J * k; the backward's shared table

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

struct Params {
    const void* live;       // (Kl, B, V), unit stride along V
    const int* idx;         // (J, B, k) contiguous
    const float* logp;      // (J, B, k) contiguous
    const float* w;         // (Kl, J) contiguous
    float* out;             // (Kl, B), forward
    float* stats;           // (3, Kl, B): Z, -H, C1; written by the forward
    const float* gbar;      // (Kl, B), backward
    void* dlive;            // (Kl, B, V) contiguous, backward
    long long l_sk, l_sb;   // live strides: client, row
    int Kl, J, B, V, k;
    float inv_temp;
};

// Streaming softmax state: max m, A = sum e^{g - m}, U = sum e^{g - m}(g - m).
// A == 0 marks a state that has seen no element.
struct Lse {
    float m, a, u;
};

__device__ __forceinline__ Lse merge(Lse s, Lse o) {
    if (o.a == 0.f) return s;
    if (s.a == 0.f) return o;
    const float mn = fmaxf(s.m, o.m);
    const float d1 = s.m - mn, d2 = o.m - mn;
    const float s1 = expf(d1), s2 = expf(d2);
    return {mn, s.a * s1 + o.a * s2,
            s1 * (s.u + d1 * s.a) + s2 * (o.u + d2 * o.a)};
}

// Sum of one value per thread over the block, in a fixed tree order through
// shared memory; every thread gets the result.
__device__ float block_sum(float x, float* red) {
    const int tid = threadIdx.x;
    red[tid] = x;
    __syncthreads();
    for (int s = NTHREADS / 2; s > 0; s /= 2) {
        if (tid < s) red[tid] += red[tid + s];
        __syncthreads();
    }
    const float r = red[0];
    __syncthreads();                 // red is reused by the next call
    return r;
}

__device__ __forceinline__ int clamp_index(int v, int V) {
    return v < 0 ? 0 : (v >= V ? V - 1 : v);
}

// c_j = log(clip(1 - sum_t e^logp_jt, 1e-9, 1) / max(V - k, 1)), from the
// block-wide sum of e^logp.
__device__ __forceinline__ float tail_log(float ex, int V, int k) {
    const float res = fminf(fmaxf(1.f - ex, 1e-9f), 1.f);
    return logf(res / static_cast<float>(V - k > 1 ? V - k : 1));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(Params p) {
    __shared__ float sm[3][NTHREADS];
    __shared__ float red[NTHREADS];
    const int tid = threadIdx.x;
    const int b = blockIdx.x, i = blockIdx.y;
    const T* row = static_cast<const T*>(p.live) + i * p.l_sk + b * p.l_sb;

    // one streaming pass over V: (m, A, U) per thread
    Lse st = {0.f, 0.f, 0.f};
    for (int v0 = 0; v0 < p.V; v0 += NTHREADS * EPT) {
        float g[EPT];
        unsigned ok = 0u;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
            const int v = v0 + e * NTHREADS + tid;
            const bool in = v < p.V;
            if (in) ok |= 1u << e;
            g[e] = in ? load_f(row + v) * p.inv_temp : 0.f;
        }
        if (!ok) continue;
        float mx = st.a > 0.f ? st.m : -INFINITY;
#pragma unroll
        for (int e = 0; e < EPT; ++e)
            if ((ok >> e) & 1u) mx = fmaxf(mx, g[e]);
        float a = 0.f, u = 0.f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
            if ((ok >> e) & 1u) {
                const float x = g[e] - mx;
                const float ex = expf(x);
                a += ex;
                u = fmaf(ex, x, u);
            }
        }
        if (st.a > 0.f) {
            const float d = st.m - mx;
            const float sc = expf(d);
            st.u = sc * (st.u + d * st.a) + u;
            st.a = sc * st.a + a;
        } else {
            st.u = u;
            st.a = a;
        }
        st.m = mx;
    }

    // merge the threads' states: a tree over shared memory
    sm[0][tid] = st.m;
    sm[1][tid] = st.a;
    sm[2][tid] = st.u;
    __syncthreads();
    for (int s = NTHREADS / 2; s > 0; s /= 2) {
        if (tid < s) {
            const Lse x = merge({sm[0][tid], sm[1][tid], sm[2][tid]},
                                {sm[0][tid + s], sm[1][tid + s],
                                 sm[2][tid + s]});
            sm[0][tid] = x.m;
            sm[1][tid] = x.a;
            sm[2][tid] = x.u;
        }
        __syncthreads();
    }
    const float log_a = logf(sm[1][0]);
    const float z = sm[0][0] + log_a;
    const float neg_h = sm[2][0] / sm[1][0] - log_a;

    // the received entries, read directly at their indices
    float out = 0.f, c1 = 0.f;
    for (int j = 0; j < p.J; ++j) {
        const long long base = (static_cast<long long>(j) * p.B + b) * p.k;
        float s = 0.f, cross = 0.f, ex = 0.f;
        for (int t = tid; t < p.k; t += NTHREADS) {
            const int v = clamp_index(p.idx[base + t], p.V);
            const float lq = p.logp[base + t];
            const float pa = expf(load_f(row + v) * p.inv_temp - z);
            s += pa;
            cross = fmaf(pa, lq, cross);
            ex += expf(lq);
        }
        s = block_sum(s, red);
        cross = block_sum(cross, red);
        const float c = tail_log(block_sum(ex, red), p.V, p.k);
        const float wij = p.w[i * p.J + j];
        out += wij * (neg_h - c * (1.f - s) - cross);
        c1 += wij * (c * s - cross);
    }
    if (tid == 0) {
        const long long o = static_cast<long long>(i) * p.B + b;
        const long long plane = static_cast<long long>(p.Kl) * p.B;
        p.out[o] = out;
        p.stats[o] = z;
        p.stats[plane + o] = neg_h;
        p.stats[2 * plane + o] = c1;
    }
}

// The backward; IN_PLACE reads one sender's k entries from idx and logp in
// device memory (k past the shared-memory table), else the J * k entries
// go to shared memory first.  Two instantiations, so that each path's
// loads have a known address space.
template <typename T, bool IN_PLACE>
__global__ void __launch_bounds__(NTHREADS) bwd_kernel(Params p) {
    extern __shared__ float smem[];  // J*k log-probs, then J*k indices
    __shared__ float red[NTHREADS];
    __shared__ float cj[MAX_J];
    const int tid = threadIdx.x;
    const int b = blockIdx.x, i = blockIdx.y;
    const int n = p.J * p.k;
    float* lq_s = smem;
    int* idx_s = reinterpret_cast<int*>(smem + n);
    // row b's entries: J == 1 when IN_PLACE
    const float* lq_g = p.logp + static_cast<long long>(b) * p.k;
    const int* idx_g = p.idx + static_cast<long long>(b) * p.k;
    auto logp_at = [&](int e) { return IN_PLACE ? lq_g[e] : lq_s[e]; };
    auto index_at = [&](int e) {
        return IN_PLACE ? clamp_index(idx_g[e], p.V) : idx_s[e];
    };
    if (!IN_PLACE) {
        for (int e = tid; e < n; e += NTHREADS) {
            const int j = e / p.k;
            const long long g =
                (static_cast<long long>(j) * p.B + b) * p.k + (e - j * p.k);
            lq_s[e] = p.logp[g];
            idx_s[e] = clamp_index(p.idx[g], p.V);
        }
    }
    __syncthreads();
    for (int j = 0; j < p.J; ++j) {
        float ex = 0.f;
        for (int t = tid; t < p.k; t += NTHREADS) ex += expf(logp_at(j * p.k + t));
        ex = block_sum(ex, red);
        if (tid == 0) cj[j] = tail_log(ex, p.V, p.k);
    }
    __syncthreads();

    const long long o = static_cast<long long>(i) * p.B + b;
    const long long plane = static_cast<long long>(p.Kl) * p.B;
    const float z = p.stats[o], neg_h = p.stats[plane + o];
    const float c1 = p.stats[2 * plane + o];
    const float sg = p.inv_temp * p.gbar[o];
    float r = 0.f;
    for (int j = 0; j < p.J; ++j) r += p.w[i * p.J + j];
    const T* row = static_cast<const T*>(p.live) + i * p.l_sk + b * p.l_sb;
    T* drow = static_cast<T*>(p.dlive) + o * p.V;

    // the dense term, one elementwise pass over V
    for (int v0 = 0; v0 < p.V; v0 += NTHREADS * EPT) {
        float lp[EPT];
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
            const int v = v0 + e * NTHREADS + tid;
            lp[e] = v < p.V ? load_f(row + v) * p.inv_temp - z : 0.f;
        }
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
            const int v = v0 + e * NTHREADS + tid;
            if (v < p.V)
                store_f(drow + v,
                        sg * expf(lp[e]) * (r * (lp[e] - neg_h) - c1));
        }
    }
    __syncthreads();                 // the dense values are written

    // the sparse term: the first entry of each distinct index sums every
    // entry with that index and rewrites dlive there
    for (int e = tid; e < n; e += NTHREADS) {
        const int v = index_at(e);
        bool first = true;
        float corr = 0.f;
        for (int f = 0; f < n; ++f) {
            if (index_at(f) != v) continue;
            if (f < e) {
                first = false;
                break;
            }
            const int j = f / p.k;
            corr = fmaf(p.w[i * p.J + j], cj[j] - logp_at(f), corr);
        }
        if (first) {
            const float lp = load_f(row + v) * p.inv_temp - z;
            store_f(drow + v,
                    sg * expf(lp) * (r * (lp - neg_h) - c1 + corr));
        }
    }
}

Params make_params(const void* live, const void* idx, const void* logp,
                   const void* w, long long l_sk, long long l_sb, int Kl,
                   int J, int B, int V, int k, float inv_temp) {
    Params p = {};
    p.live = live;
    p.idx = static_cast<const int*>(idx);
    p.logp = static_cast<const float*>(logp);
    p.w = static_cast<const float*>(w);
    p.l_sk = l_sk;
    p.l_sb = l_sb;
    p.Kl = Kl;
    p.J = J;
    p.B = B;
    p.V = V;
    p.k = k;
    p.inv_temp = inv_temp;
    return p;
}

int check_launch(cudaError_t err) {
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A launch's senders: at most MAX_J, and at most MAX_ENTRIES entries unless
// there is one sender.
static bool senders_ok(int J, int k) {
    return J >= 1 && J <= MAX_J && (J == 1 || J * k <= MAX_ENTRIES);
}

// Forward: writes out (Kl, B) and stats (3, Kl, B) fp32.  Returns the first
// CUDA error (0 on success).  The caller has checked shapes (senders_ok,
// k <= V), dtypes, devices and strides.
extern "C" int sparse_kl_fwd(
    const void* live, const void* idx, const void* logp, const void* w,
    void* out, void* stats, long long l_sk, long long l_sb, int Kl, int J,
    int B, int V, int k, float inv_temp, int is_bf16, void* stream) {
    Params p = make_params(live, idx, logp, w, l_sk, l_sb, Kl, J, B, V, k,
                           inv_temp);
    p.out = static_cast<float*>(out);
    p.stats = static_cast<float*>(stats);
    void* args[] = {&p};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(B, Kl);
    if (!senders_ok(J, k)) return static_cast<int>(cudaErrorInvalidValue);
    if (is_bf16)
        return check_launch(cudaLaunchKernel(&fwd_kernel<__nv_bfloat16>,
                                             grid, dim3(NTHREADS), args, 0,
                                             st));
    return check_launch(cudaLaunchKernel(&fwd_kernel<float>, grid,
                                         dim3(NTHREADS), args, 0, st));
}

// Backward: writes dlive (Kl, B, V) contiguous in the input dtype from the
// forward's stats and the cotangent gbar (Kl, B) fp32.
extern "C" int sparse_kl_bwd(
    const void* live, const void* idx, const void* logp, const void* w,
    const void* stats, const void* gbar, void* dlive, long long l_sk,
    long long l_sb, int Kl, int J, int B, int V, int k, float inv_temp,
    int is_bf16, void* stream) {
    Params p = make_params(live, idx, logp, w, l_sk, l_sb, Kl, J, B, V, k,
                           inv_temp);
    p.stats = const_cast<float*>(static_cast<const float*>(stats));
    p.gbar = static_cast<const float*>(gbar);
    p.dlive = dlive;
    void* args[] = {&p};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(B, Kl);
    if (!senders_ok(J, k)) return static_cast<int>(cudaErrorInvalidValue);
    if (J * k > MAX_ENTRIES) {       // one sender: its entries in place
        if (is_bf16)
            return check_launch(cudaLaunchKernel(
                &bwd_kernel<__nv_bfloat16, true>, grid, dim3(NTHREADS), args,
                0, st));
        return check_launch(cudaLaunchKernel(&bwd_kernel<float, true>, grid,
                                             dim3(NTHREADS), args, 0, st));
    }
    const size_t smem_bytes = static_cast<size_t>(J) * k * 8;
    if (is_bf16)
        return check_launch(cudaLaunchKernel(
            &bwd_kernel<__nv_bfloat16, false>, grid, dim3(NTHREADS), args,
            smem_bytes, st));
    return check_launch(cudaLaunchKernel(&bwd_kernel<float, false>, grid,
                                         dim3(NTHREADS), args, smem_bytes,
                                         st));
}
