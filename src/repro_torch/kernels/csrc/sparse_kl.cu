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
// over V (kl_stream.cuh: 16-byte loads, neighbouring threads on
// neighbouring vectors, full tiles of 4 vectors a thread run unpredicated,
// then a masked step and the row's scalar head and tail; a block owns one
// row, so every row takes vector loads after its own head).  Each thread
// carries, in log2 units (y = logit c, c = log2(e) / T), the running max
// m, the partition sum A = sum 2^{y - m} and the entropy sum
// U = sum 2^{y - m} (y - m), U kept relative to m (which spares the
// cancellation of U/A against Z): one MUFU.EX2 an element and one rescale
// a tile.  The states merge by a butterfly of warp shuffles, then every
// thread merges the 8 warps' states in warp order (one barrier; fixed
// order, deterministic, no atomics), and Z = ln 2 (m + log2 A),
// -H = ln 2 (U/A - log2 A) in natural units.  The TPU kernel finds the
// received logits by one-hot matching inside each vocab block
// (sparse_kl.py:75-81); here every index is simply read,
// live[i, b, idx[j, b, t]], after the pass (the row was just streamed, so
// the J*k reads mostly hit L2).  Each sender's s_ij, cross sum and
// sum_t e^logp_jt (fp64: c_j rests on its rounding when the set holds
// nearly all the mass) are reduced together a warp at a time, and one
// barrier serves all senders.  Z, -H and C1 = sum_j w_ij (c_j s_ij -
// cross_ij) are written for the backward, as the pair-KL forward writes
// its logsumexps.

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
// `chip_smoke.py` measures them there (NVIDIA H100 80GB HBM3, 700.00 W):
// the forward 0.32 ms (87% of its bound; one torch.amax read of the same
// logits 0.32 ms), from 0.61 ms with scalar loads, expf and a shared-memory
// tree of merges and sums; the backward 0.85 ms (65%).  The backward's
// loads are coalesced scalars (neighbouring threads, neighbouring v), EPT
// of them in flight per thread.  Indices outside [0, V) are clamped (top-k
// never makes them).

#include "kl_stream.cuh"

namespace {

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

// Streaming softmax state in log2 units (y = x c, c = log2(e) / T): the
// running max m, A = sum 2^{y - m} and U = sum 2^{y - m} (y - m), U kept
// relative to m (which spares the cancellation of U/A against Z).  A state
// that has seen no element has m = NEG_INF and A = U = 0.
struct Lse {
    float m, a, u;

    // One tile of NV packs; MASKED (one pack): it counts only when `ok`.
    template <typename T, bool VEC, int NV, bool MASKED>
    __device__ __forceinline__ void tile(const Pack<T, VEC> (&pk)[NV],
                                         bool ok, float c) {
        static_assert(!MASKED || NV == 1, "a masked tile is one pack");
        const float mx = fmaxf(m, tile_max<T, VEC, NV>(pk, !MASKED || ok, c));
        const float d = m - mx, sc = fast_exp2(d);
        u = sc * fmaf(d, a, u);
        a *= sc;
        m = mx;
#pragma unroll
        for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int e = 0; e < Pack<T, VEC>::W; ++e) {
                const float y = fmaf(elem(pk[n], e), c, -m);
                float ex = fast_exp2(y);
                if (MASKED && !ok) ex = 0.f;
                a += ex;
                u = fmaf(ex, y, u);
            }
    }

    __device__ __forceinline__ void merge(const Lse& o) {
        const float mn = fmaxf(m, o.m);
        const float d1 = m - mn, d2 = o.m - mn;
        const float s1 = fast_exp2(d1), s2 = fast_exp2(d2);
        u = s1 * fmaf(d1, a, u) + s2 * fmaf(d2, o.a, o.u);
        a = a * s1 + o.a * s2;
        m = mn;
    }
};

// A warp's sum, by a butterfly (every lane gets it).
template <typename F>
__device__ __forceinline__ F warp_sum(F x) {
    for (int lane_mask = 16; lane_mask > 0; lane_mask /= 2)
        x += __shfl_xor_sync(0xffffffffu, x, lane_mask);
    return x;
}

// A sender's sum_t e^logp_jt, which c_j takes from 1 - sum: where a top-k
// set holds nearly all of its mass, c_j rests on the rounding of that sum.
// So it is summed in fp64, and the forward and the backward sum it in one
// order, bit for bit (the backward's sparse term takes its own c_j against
// the forward's C1 = sum_j w_ij (c_j s_ij - cross_ij)): each thread over
// t = tid, tid + NTHREADS, ..., then warp_sum, then the warps in warp order
// from 0 (`warps_sum`).
__device__ __forceinline__ double warps_sum(const double (&part)[NWARPS]) {
    double x = 0.0;
    for (int w = 0; w < NWARPS; ++w) x += part[w];
    return x;
}

__device__ __forceinline__ int clamp_index(int v, int V) {
    return v < 0 ? 0 : (v >= V ? V - 1 : v);
}

// c_j = log(clip(1 - sum_t e^logp_jt, 1e-9, 1) / max(V - k, 1)), from the
// block-wide sum of e^logp.
__device__ __forceinline__ float tail_log(double ex, int V, int k) {
    const double res = fmin(fmax(1.0 - ex, 1e-9), 1.0);
    return static_cast<float>(
        log(res / static_cast<double>(V - k > 1 ? V - k : 1)));
}

// One block a (row b, live client i): a row never shares a block with
// another, so every row takes 16-byte loads after its own scalar head.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(Params p) {
    constexpr int NV = 4;                        // 64 bytes a thread a tile
    __shared__ float warp_lse[3][NWARPS];
    __shared__ float sums[MAX_J][2][NWARPS];     // s, cross
    __shared__ double ex_part[MAX_J][NWARPS];    // sum e^logp
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int b = blockIdx.x, i = blockIdx.y;
    const T* row = static_cast<const T*>(p.live) + i * p.l_sk + b * p.l_sb;
    const float c = LOG2E * p.inv_temp;

    // one streaming pass over V: (m, A, U) per thread
    Lse st = {NEG_INF, 0.f, 0.f};
    stream_row<T, true, 1, NV>(
        [row](int) { return row; }, p.V,
        [&](const Pack<T, true> (&pk)[1][NV], int) {
            st.template tile<T, true, NV, false>(pk[0], true, c);
        },
        [&](const Pack<T, true> (&pk)[1][1], bool ok, int) {
            st.template tile<T, true, 1, true>(pk[0], ok, c);
        },
        [&](const Pack<T, false> (&pk)[1][1], bool ok, int) {
            st.template tile<T, false, 1, true>(pk[0], ok, c);
        });

    // merge the threads' states: a butterfly within each warp, then every
    // thread merges the warps' states in warp order
    for (int lane_mask = 16; lane_mask > 0; lane_mask /= 2)
        st.merge({__shfl_xor_sync(0xffffffffu, st.m, lane_mask),
                  __shfl_xor_sync(0xffffffffu, st.a, lane_mask),
                  __shfl_xor_sync(0xffffffffu, st.u, lane_mask)});
    if (lane == 0) {
        warp_lse[0][warp] = st.m;
        warp_lse[1][warp] = st.a;
        warp_lse[2][warp] = st.u;
    }
    __syncthreads();
    Lse all = {warp_lse[0][0], warp_lse[1][0], warp_lse[2][0]};
    for (int w = 1; w < NWARPS; ++w)
        all.merge({warp_lse[0][w], warp_lse[1][w], warp_lse[2][w]});
    // natural units: Z = ln 2 (m + log2 A), -H = ln 2 (U / A - log2 A)
    const float log2_a = log2f(all.a);
    const float z = LN2 * (all.m + log2_a);
    const float neg_h = LN2 * (all.u / all.a - log2_a);

    // the received entries, read directly at their indices; each sender's
    // three sums reduced together, a warp at a time
    for (int j = 0; j < p.J; ++j) {
        const long long base = (static_cast<long long>(j) * p.B + b) * p.k;
        float s = 0.f, cross = 0.f;
        double ex = 0.0;
        for (int t = tid; t < p.k; t += NTHREADS) {
            const int v = clamp_index(p.idx[base + t], p.V);
            const float lq = p.logp[base + t];
            const float pa = expf(load_f(row + v) * p.inv_temp - z);
            s += pa;
            cross = fmaf(pa, lq, cross);
            ex += expf(lq);
        }
        s = warp_sum(s);
        cross = warp_sum(cross);
        ex = warp_sum(ex);
        if (lane == 0) {
            sums[j][0][warp] = s;
            sums[j][1][warp] = cross;
            ex_part[j][warp] = ex;
        }
    }
    __syncthreads();
    if (tid != 0) return;
    float out = 0.f, c1 = 0.f;
    for (int j = 0; j < p.J; ++j) {
        float s = 0.f, cross = 0.f;
        for (int w = 0; w < NWARPS; ++w) {
            s += sums[j][0][w];
            cross += sums[j][1][w];
        }
        const float cj = tail_log(warps_sum(ex_part[j]), p.V, p.k);
        const float wij = p.w[i * p.J + j];
        out += wij * (neg_h - cj * (1.f - s) - cross);
        c1 += wij * (cj * s - cross);
    }
    const long long o = static_cast<long long>(i) * p.B + b;
    const long long plane = static_cast<long long>(p.Kl) * p.B;
    p.out[o] = out;
    p.stats[o] = z;
    p.stats[plane + o] = neg_h;
    p.stats[2 * plane + o] = c1;
}

// The backward; IN_PLACE reads one sender's k entries from idx and logp in
// device memory (k past the shared-memory table), else the J * k entries
// go to shared memory first.  Two instantiations, so that each path's
// loads have a known address space.
template <typename T, bool IN_PLACE>
__global__ void __launch_bounds__(NTHREADS) bwd_kernel(Params p) {
    extern __shared__ float smem[];  // J*k log-probs, then J*k indices
    __shared__ double ex_part[MAX_J][NWARPS];
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
    for (int j = 0; j < p.J; ++j) {      // c_j as the forward sums it
        double ex = 0.0;
        for (int t = tid; t < p.k; t += NTHREADS) ex += expf(logp_at(j * p.k + t));
        ex = warp_sum(ex);
        if (tid % 32 == 0) ex_part[j][tid / 32] = ex;
    }
    __syncthreads();
    if (tid < p.J) cj[tid] = tail_log(warps_sum(ex_part[tid]), p.V, p.k);
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
        return launched(cudaLaunchKernel(&fwd_kernel<__nv_bfloat16>,
                                             grid, dim3(NTHREADS), args, 0,
                                             st));
    return launched(cudaLaunchKernel(&fwd_kernel<float>, grid,
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
            return launched(cudaLaunchKernel(
                &bwd_kernel<__nv_bfloat16, true>, grid, dim3(NTHREADS), args,
                0, st));
        return launched(cudaLaunchKernel(&bwd_kernel<float, true>, grid,
                                             dim3(NTHREADS), args, 0, st));
    }
    const size_t smem_bytes = static_cast<size_t>(J) * k * 8;
    if (is_bf16)
        return launched(cudaLaunchKernel(
            &bwd_kernel<__nv_bfloat16, false>, grid, dim3(NTHREADS), args,
            smem_bytes, st));
    return launched(cudaLaunchKernel(&bwd_kernel<float, false>, grid,
                                         dim3(NTHREADS), args, smem_bytes,
                                         st));
}
