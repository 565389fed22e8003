// Flash-attention forward for Hopper (sm_90a): causal GQA attention with an
// optional sliding window, emitting the output and the per-row logsumexp.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_attn_kernel`, launched by `_flash_forward` at :91).  It computes what
// that kernel computes -- not its grid: a block owns one (batch, query
// head, query tile) and loops over the key tiles that tile can reach (lower
// bound from the window, upper bound from causality), carrying the
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
// S ~ 740 up the tensor cores bound it.  Both products therefore have to
// run on the tensor cores, and the loads have to overlap them.
//
// bf16 inputs (`attn_fwd_tc`, the serving and training paths): one block of
// two consumer warpgroups and a producer warpgroup owns 128 query rows, 64
// a consumer.  One producer thread loads the q tile once and streams the
// 128-key K and V tiles through a three-stage ring in shared memory by TMA
// (4-D tensor maps encoded per call from the strides, swizzled 128 or 64
// bytes, zero-filled past S and T), with full/empty mbarriers; the
// producer hands its registers to the consumers (setmaxnreg 24 / 240).
// S = q.k^T is a wgmma m64n128k16 with both operands in shared memory and
// fp32 accumulation; the online softmax runs on the accumulator registers
// (row max and sum over the four threads that share a row, exp2 with the
// scale folded into log2 e); P is rounded to bf16 in registers and is the
// register A operand of O += P.V (wgmma m64n{hd}k16, V read MN-major with
// the transpose bit).  A consumer issues tile i's scores and tile i-1's
// P.V together and runs tile i's softmax while P.V multiplies.  Tiles that
// need no mask skip the mask arithmetic.  Blocks are launched longest
// causal tile first, so the short tiles fill the last wave.
//
// fp32 inputs (`attn_fwd`) keep the exact FMA kernel: scores and P.V are
// fp32 FMAs from shared-memory tiles (a 4x4 score and a 4 x hd/16 output
// micro-tile per thread, 64-row query tiles), which holds the fp32 checks
// to 1e-4; TF32 tensor cores would keep three digits.

#include "hopper_mma.cuh"

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

template <int HD>
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

    const float* qg =
        static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* kg =
        static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const float* vg =
        static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

    for (int i = tid; i < BM * HD; i += NTHREADS) {
        const int r = i / HD, d = i % HD;
        const int s = q0 + r;
        Qs[r * LD + d] = s < p.S ? qg[s * p.q_ss + d] : 0.f;
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
            Ks[c * LD + d] = ok ? kg[t * p.k_ss + d] : 0.f;
            Vs[c * LD + d] = ok ? vg[t * p.v_ss + d] : 0.f;
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

    float* og = static_cast<float*>(p.out);
    const long long o_ss = static_cast<long long>(p.Hq) * HD;
    const long long o_sb = static_cast<long long>(p.S) * o_ss;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const int s = q0 + r;
        if (s < p.S) {
            const float denom = fmaxf(row_l[r], 1e-30f);
            float* orow = og + b * o_sb + s * o_ss + h * HD;
#pragma unroll
            for (int j = 0; j < CN; ++j)
                orow[cg + 16 * j] = acc[i][j] / denom;
        }
    }
    if (tid < BM && q0 + tid < p.S) {
        const long long row = static_cast<long long>(b * p.Hq + h) * p.S;
        p.lse[row + q0 + tid] =
            row_m[tid] + logf(fmaxf(row_l[tid], 1e-30f));
    }
}

template <int HD>
int launch_fma(Params p, int B, cudaStream_t stream) {
    const int smem_bytes = Smem<HD>::TOTAL * static_cast<int>(sizeof(float));
    const void* fn = reinterpret_cast<const void*>(&attn_fwd<HD>);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.S + BM - 1) / BM, p.Hq, B);
    void* args[] = {&p};
    err = cudaLaunchKernel(fn, grid, dim3(NTHREADS), args, smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

int launch_hd_fma(const Params& p, int B, int hd, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch_fma<32>(p, B, stream);
        case 64: return launch_fma<64>(p, B, stream);
        case 128: return launch_fma<128>(p, B, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

namespace tc {

constexpr int BM = 128;        // query rows per block: two warpgroups of 64
constexpr int BN = 128;        // keys per K/V tile
constexpr int STAGES = 3;      // K/V ring depth
constexpr int NTHREADS = 3 * 128;  // two consumer warpgroups, a producer
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
    CUtensorMap tq, tk, tv;  // (hd, seq, head, batch) maps of q, k, v
    void* out;
    float* lse;
    int S, T, Hq, Hkv, B, n_qtiles;
    int causal, window;  // window <= 0: no window
    float scale_log2;    // sm_scale * log2 e
};

// Shared-memory plan, in bytes from a 1024-aligned base.  Each operand is
// stored as hd / CH column blocks of CH elements (RB bytes a row), the
// block the TMA writes with a RB-byte swizzle and wgmma reads back.
template <int HD>
struct Plan {
    static constexpr int RB = HD * 2 < 128 ? HD * 2 : 128;
    static constexpr int CH = RB / 2;
    static constexpr int NCH = HD / CH;
    static constexpr int Q_BYTES = BM * HD * 2;
    static constexpr int KV_BYTES = BN * HD * 2;
    static constexpr int K = Q_BYTES;
    static constexpr int V = K + STAGES * KV_BYTES;
    static constexpr int BAR = V + STAGES * KV_BYTES;
    static constexpr int TOTAL = BAR + (1 + 2 * STAGES) * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_fwd_tc(const __grid_constant__ Args p) {
    using PL = Plan<HD>;
    constexpr int RB = PL::RB;
    constexpr int CH = PL::CH;
    constexpr int NCH = PL::NCH;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* Qs = smem;
    uint8_t* Ks = smem + PL::K;
    uint8_t* Vs = smem + PL::V;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + PL::BAR);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + STAGES;

    // longest causal query tiles first: the last tile index comes first
    const int heads = p.Hq * p.B;
    const int qt = p.n_qtiles - 1 - static_cast<int>(blockIdx.x) / heads;
    const int h = static_cast<int>(blockIdx.x) % heads % p.Hq;
    const int b = static_cast<int>(blockIdx.x) % heads / p.Hq;
    const int hk = h / (p.Hq / p.Hkv);
    const int q0 = qt * BM;

    // Key tiles this query tile can reach.
    const int q_last = min(q0 + BM, p.S) - 1;
    const int n_end = p.causal ? min(p.T, q_last + 1) : p.T;
    const int n_begin =
        p.window > 0 ? (max(0, q0 - p.window + 1) / BN) * BN : 0;
    const int n_tiles = max(0, (n_end - n_begin + BN - 1) / BN);

    const int tid = threadIdx.x;
    if (tid == 0) {
        hopper::mbar_init(q_full, 1);
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();

    const int wg = tid / 128;
    if (wg == 2) {  // producer warpgroup: one thread issues every copy
        // hand registers to the consumers: 128 x 24 + 256 x 240 is the
        // 384 x 168 the block was launched with
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid == 256) {
            hopper::mbar_arrive_expect_tx(q_full, PL::Q_BYTES);
#pragma unroll
            for (int c = 0; c < NCH; ++c)
                hopper::tma_load_4d(Qs + c * BM * RB, &p.tq, q_full, c * CH,
                                    q0, h, b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % STAGES;
                if (i >= STAGES)  // wait until both warpgroups freed the slot
                    hopper::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
                hopper::mbar_arrive_expect_tx(&full[s], 2 * PL::KV_BYTES);
                const int n0 = n_begin + i * BN;
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                    hopper::tma_load_4d(Ks + s * PL::KV_BYTES + c * BN * RB,
                                        &p.tk, &full[s], c * CH, n0, hk, b);
                    hopper::tma_load_4d(Vs + s * PL::KV_BYTES + c * BN * RB,
                                        &p.tv, &full[s], c * CH, n0, hk, b);
                }
            }
        }
    } else {
        // consumers, with 240 registers a thread for the two accumulators
        // and the tile of P in flight at once: warpgroup wg owns query rows
        // r_lo .. r_lo + 63, this thread rows row0 and row0 + 8
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int warp = (tid % 128) / 32, lane = tid % 32;
        const int r_lo = q0 + wg * 64;
        const int row0 = r_lo + warp * 16 + lane / 4;
        const int col0 = 2 * (lane % 4);
        const uint32_t q_base = hopper::smem_u32(Qs) + wg * 64 * RB;

        float o[HD / 2];           // the output accumulator, 64 x HD fp32
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
        float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

        float sc[BN / 2];          // scores, then probabilities, of one tile
        uint32_t pa[BN / 16][4];   // the previous tile's P, bf16 A operand
        float alpha[2];            // rescale of o for the tile just seen

        // S = q . k^T for tile i into sc (64 x 128 fp32, K-major operands from
        // shared memory), issued, not waited for
        auto issue_scores = [&](int i) {
            const int s = i % STAGES;
            hopper::mbar_wait(&full[s], (i / STAGES) & 1);
#pragma unroll
            for (int j = 0; j < BN / 2; ++j) sc[j] = 0.f;
            const uint32_t k_base = hopper::smem_u32(Ks + s * PL::KV_BYTES);
            hopper::fence_regs(sc);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const int c = kk * 16 / CH;
                const int off = (kk * 16 % CH) * 2;
                hopper::wgmma_ss_n128(
                    sc,
                    hopper::smem_desc(q_base + c * BM * RB + off, 16,
                                      8 * RB, RB),
                    hopper::smem_desc(k_base + c * BN * RB + off, 16,
                                      8 * RB, RB),
                    kk > 0);
            }
            hopper::wgmma_commit();
        };

        // O += P . V for tile i: P from registers, V MN-major (transposed)
        // from shared memory; issued, not waited for
        auto issue_values = [&](int i) {
            const uint32_t v_base =
                hopper::smem_u32(Vs + i % STAGES * PL::KV_BYTES);
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
                hopper::wgmma_rs_tb<HD>(
                    o, pa[kk],
                    hopper::smem_desc(v_base + kk * 16 * RB, BN * RB, 8 * RB,
                                      RB));
            hopper::wgmma_commit();
        };

        // online softmax of tile i on the accumulator, in log2 units: sc
        // becomes P (fp32), m and l move on, alpha rescales o
        auto softmax = [&](int i) {
            const int n0 = n_begin + i * BN;
            const bool masked = n0 + BN > p.T ||
                                (p.causal && n0 + BN - 1 > r_lo) ||
                                (p.window > 0 && r_lo + 63 - n0 >= p.window);
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int j = 0; j < BN / 2; ++j) {
                const int r = (j % 4) / 2;
                float x = sc[j] * p.scale_log2;
                if (masked) {
                    const int sq = row0 + 8 * r;
                    const int t = n0 + (j / 4) * 8 + col0 + (j % 2);
                    bool ok = t < p.T;
                    if (p.causal) ok = ok && t <= sq;
                    if (p.window > 0) ok = ok && sq - t < p.window;
                    if (!ok) x = -INFINITY;
                }
                sc[j] = x;
                mx[r] = fmaxf(mx[r], x);
            }
            float base[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m_run[r], mx[r]);
                base[r] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
                alpha[r] = exp2f(m_run[r] - base[r]);
                l_run[r] *= alpha[r];
                m_run[r] = m_new;
            }
#pragma unroll
            for (int j = 0; j < BN / 2; ++j) {
                const int r = (j % 4) / 2;
                sc[j] = exp2f(sc[j] - base[r]);
                l_run[r] += sc[j];
            }
        };

        // o *= alpha, and P to bf16 A fragments: once tile i - 1's P . V is
        // done with o and pa
        auto rescale_and_pack = [&]() {
#pragma unroll
            for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j % 4) / 2];
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
                for (int a = 0; a < 4; ++a)
                    pa[kk][a] = hopper::pack_bf16(sc[8 * kk + 2 * a],
                                                  sc[8 * kk + 2 * a + 1]);
        };

        // Tile i's scores are multiplied while tile i - 1's P . V runs, and
        // its softmax overlaps that product.
        hopper::mbar_wait(q_full, 0);
        if (n_tiles > 0) {
            issue_scores(0);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(sc);
            softmax(0);
            rescale_and_pack();
        }
        for (int i = 1; i < n_tiles; ++i) {
            issue_scores(i);           // fences the registers written above
            issue_values(i - 1);
            hopper::wgmma_wait<1>();   // the scores are in
            hopper::fence_regs(sc);
            softmax(i);
            hopper::wgmma_wait<0>();   // tile i - 1's P . V is in
            hopper::fence_regs(o);
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
            rescale_and_pack();
        }
        if (n_tiles > 0) {
            hopper::fence_regs(o);
            hopper::wgmma_fence();
            issue_values(n_tiles - 1);
            hopper::wgmma_wait<0>();
            hopper::fence_regs(o);
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&empty[(n_tiles - 1) % STAGES]);
        }

        __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out);
        const long long o_ss = static_cast<long long>(p.Hq) * HD;
        const long long o_sb = static_cast<long long>(p.S) * o_ss;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float l = l_run[r];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            const int sq = row0 + 8 * r;
            if (sq < p.S) {
                const float inv = 1.f / fmaxf(l, 1e-30f);
                __nv_bfloat16* orow = og + b * o_sb + sq * o_ss + h * HD;
#pragma unroll
                for (int nb = 0; nb < HD / 8; ++nb)
                    *reinterpret_cast<uint32_t*>(orow + nb * 8 + col0) =
                        hopper::pack_bf16(o[4 * nb + 2 * r] * inv,
                                          o[4 * nb + 2 * r + 1] * inv);
                if (lane % 4 == 0) {
                    const float m = m_run[r] == -INFINITY ? NEG_INF
                                                          : m_run[r] * LN2;
                    p.lse[static_cast<long long>(b * p.Hq + h) * p.S + sq] =
                        m + logf(fmaxf(l, 1e-30f));
                }
            }
        }
    }
}

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
    static EncodeFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found);
#endif
        if (found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeFn>(ptr);
    }
    return fn;
}

// A (hd, L, H, B) map of a bf16 (B, L, H, hd) tensor with element strides
// sb, ss, sh, read in boxes of (row_bytes / 2, rows, 1, 1).  A stride of an
// extent-1 dimension is never used; it is replaced by a valid one.
bool encode(CUtensorMap* map, const void* base, long long sb, long long ss,
            long long sh, int B, int L, int H, int hd, int rows,
            int row_bytes) {
    EncodeFn fn = encode_fn();
    if (fn == nullptr) return false;
    const long long any = 8;  // 16 bytes
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                                static_cast<cuuint64_t>(L),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>((L > 1 ? ss : any) * 2),
        static_cast<cuuint64_t>((H > 1 ? sh : any) * 2),
        static_cast<cuuint64_t>((B > 1 ? sb : any) * 2)};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(row_bytes / 2),
                               static_cast<cuuint32_t>(rows), 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
              const_cast<void*>(base), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const Params& a, int B, cudaStream_t stream) {
    using PL = Plan<HD>;
    Args p;
    if (!encode(&p.tq, a.q, a.q_sb, a.q_ss, a.q_sh, B, a.S, a.Hq, HD, BM,
                PL::RB) ||
        !encode(&p.tk, a.k, a.k_sb, a.k_ss, a.k_sh, B, a.T, a.Hkv, HD, BN,
                PL::RB) ||
        !encode(&p.tv, a.v, a.v_sb, a.v_ss, a.v_sh, B, a.T, a.Hkv, HD, BN,
                PL::RB))
        return static_cast<int>(cudaErrorInvalidValue);
    p.out = a.out;
    p.lse = a.lse;
    p.S = a.S;
    p.T = a.T;
    p.Hq = a.Hq;
    p.Hkv = a.Hkv;
    p.B = B;
    p.n_qtiles = (a.S + BM - 1) / BM;
    p.causal = a.causal;
    p.window = a.window;
    p.scale_log2 = a.sm_scale * LOG2E;
    const long long blocks =
        static_cast<long long>(p.n_qtiles) * a.Hq * B;
    if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = reinterpret_cast<const void*>(&attn_fwd_tc<HD>);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, PL::TOTAL);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)),
                           dim3(NTHREADS), args, PL::TOTAL, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

int launch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
    switch (hd) {
        case 32: return launch<32>(p, B, stream);
        case 64: return launch<64>(p, B, stream);
        case 128: return launch<128>(p, B, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace tc


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
    return is_bf16 ? tc::launch_hd(p, B, hd, st)
                   : launch_hd_fma(p, B, hd, st);
}
