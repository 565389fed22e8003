// Mamba2 SSD on Hopper's bf16 tensor cores: what the forward
// (ssd_scan_fwd.cu) and the backward (ssd_scan_bwd.cu) share.
//
// Both follow Mamba2's own three steps instead of one block walking a
// (batch, head)'s chunks in order:
//   1. chunk-local states, every chunk at once (`chunk_state`): the
//      forward's sum_t e^{cs_L - cs_t} dt_t x_t B_t^T and the backward's
//      sum_t e^{cs_t} dy_t^T C_t, one (batch, chunk, head) a block;
//   2. a short sequential pass over the nc chunks (`state_pass`), each
//      thread four of a (batch, head)'s (P, N) state elements: it turns
//      the local states into the chunks' entry states (forward, in place)
//      or exit cotangents (backward), writes the final state, and writes
//      every state step 3 reads as a padded bf16 hi + lo pair, so step 3
//      copies them with cp.async and converts nothing;
//   3. the chunks' outputs, every chunk and 64-row tile at once
//      (ssd_scan_fwd.cu `chunk_out`; ssd_scan_bwd.cu `bwd_heads`,
//      `bwd_group`, `bwd_ddt`).
// So the blocks multiply by nc for one extra read and write of the fp32
// (Bb, H, nc, P, N) states.  Every product runs on mma.sync m16n8k16 (bf16
// in, fp32 accumulate) from tiles in shared memory (hopper_mma.cuh).  An
// fp32 operand that carries the state (the states, their cotangents, the
// rescaled rows that build them) is split into bf16 hi + lo and multiplied
// twice, so the state keeps about 16 bits; the decay-weighted scores and
// the scaled rows of the gradient products are rounded to bf16 once.
//
// The chunk cumsum cs_t = sum_{u<=t} dt_u A is a warp scan (8 positions a
// lane, then a shuffle scan of the lanes' sums); step 1 writes it, in
// order, to an fp32 scratch (Bb, H, nc, chunk) in log2 units (so each decay
// is one exp2f) that the later steps read, so every kernel sees the same
// cs.  Every decay is the exponent of a
// clamped difference, never a product e^{cs_t} e^{-cs_s}: cs falls to
// about -1200 within a chunk at mamba2's initialisation.  Positions past S
// read as zero (x, B, C, dt, dy), which leaves every sum unchanged, as the
// reference's zero padding does; P <= 64 and N <= 128 are zero-padded to
// 64 and 128.  Nothing is atomic: every sum runs in a fixed order.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace ssd_tc {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;             // threads of the tile kernels: 4 warps
constexpr int TL = 64;              // rows of a tile: 16 a warp
constexpr int PM = 64;              // P, padded
constexpr int NM = 128;             // N, padded
constexpr int MAXL = 256;           // longest chunk
constexpr int MAXT = MAXL / TL;     // tiles a chunk
constexpr int PP = PM + 8;          // pitch of a [row][p] bf16 tile
constexpr int PN = NM + 8;          // pitch of a [row][n] bf16 tile
constexpr int PH = NM / 2 + 8;      // pitch of a [row][n-half] bf16 tile
constexpr int HEAD_RUN = 8;         // heads a block of step 3 shares with
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PASS_NT = 256;        // threads of the state pass
constexpr int PASS_BLOCKS = PM * NM / 4 / PASS_NT;   // its blocks a state
constexpr long long HL = 2LL * PM * NM;  // bf16 elements of a split state
// per (batch, head, chunk) and position: the backward's row terms of ddt
enum { T_DDT = 0, T_QCOL = 1, T_R = 2, T_QROW = 3, T_INTER = 3 + MAXT,
       NTERMS = 5 + MAXT };

struct Params {
    const bf16* x;          // (Bb, S, H, P)
    const float* dt;        // (Bb, S, H)
    const float* A;         // (H,)
    const bf16* B;          // (Bb, S, G, N)
    const bf16* C;          // (Bb, S, G, N)
    bf16* y;                // (Bb, S, H, P), forward
    float* states;          // (Bb, H, nc, P, N): the chunks' entry states
    float* final_state;     // (Bb, H, P, N), forward
    const bf16* dy;         // (Bb, S, H, P), backward
    const float* dstate;    // (Bb, H, P, N) or null (zero), backward
    bf16* dx;               // backward outputs
    float* ddt;             // (Bb, S, H)
    float* dA_part;         // (Bb, H)
    bf16* dB;               // (Bb, S, G, N)
    bf16* dC;
    float* cs;              // scratch (Bb, H, nc, chunk), log2 units
    float* dS;              // scratch (Bb, H, nc, P, N): each chunk's share
                            //   of its entry state's cotangent (step 1)
    float* sdst;            // scratch (Bb, H, nc, PASS_BLOCKS): sum dS * state_in
    bf16* st_hl;            // scratch (Bb, H, nc, 2, PM, NM): entry states,
    bf16* ds_hl;            //   exit cotangents, split hi + lo and padded
    float* terms;           // scratch (Bb, H, nc, NTERMS, chunk)
    float* dscg;            // scratch (Bb, nc, G, runs, MAXT, MAXT, TL, TL)
    int Bb, S, H, P, G, N, chunk, nc, nt, hpg, run, runs;
};

// Rows of chunk c (the last may be short).
__device__ __forceinline__ int chunk_rows(const Params& p, int c) {
    return min(p.chunk, p.S - c * p.chunk);
}

// Row (b, t) of a (Bb, S, ...) tensor.
__device__ __forceinline__ long long seq_row(const Params& p, int b, int t) {
    return static_cast<long long>(b) * p.S + t;
}

__device__ __forceinline__ long long bhc(const Params& p, int b, int h,
                                         int c) {
    return (static_cast<long long>(b) * p.H + h) * p.nc + c;
}

__device__ __forceinline__ bool aligned16(const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// dst[r][c] = src[r * stride + c] for r < nrows and c < W, else 0, for the
// TL x WIDTH tile.  With `scale`, row r is multiplied by scale[r] (fp32)
// before it is rounded; with `lo`, dst and lo hold the bf16 hi + lo split
// of the scaled value.  Every thread starts all its loads (16 bytes each
// where the row is whole and aligned) before it stores any, so a tile
// costs one memory round trip.
template <int WIDTH>
__device__ void load_tile(bf16* dst, bf16* lo, int pitch, const bf16* src,
                          long long stride, int nrows, int W,
                          const float* scale) {
    constexpr int CPR = WIDTH / 8;                 // 8-element chunks a row
    constexpr int ITERS = TL * CPR / NT;
    uint4 raw[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
        const int i = threadIdx.x + it * NT;
        const int r = i / CPR, c = (i % CPR) * 8;
        const bf16* s = src + r * stride + c;
        if (r < nrows && c + 8 <= W && aligned16(s)) {
            raw[it] = __ldg(reinterpret_cast<const uint4*>(s));
        } else {
            bf16* e8 = reinterpret_cast<bf16*>(&raw[it]);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                e8[e] = r < nrows && c + e < W ? s[e] : __float2bfloat16(0.f);
        }
    }
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
        const int i = threadIdx.x + it * NT;
        const int r = i / CPR, c = (i % CPR) * 8;
        if (!scale && !lo) {
            *reinterpret_cast<uint4*>(dst + r * pitch + c) = raw[it];
            continue;
        }
        const bf16* e8 = reinterpret_cast<const bf16*>(&raw[it]);
        const float sc = scale && r < nrows ? scale[r] : 1.f;
        uint4 hi4, lo4;
        uint32_t* h32 = reinterpret_cast<uint32_t*>(&hi4);
        uint32_t* l32 = reinterpret_cast<uint32_t*>(&lo4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
            hopper::split_bf16x2(__bfloat162float(e8[2 * e]) * sc,
                                 __bfloat162float(e8[2 * e + 1]) * sc,
                                 h32[e], l32[e]);
        *reinterpret_cast<uint4*>(dst + r * pitch + c) = hi4;
        if (lo) *reinterpret_cast<uint4*>(lo + r * pitch + c) = lo4;
    }
}

// One warp: cs[r] = sum_{u <= r} dt_u A and dts[r] = dt_r for r < MAXL,
// with dt = 0 at r >= rows.
__device__ void chunk_cumsum(float* cs, float* dts, const Params& p, int b,
                             int h, int base, int rows) {
    constexpr int PER = MAXL / 32;
    const int lane = threadIdx.x & 31;
    const float a = p.A[h];
    float v[PER];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
        const int r = lane * PER + e;
        const float d = r < rows ? p.dt[seq_row(p, b, base + r) * p.H + h]
                                 : 0.f;
        dts[r] = d;
        run += d * a;
        v[e] = run;
    }
    float incl = run;                   // inclusive scan of the lanes' sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) cs[lane * PER + e] = excl + v[e];
}

// cp.async of chunk c's cs (in log2 units, from step 1's scratch; 0 past
// the chunk) and dt (0 past its rows) for head h into cs[MAXL], dts[MAXL];
// NT threads.
__device__ void copy_cs(float* cs, float* dts, const Params& p, int b, int h,
                        int c, int base, int rows) {
    const float* src = p.cs + bhc(p, b, h, c) * p.chunk;
#pragma unroll
    for (int it = 0; it < MAXL / NT; ++it) {
        const int r = threadIdx.x + it * NT;
        hopper::cp_async4(hopper::smem_u32(cs + r), r < p.chunk ? src + r : src,
                          r < p.chunk);
        const float* d = p.dt + seq_row(p, b, base + (r < rows ? r : 0)) * p.H
                         + h;
        hopper::cp_async4(hopper::smem_u32(dts + r), d, r < rows);
    }
}

// Step 1, one (chunk, head, batch) a block: out[p][n] = sum_t (s_t U[t][p])
// V[t][n] over the chunk, with (FWD) U = x, V = B, s_t = e^{cs_L - cs_t}
// dt_t -- the state the chunk adds -- or (backward) U = dy, V = C,
// s_t = e^{cs_t} -- the chunk's share of its entry state's cotangent.  The
// result goes to slot c of `states` / `dS`; cs goes to the scratch.  Warp
// w owns rows p = 16w..16w+15 and all 128 columns n; the scaled U is split
// hi + lo.
constexpr int CS_SMEM = (2 * TL * PP + TL * PN) * 2 + 3 * MAXL * 4;

template <bool FWD>
__global__ void __launch_bounds__(NT) chunk_state(Params p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Uh = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ul = Uh + TL * PP;
    bf16* Vs = Ul + TL * PP;
    float* cs = reinterpret_cast<float*>(Vs + TL * PN);
    float* dts = cs + MAXL;
    float* sc = dts + MAXL;

    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int g = h / p.hpg, base = c * p.chunk, rows = chunk_rows(p, c);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) chunk_cumsum(cs, dts, p, b, h, base, rows);
    __syncthreads();
    const float cs_last = cs[rows - 1];
    for (int r = threadIdx.x; r < MAXL; r += NT) {
        sc[r] = r >= rows ? 0.f
              : FWD ? expf(cs_last - cs[r]) * dts[r] : expf(cs[r]);
        if (r < p.chunk) p.cs[bhc(p, b, h, c) * p.chunk + r] = cs[r] * LOG2E;
    }
    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const bf16* U = FWD ? p.x : p.dy;
    const bf16* V = FWD ? p.B : p.C;
    for (int t0 = 0; t0 < rows; t0 += TL) {
        __syncthreads();                 // sc is written; tiles are free
        load_tile<PM>(Uh, Ul, PP,
                      U + (seq_row(p, b, base + t0) * p.H + h) * p.P,
                      static_cast<long long>(p.H) * p.P, rows - t0, p.P,
                      sc + t0);
        load_tile<NM>(Vs, nullptr, PN,
                      V + (seq_row(p, b, base + t0) * p.G + g) * p.N,
                      static_cast<long long>(p.G) * p.N, rows - t0, p.N,
                      nullptr);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TL / 16; ++kk) {
            uint32_t ah[4], al[4];
            hopper::ldsm_a_t(ah, Uh, PP, 16 * warp, 16 * kk);
            hopper::ldsm_a_t(al, Ul, PP, 16 * warp, 16 * kk);
#pragma unroll
            for (int np = 0; np < 8; ++np) {
                uint32_t bb[4];
                hopper::ldsm_b_t(bb, Vs, PN, 16 * np, 16 * kk);
                hopper::mma_bf16(acc[2 * np], ah, bb[0], bb[1]);
                hopper::mma_bf16(acc[2 * np], al, bb[0], bb[1]);
                hopper::mma_bf16(acc[2 * np + 1], ah, bb[2], bb[3]);
                hopper::mma_bf16(acc[2 * np + 1], al, bb[2], bb[3]);
            }
        }
    }
    float* out = (FWD ? p.states : p.dS)
        + bhc(p, b, h, c) * p.P * p.N;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int pr = 16 * warp + (lane >> 2) + 8 * (e >> 1);
            const int n = 8 * j + 2 * (lane & 3) + (e & 1);
            if (pr < p.P && n < p.N) out[pr * p.N + n] = acc[j][e];
        }
}

// Sum of one value a thread over a block of PASS_NT threads, in a fixed
// tree order; every thread gets it.
__device__ float block_sum(float v, float* red) {
    const int tid = threadIdx.x;
    red[tid] = v;
    __syncthreads();
    for (int s = PASS_NT / 2; s > 0; s >>= 1) {
        if (tid < s) red[tid] += red[tid + s];
        __syncthreads();
    }
    const float r = red[0];
    __syncthreads();
    return r;
}

// The split state of (b, h, c): hi plane, then lo, each [PM][NM].
__device__ __forceinline__ bf16* hl_of(bf16* base, const Params& p, int b,
                                       int h, int c) {
    return base + bhc(p, b, h, c) * HL;
}

// Writes the bf16 hi + lo split of v (padded row pr, columns n0..n0+3).
__device__ __forceinline__ void store_split4(bf16* hl, int pr, int n0,
                                             const float (&v)[4]) {
    uint2 h2, l2;
    uint32_t* h32 = reinterpret_cast<uint32_t*>(&h2);
    uint32_t* l32 = reinterpret_cast<uint32_t*>(&l2);
#pragma unroll
    for (int e = 0; e < 2; ++e)
        hopper::split_bf16x2(v[2 * e], v[2 * e + 1], h32[e], l32[e]);
    *reinterpret_cast<uint2*>(hl + pr * NM + n0) = h2;
    *reinterpret_cast<uint2*>(hl + PM * NM + pr * NM + n0) = l2;
}

// Four consecutive elements (row pr, columns n0..) of a (P, N) fp32 state,
// zero outside it.
__device__ __forceinline__ void load4(float (&v)[4], const float* st,
                                      const Params& p, int pr, int n0) {
    const float* q = st + static_cast<long long>(pr) * p.N + n0;
    if (pr < p.P && n0 + 4 <= p.N && aligned16(q)) {
        const float4 f = *reinterpret_cast<const float4*>(q);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            v[e] = pr < p.P && n0 + e < p.N ? q[e] : 0.f;
    }
}

// Step 2: PASS_BLOCKS blocks of PASS_NT threads a (batch, head), each
// thread owning four consecutive elements of the padded (PM, NM) state.
// Forward: s = 0, then for c = 0..nc-1 the slot's local state L becomes
// the entry state s (fp32, and split into st_hl) and s = e^{cs_L} s + L;
// the last s is the final state.  Backward: s = dstate, then for c =
// nc-1..0 the slot's L (in dS) gives way to the exit cotangent s (split
// into ds_hl), the entry state is split into st_hl, this block's share of
// sum s * state_in goes to sdst, and s = e^{cs_L} s + L.
template <bool FWD>
__global__ void __launch_bounds__(PASS_NT) state_pass(Params p) {
    __shared__ float red[PASS_NT];
    const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int q = part * PASS_NT + threadIdx.x;
    const int pr = q / (NM / 4), n0 = (q % (NM / 4)) * 4;
    const long long pn = static_cast<long long>(p.P) * p.N;
    const long long bh = static_cast<long long>(b) * p.H + h;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (!FWD && p.dstate) load4(s, p.dstate + bh * pn, p, pr, n0);
    // chunk k's decay, local state and (backward) entry state; the next
    // chunk's are loaded before this one's are written
    auto fetch = [&](int k, float& decay, float (&local)[4],
                     float (&sin)[4]) {
        const int c = FWD ? k : p.nc - 1 - k;
        const long long slot = bhc(p, b, h, c);
        decay = exp2f(p.cs[slot * p.chunk + chunk_rows(p, c) - 1]);
        load4(local, (FWD ? p.states : p.dS) + slot * pn, p, pr, n0);
        if (!FWD) load4(sin, p.states + slot * pn, p, pr, n0);
    };
    float decay, local[4], sin[4] = {0.f, 0.f, 0.f, 0.f};
    fetch(0, decay, local, sin);
    for (int k = 0; k < p.nc; ++k) {
        const int c = FWD ? k : p.nc - 1 - k;
        const long long slot = bhc(p, b, h, c);
        float nd = 0.f, nl[4], ns[4] = {0.f, 0.f, 0.f, 0.f};
        if (k + 1 < p.nc) fetch(k + 1, nd, nl, ns);
        if (FWD) {
            float* dst = p.states + slot * pn + static_cast<long long>(pr)
                         * p.N + n0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (pr < p.P && n0 + e < p.N) dst[e] = s[e];
            store_split4(hl_of(p.st_hl, p, b, h, c), pr, n0, s);
        } else {
            store_split4(hl_of(p.ds_hl, p, b, h, c), pr, n0, s);
            store_split4(hl_of(p.st_hl, p, b, h, c), pr, n0, sin);
            const float tot = block_sum(s[0] * sin[0] + s[1] * sin[1]
                                        + s[2] * sin[2] + s[3] * sin[3],
                                        red);
            if (threadIdx.x == 0) p.sdst[slot * PASS_BLOCKS + part] = tot;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[e] = decay * s[e] + local[e];
            local[e] = nl[e];
            sin[e] = ns[e];
        }
        decay = nd;
    }
    if (FWD) {
        float* dst = p.final_state + bh * pn + static_cast<long long>(pr)
                     * p.N + n0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (pr < p.P && n0 + e < p.N) dst[e] = s[e];
    }
}

// cp.async of a split state's PM rows and columns n0 .. n0 + WIDTH into
// hi and lo tiles of `pitch`.
template <int WIDTH>
__device__ void copy_state(bf16* hi, bf16* lo, int pitch, const bf16* hl,
                           int n0) {
    constexpr int CPR = WIDTH / 8;
    constexpr int ITERS = 2 * PM * CPR / NT;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
        const int i = threadIdx.x + it * NT;
        const int plane = i / (PM * CPR), rem = i % (PM * CPR);
        const int r = rem / CPR, c = (rem % CPR) * 8;
        hopper::cp_async16(hopper::smem_u32((plane ? lo : hi) + r * pitch + c),
                           hl + plane * PM * NM + r * NM + n0 + c, true);
    }
}

// A TL x WIDTH tile of rows `stride` apart into dst: cp.async (rows past
// nrows zero-filled) when the rows are whole and 16-byte aligned, else the
// synchronous load_tile.
template <int WIDTH>
__device__ void copy_tile(bf16* dst, int pitch, const bf16* src,
                          long long stride, int nrows, int W) {
    if (W != WIDTH || stride % 8 != 0 || !aligned16(src)) {
        load_tile<WIDTH>(dst, nullptr, pitch, src, stride, nrows, W,
                         nullptr);
        return;
    }
    constexpr int CPR = WIDTH / 8;
    constexpr int ITERS = TL * CPR / NT;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
        const int i = threadIdx.x + it * NT;
        const int r = i / CPR, c = (i % CPR) * 8;
        const bool ok = r < nrows;
        hopper::cp_async16(hopper::smem_u32(dst + r * pitch + c),
                           ok ? src + r * stride + c : src, ok);
    }
}

// The heads [first, end) of the run a step-3 block owns: run r of group g.
__device__ __forceinline__ void head_run(const Params& p, int g, int r,
                                         int& first, int& end) {
    first = g * p.hpg + r * p.run;
    end = min(first + p.run, (g + 1) * p.hpg);
}

// Fills p's shape fields and the head run (HEAD_RUN heads, or fewer when a
// group has fewer).
inline void set_shape(Params& p, int Bb, int S, int H, int P, int G, int N,
                      int chunk) {
    p.Bb = Bb; p.S = S; p.H = H; p.P = P; p.G = G; p.N = N;
    p.chunk = chunk;
    p.nc = (S + chunk - 1) / chunk;
    p.nt = (chunk + TL - 1) / TL;
    p.hpg = H / G;
    p.run = p.hpg < HEAD_RUN ? p.hpg : HEAD_RUN;
    p.runs = (p.hpg + p.run - 1) / p.run;
}

template <typename K>
inline cudaError_t launch(K kernel, dim3 grid, dim3 block, int smem,
                          Params& p, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    void* args[] = {&p};
    err = cudaLaunchKernel(kernel, grid, block, args, smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace ssd_tc
