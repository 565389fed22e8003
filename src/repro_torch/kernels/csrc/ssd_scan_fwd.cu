// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:35 (`_ssd_kernel`,
// launched by `_ssd_forward` at :82).  For x (B, S, H, P), dt (B, S, H) and
// A (H,) fp32, and B/C (B, S, G, N) with head h reading group h / (H / G),
// each chunk of `chunk` positions computes (ref.ssd, ssd_scan.py:9-12)
//
//     cs_t       = sum_{u <= t} dt_u A                (within the chunk)
//     y[t]       = sum_{s <= t} (C_t . B_s) e^{min(cs_t - cs_s, 0)} dt_s x_s
//                + e^{cs_t} C_t . state_in
//     state_out  = e^{cs_L} state_in + sum_t e^{cs_L - cs_t} dt_t B_t x_t^T
//
// and writes y (in x's type), the final (P, N) state and every chunk's
// ENTRY state (B, H, nc, P, N) fp32, which the backward replays from.
//
// What bounds it on the H100: at the training shape (B 4, S 1024, 144 heads
// = 3 clients x 48, P 64, N 128, G 3, chunk 256, bf16) it moves about 250 MB
// (x, y and the fp32 entry states dominate: 0.076 ms at 3.35 TB/s) for
// about 29 GFLOP of products (0.03 ms on the bf16 tensor cores; C . B^T
// counted once per group, as chip_smoke.py's _ssd_ops does), so bytes
// bound it.
//
// bf16 design (ssd_tc.cuh has the three steps, the operand splits and the
// cumsum; every product is mma.sync m16n8k16 from hopper_mma.cuh):
//   1. `chunk_state<true>`: each chunk's local state xs^T B, xs = x scaled
//      by e^{cs_L - cs_t} dt_t and split hi + lo -- (nc, H, Bb) blocks;
//   2. `state_pass<true>`: the entry states (fp32, in place, and split hi +
//      lo into a padded bf16 scratch) and the final state;
//   3. `chunk_out`: one block of 4 warps owns a (batch, group, run of up to
//      HEAD_RUN = 8 of the group's heads, chunk, 64-row query tile).  It
//      computes the group's score tiles C_q . B_k^T (64 x 64, K = N) for
//      the key tiles at or below the query tile ONCE, in registers (fp32);
//      then for each head of the run the inter-chunk term e^{cs_t} C .
//      state_in (the split state, two products), and for each key tile the
//      head's decay e^{min(cs_t - cs_s, 0)} and dt_s applied elementwise,
//      the weights W rounded to bf16 and multiplied by the head's x.  With
//      mamba2's one group a client (48 heads a group) a block shares each
//      score tile with 8 heads instead of recomputing it per head.  The
//      next head's split state and cs and the next x tile arrive by
//      cp.async while the current ones are multiplied.
// At the training shape that is 2304 blocks for step 1, 4608 for step 2
// and 1152 for step 3 (4 query tiles x 4 chunks x 4 batch x 3 groups x 6
// runs), two 109 KB blocks an SM; a B = 1 admission prefill of K = 2
// clients (96 heads, 2 groups, 1024 positions) is 384 blocks in step 3.
// fp32 inputs keep the exact FMA kernel below (`ssd_fwd`): one
// 256-thread block a (batch, head) walks its chunks, the state in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ssd_tc.cuh"

namespace {

constexpr int NT = 256;        // threads: a 16 x 16 grid (ty, tx)
constexpr int TL = 64;         // chunk rows per tile
constexpr int PM = 64;         // head dim P, padded
constexpr int NM = 128;        // state dim N, padded
constexpr int MAXL = 256;      // longest chunk
constexpr int PITCH = TL + 1;  // row pitch of [n][t] / [s][t] tiles

// shared memory, in floats
constexpr int OFF_CT = 0;                    // Ct[n][t]: C tile, transposed
constexpr int OFF_BT = OFF_CT + NM * PITCH;  // Bt[n][s]: B tile, transposed
constexpr int OFF_XS = OFF_BT + NM * PITCH;  // Xs[s][p]: x tile
constexpr int OFF_WS = OFF_XS + TL * PM;     // Ws[s][t]: weighted scores
constexpr int OFF_ST = OFF_WS + TL * PITCH;  // St[n][p]: state at chunk entry
constexpr int OFF_CS = OFF_ST + NM * PITCH;  // cs[MAXL]
constexpr int OFF_DT = OFF_CS + MAXL;        // dt[MAXL]
constexpr int SMEM_FLOATS = OFF_DT + MAXL;

struct Params {
    const void* x;        // (Bb, S, H, P)
    const float* dt;      // (Bb, S, H)
    const float* A;       // (H,)
    const void* B;        // (Bb, S, G, N)
    const void* C;        // (Bb, S, G, N)
    void* y;              // (Bb, S, H, P)
    float* final_state;   // (Bb, H, P, N)
    float* states_in;     // (Bb, H, nc, P, N)
    int S, H, P, G, N, chunk, nc;
};

// rows [r0, r0 + TL) of the chunk starting at sequence position `base`
// (rows at or past `rows` are zero), group g of B or C, into a transposed
// [n][r] tile.
__device__ void load_bc_t(float* dst, const float* src, const Params& p, int b,
                          int g, int base, int r0, int rows) {
    for (int i = threadIdx.x; i < TL * NM; i += NT) {
        const int r = i / NM, n = i % NM;
        float v = 0.f;
        if (r0 + r < rows && n < p.N)
            v = src[((static_cast<long long>(b) * p.S + base + r0 + r) * p.G
                     + g) * p.N + n];
        dst[n * PITCH + r] = v;
    }
}

// rows [r0, r0 + TL) of x for head h into Xs[r][p], each row scaled by
// scale[r0 + r] when `scale` is given.
__device__ void load_x(float* dst, const float* src, const Params& p, int b,
                       int h, int base, int r0, int rows,
                       const float* scale) {
    for (int i = threadIdx.x; i < TL * PM; i += NT) {
        const int r = i / PM, c = i % PM;
        float v = 0.f;
        if (r0 + r < rows && c < p.P) {
            v = src[((static_cast<long long>(b) * p.S + base + r0 + r) * p.H
                     + h) * p.P + c];
            if (scale) v *= scale[r0 + r];
        }
        dst[r * PM + c] = v;
    }
}

__global__ void __launch_bounds__(NT, 1) ssd_fwd(Params p) {
    extern __shared__ float smem[];
    float* Ct = smem + OFF_CT;
    float* Bt = smem + OFF_BT;
    float* Xs = smem + OFF_XS;
    float* Ws = smem + OFF_WS;
    float* St = smem + OFF_ST;
    float* cs = smem + OFF_CS;
    float* dts = smem + OFF_DT;

    const int h = blockIdx.x, b = blockIdx.y;
    const int g = h / (p.H / p.G);
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const float a = p.A[h];
    const float* x = static_cast<const float*>(p.x);
    const float* Bm = static_cast<const float*>(p.B);
    const float* Cm = static_cast<const float*>(p.C);
    float* y = static_cast<float*>(p.y);

    // state[p = ty + 16 i][n = tx + 16 j]
    float st[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[i][j] = 0.f;
    for (int i = tid; i < NM * PITCH; i += NT) St[i] = 0.f;

    for (int c = 0; c < p.nc; ++c) {
        const int base = c * p.chunk;
        const int rows = min(p.chunk, p.S - base);
        __syncthreads();                     // the previous chunk is done
        for (int r = tid; r < MAXL; r += NT)
            dts[r] = r < rows ? p.dt[(static_cast<long long>(b) * p.S + base + r)
                                     * p.H + h] : 0.f;
        __syncthreads();
        if (tid == 0) {
            float run = 0.f;
            for (int r = 0; r < MAXL; ++r) {
                run += dts[r] * a;           // dt = 0 past the chunk's end
                cs[r] = run;
            }
        }
        // the chunk's entry state, for the backward
        float* sin = p.states_in
            + ((static_cast<long long>(b) * p.H + h) * p.nc + c) * p.P * p.N;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int pp = ty + 16 * i, n = tx + 16 * j;
                if (pp < p.P && n < p.N) sin[pp * p.N + n] = st[i][j];
            }
        __syncthreads();

        for (int q0 = 0; q0 < rows; q0 += TL) {
            load_bc_t(Ct, Cm, p, b, g, base, q0, rows);
            __syncthreads();
            // inter-chunk term: e^{cs_t} C_t . state_in
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
            for (int n = 0; n < p.N; ++n) {
                float cv[4], sv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) cv[i] = Ct[n * PITCH + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) sv[j] = St[n * PITCH + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * sv[j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float e = expf(cs[q0 + ty + 16 * i]);
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] *= e;
            }
            // intra-chunk term over the key tiles at or below this one
            for (int k0 = 0; k0 <= q0; k0 += TL) {
                load_bc_t(Bt, Bm, p, b, g, base, k0, rows);
                load_x(Xs, x, p, b, h, base, k0, rows, nullptr);
                __syncthreads();
                float sc[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
                for (int n = 0; n < p.N; ++n) {
                    float cv[4], bv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) cv[i] = Ct[n * PITCH + ty + 16 * i];
#pragma unroll
                    for (int j = 0; j < 4; ++j) bv[j] = Bt[n * PITCH + tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int t = q0 + ty + 16 * i, s = k0 + tx + 16 * j;
                        const float w = (s <= t && t < rows)
                            ? sc[i][j] * expf(fminf(cs[t] - cs[s], 0.f)) * dts[s]
                            : 0.f;
                        Ws[(tx + 16 * j) * PITCH + ty + 16 * i] = w;
                    }
                __syncthreads();
#pragma unroll 4
                for (int s = 0; s < TL; ++s) {
                    float wv[4], xv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) wv[i] = Ws[s * PITCH + ty + 16 * i];
#pragma unroll
                    for (int j = 0; j < 4; ++j) xv[j] = Xs[s * PM + tx + 16 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
                }
                __syncthreads();             // before the tiles are reloaded
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = q0 + ty + 16 * i;
                if (t >= rows) continue;
                float* yrow = y + ((static_cast<long long>(b) * p.S + base + t) * p.H
                               + h) * p.P;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int pp = tx + 16 * j;
                    if (pp < p.P) yrow[pp] = acc[i][j];
                }
            }
        }

        // state update: e^{cs_L} state + sum_t e^{cs_L - cs_t} dt_t x_t B_t^T,
        // with the row scale e^{cs_L - cs_t} dt_t kept in dts
        const float cs_last = cs[rows - 1];
        __syncthreads();
        for (int r = tid; r < MAXL; r += NT)
            dts[r] = r < rows ? expf(cs_last - cs[r]) * dts[r] : 0.f;
        const float decay = expf(cs_last);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) st[i][j] *= decay;
        __syncthreads();
        for (int k0 = 0; k0 < rows; k0 += TL) {
            load_bc_t(Bt, Bm, p, b, g, base, k0, rows);
            load_x(Xs, x, p, b, h, base, k0, rows, dts);
            __syncthreads();
#pragma unroll 4
            for (int r = 0; r < TL; ++r) {
                float xv[4], bv[8];
#pragma unroll
                for (int i = 0; i < 4; ++i) xv[i] = Xs[r * PM + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 8; ++j) bv[j] = Bt[(tx + 16 * j) * PITCH + r];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) st[i][j] += xv[i] * bv[j];
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                St[(tx + 16 * j) * PITCH + ty + 16 * i] = st[i][j];
    }

    float* fin = p.final_state + (static_cast<long long>(b) * p.H + h) * p.P * p.N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int pp = ty + 16 * i, n = tx + 16 * j;
            if (pp < p.P && n < p.N) fin[pp * p.N + n] = st[i][j];
        }
}

int launch_fp32(Params p, int Bb, cudaStream_t stream) {
    constexpr int smem_bytes = SMEM_FLOATS * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        &ssd_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchKernel(&ssd_fwd, dim3(p.H, Bb), dim3(NT), args,
                           smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ssd_tc {

// Step 3 of the bf16 forward (the file's header).  Warp w owns query rows
// q0 + 16w + {g, g + 8} (g = lane / 4); its rows of the score tiles stay in
// registers (up to MAXT tiles of 16 x 64).  The heads' split entry states,
// cs and x tiles arrive by cp.async into double buffers: the next head's
// state and cs and the next x tile load while the current ones are
// multiplied.  109 KB of shared memory, two blocks an SM.
constexpr int OUT_XB = TL * PP;                // one x buffer, elements
constexpr int OUT_BK = TL * PN > 2 * OUT_XB ? TL * PN : 2 * OUT_XB;
constexpr int OUT_SMEM = (TL * PN + OUT_BK + 4 * PM * PN) * 2 + 4 * MAXL * 4;

__global__ void __launch_bounds__(NT, 2) chunk_out(Params p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Cq = reinterpret_cast<bf16*>(smem_raw);
    bf16* Bk = Cq + TL * PN;
    bf16* Xb = Bk;                     // two x buffers, after the scores
    bf16* St = Bk + OUT_BK;            // [buffer][hi, lo][PM][PN]
    float* csb = reinterpret_cast<float*>(St + 4 * PM * PN);  // [2][cs, dt]

    const int qt = blockIdx.x, c = blockIdx.y;
    const int r = blockIdx.z % p.runs, bg = blockIdx.z / p.runs;
    const int g = bg % p.G, b = bg / p.G;
    const int base = c * p.chunk, rows = chunk_rows(p, c), q0 = qt * TL;
    if (q0 >= rows) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long gn = static_cast<long long>(p.G) * p.N;
    const long long hp = static_cast<long long>(p.H) * p.P;
    int h_first, h_end;
    head_run(p, g, r, h_first, h_end);
    auto x_tile = [&](int h, int kt) {
        return p.x + (seq_row(p, b, base + kt * TL) * p.H + h) * p.P;
    };

    // the first head's state and cs, in flight during the score phase
    copy_state<NM>(St, St + PM * PN, PN, hl_of(p.st_hl, p, b, h_first, c),
                   0);
    copy_cs(csb, csb + MAXL, p, b, h_first, c, base, rows);
    hopper::cp_async_commit();

    // the group's score tiles S[t][s] = C_t . B_s, once for the run
    float sc[MAXT][8][4];
    load_tile<NM>(Cq, nullptr, PN, p.C + (seq_row(p, b, base + q0) * p.G + g)
                  * p.N, gn, rows - q0, p.N, nullptr);
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[kt][j][e] = 0.f;
        if (kt > qt) continue;
        __syncthreads();                       // Bk is free
        load_tile<NM>(Bk, nullptr, PN, p.B + (seq_row(p, b, base + kt * TL)
                      * p.G + g) * p.N, gn, rows - kt * TL, p.N, nullptr);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < NM / 16; ++kk) {
            uint32_t a[4];
            hopper::ldsm_a(a, Cq, PN, 16 * warp, 16 * kk);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bb[4];
                hopper::ldsm_b(bb, Bk, PN, 16 * np, 16 * kk);
                hopper::mma_bf16(sc[kt][2 * np], a, bb[0], bb[1]);
                hopper::mma_bf16(sc[kt][2 * np + 1], a, bb[2], bb[3]);
            }
        }
    }
    __syncthreads();                           // Bk becomes the x buffers
    copy_tile<PM>(Xb, PP, x_tile(h_first, 0), hp, rows, p.P);
    hopper::cp_async_commit();

    const int t_lo = q0 + 16 * warp + (lane >> 2), t_hi = t_lo + 8;
    int xi = 0;                                // x tiles consumed so far
    for (int h = h_first; h < h_end; ++h) {
        const int sb = (h - h_first) & 1;
        const bf16* Sth = St + sb * 2 * PM * PN;
        const bf16* Stl = Sth + PM * PN;
        const float* cs = csb + sb * 2 * MAXL;     // log2 units
        const float* dts = cs + MAXL;
        __syncthreads();                       // buffers sb ^ 1 are free
        if (h + 1 < h_end) {
            copy_state<NM>(St + (sb ^ 1) * 2 * PM * PN,
                           St + (sb ^ 1) * 2 * PM * PN + PM * PN, PN,
                           hl_of(p.st_hl, p, b, h + 1, c), 0);
            copy_cs(csb + (sb ^ 1) * 2 * MAXL, csb + (sb ^ 1) * 2 * MAXL + MAXL,
                    p, b, h + 1, c, base, rows);
        }
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();            // this head's state, x tile 0
        __syncthreads();
        // inter-chunk term: e^{cs_t} C_t . state_in
        float y[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NM / 16; ++kk) {
            uint32_t a[4];
            hopper::ldsm_a(a, Cq, PN, 16 * warp, 16 * kk);
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
                uint32_t bh[4], bl[4];
                hopper::ldsm_b(bh, Sth, PN, 16 * pp, 16 * kk);
                hopper::ldsm_b(bl, Stl, PN, 16 * pp, 16 * kk);
                hopper::mma_bf16(y[2 * pp], a, bh[0], bh[1]);
                hopper::mma_bf16(y[2 * pp], a, bl[0], bl[1]);
                hopper::mma_bf16(y[2 * pp + 1], a, bh[2], bh[3]);
                hopper::mma_bf16(y[2 * pp + 1], a, bl[2], bl[3]);
            }
        }
        const float e_lo = exp2f(cs[t_lo]), e_hi = exp2f(cs[t_hi]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            y[j][0] *= e_lo; y[j][1] *= e_lo;
            y[j][2] *= e_hi; y[j][3] *= e_hi;
        }
        // intra-chunk term: W x over the key tiles at or below q0
#pragma unroll
        for (int kt = 0; kt < MAXT; ++kt) {
            if (kt > qt) continue;
            const int k0 = kt * TL;
            // the next x tile -- this head's next, or the next head's
            // first -- into the other buffer
            __syncthreads();                   // the other buffer is free
            bf16* nxt = Xb + ((xi + 1) & 1) * OUT_XB;
            if (kt < qt)
                copy_tile<PM>(nxt, PP, x_tile(h, kt + 1), hp, rows - k0 - TL,
                              p.P);
            else if (h + 1 < h_end)
                copy_tile<PM>(nxt, PP, x_tile(h + 1, 0), hp, rows, p.P);
            hopper::cp_async_commit();
            hopper::cp_async_wait<1>();        // x tile xi
            __syncthreads();
            const bf16* Xk = Xb + (xi & 1) * OUT_XB;
#pragma unroll
            for (int kk = 0; kk < TL / 16; ++kk) {
                uint32_t a[4];
#pragma unroll
                for (int jj = 0; jj < 2; ++jj) {
                    const int j = 2 * kk + jj;
                    const int s0 = k0 + 8 * j + 2 * (lane & 3);
                    const float* v = sc[kt][j];
                    float w[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int t = e < 2 ? t_lo : t_hi, sp = s0 + (e & 1);
                        w[e] = sp <= t ? v[e] * exp2f(fminf(cs[t] - cs[sp],
                                                            0.f)) * dts[sp]
                                       : 0.f;
                    }
                    a[2 * jj] = hopper::pack_bf16(w[0], w[1]);
                    a[2 * jj + 1] = hopper::pack_bf16(w[2], w[3]);
                }
#pragma unroll
                for (int pp = 0; pp < 4; ++pp) {
                    uint32_t bb[4];
                    hopper::ldsm_b_t(bb, Xk, PP, 16 * pp, 16 * kk);
                    hopper::mma_bf16(y[2 * pp], a, bb[0], bb[1]);
                    hopper::mma_bf16(y[2 * pp + 1], a, bb[2], bb[3]);
                }
            }
            ++xi;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int pc = 8 * j + 2 * (lane & 3);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int t = half ? t_hi : t_lo;
                if (t >= rows) continue;
                bf16* yr = p.y + (seq_row(p, b, base + t) * p.H + h) * p.P;
                if (pc < p.P) yr[pc] = __float2bfloat16(y[j][2 * half]);
                if (pc + 1 < p.P)
                    yr[pc + 1] = __float2bfloat16(y[j][2 * half + 1]);
            }
        }
    }
    hopper::cp_async_wait<0>();
}

int launch_bf16(Params& p, cudaStream_t stream) {
    cudaError_t err = launch(&chunk_state<true>, dim3(p.nc, p.H, p.Bb),
                             dim3(NT), CS_SMEM, p, stream);
    if (err == cudaSuccess)
        err = launch(&state_pass<true>, dim3(PASS_BLOCKS, p.H, p.Bb),
                     dim3(PASS_NT), 0, p, stream);
    if (err == cudaSuccess)
        err = launch(&chunk_out, dim3(p.nt, p.nc, p.Bb * p.G * p.runs),
                     dim3(NT), OUT_SMEM, p, stream);
    return static_cast<int>(err);
}

}  // namespace ssd_tc

// Scratch (fp32 elements) the forward needs: the bf16 path's cs and split
// entry states.
extern "C" long long ssd_scan_fwd_workspace(int Bb, int S, int H, int P,
                                            int G, int N, int chunk,
                                            int is_bf16) {
    if (!is_bf16) return 0;
    ssd_tc::Params p = {};
    ssd_tc::set_shape(p, Bb, S, H, P, G, N, chunk);
    const long long bhn = static_cast<long long>(Bb) * H * p.nc;
    return (bhn * chunk + 3) / 4 * 4 + bhn * ssd_tc::HL / 2;
}

// Writes y, final_state and states_in; returns the first CUDA error (0 on
// success).  `workspace` holds ssd_scan_fwd_workspace(...) fp32 elements.
// The caller has checked shapes (P <= 64, N <= 128, chunk <= 256,
// H % G == 0), dtypes (x, B, C of one type; dt, A fp32), devices and that
// every tensor is contiguous.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y,
                            void* final_state, void* states_in,
                            void* workspace, int Bb, int S, int H, int P,
                            int G, int N, int chunk, int is_bf16,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        ssd_tc::Params p = {};
        ssd_tc::set_shape(p, Bb, S, H, P, G, N, chunk);
        p.x = static_cast<const __nv_bfloat16*>(x);
        p.dt = static_cast<const float*>(dt);
        p.A = static_cast<const float*>(A);
        p.B = static_cast<const __nv_bfloat16*>(B);
        p.C = static_cast<const __nv_bfloat16*>(C);
        p.y = static_cast<__nv_bfloat16*>(y);
        p.final_state = static_cast<float*>(final_state);
        p.states = static_cast<float*>(states_in);
        p.cs = static_cast<float*>(workspace);
        p.st_hl = reinterpret_cast<__nv_bfloat16*>(
            p.cs + (static_cast<long long>(Bb) * H * p.nc * chunk + 3) / 4 * 4);
        return ssd_tc::launch_bf16(p, st);
    }
    Params p = {};
    p.x = x;
    p.dt = static_cast<const float*>(dt);
    p.A = static_cast<const float*>(A);
    p.B = B;
    p.C = C;
    p.y = y;
    p.final_state = static_cast<float*>(final_state);
    p.states_in = static_cast<float*>(states_in);
    p.S = S;
    p.H = H;
    p.P = P;
    p.G = G;
    p.N = N;
    p.chunk = chunk;
    p.nc = (S + chunk - 1) / chunk;
    return launch_fp32(p, Bb, st);
}
