// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// Replaces the plain-JAX backward of the TPU kernel's custom VJP,
// src/repro/kernels/ssd_scan.py:154 (`_ssd_chunk_bwd`): a reverse scan over
// the chunks in which each chunk's VJP is recomputed from the chunk-ENTRY
// state the forward saved (ssd_scan_fwd.cu), and the (P, N) state cotangent
// dS is carried from chunk to chunk.  Per chunk, with
// M[t,s] = (C_t . B_s) E[t,s] dt_s, E[t,s] = e^{min(cs_t - cs_s, 0)} on s <= t,
// and decay_t = e^{cs_L - cs_t}:
//
//     dM      = dY x^T            dSc = dM E dt_s           (t x s)
//     dx      = M^T dY  +  decay_t dt_t (B dS^T)            (P per row)
//     dB      = dSc^T C +  decay_t dt_t (x dS)              (N per row)
//     dC      = dSc B   +  e^{cs_t} dY state_in             (N per row)
//     ddt_s   = sum_t dM (C.B) E  +  decay_s R_s  +  A dda_s,
//               R_t = sum_{p,n} dS x_t B_t
//     dcs     from E (both ends), from e^{cs_t} in the inter term, and from
//             decay_t and e^{cs_L} in the state update;
//             dda = the reverse cumsum of dcs within the chunk
//     dA     += sum_t dda_t dt_t
//     dS_in   = e^{cs_L} dS + sum_t e^{cs_t} dY_t^T C_t
//
// exactly the chain rule of ref.ssd, including its clamp: where
// cs_t - cs_s is exactly 0 below the diagonal the exponent's gradient is
// halved, as autograd of min(., 0) does in JAX and PyTorch.
//
// What bounds it on the H100: at the training shape (B 4, S 1024, 144
// heads in 3 groups, P 64, N 128, bf16) it reads x, dt, B, C, dy and the
// entry states and writes dx, ddt, dB, dC: 319 MB, 0.095 ms at 3.35 TB/s.
// The products it needs are about 59 GFLOP (0.06 ms on the bf16 tensor
// cores): the scores again and dB, dC over the causal pairs once per
// group, dM and dx over the pairs per head, and four (l, P, N) products
// per head (chip_smoke.py's _ssd_ops).  So bytes bound it.
//
// bf16 design: Mamba2's three steps (ssd_tc.cuh), the state pass reversed,
// every product on mma.sync m16n8k16.
//   1. `chunk_state<false>`: each chunk's sum_t e^{cs_t} dy_t^T C_t (dy
//      scaled and split hi + lo), and cs, every chunk at once;
//   2. `state_pass<false>`: from the final state's cotangent backwards, the
//      exit cotangent dS of every chunk and sum dS * state_in; dS and the
//      entry states go to a padded bf16 scratch, split hi + lo;
//   3a. `bwd_heads`: one block of 4 warps owns a (batch, group, run of up to
//      8 heads, chunk, 64-row KEY tile).  It computes the group's score
//      tiles S^T = B_k . C_q^T for the query tiles at or above it ONCE
//      (fp32 in shared memory); then per head dM^T = x_k dy_q^T, M^T and
//      dSc^T = dM^T E dt elementwise, dx = M^T dy + e^{cs_L - cs_s} dt_s
//      (B dS^T) (complete: a key tile's dx needs only the query tiles at or
//      above it), the rows' ddt terms, and dSc^T summed over the run's heads
//      in shared memory (fp32, in head order).  That sum goes to an fp32
//      scratch, one (64 x 64) tile a (run, key tile, query tile).  Each
//      head's split dS, x, dy and cs arrive by cp.async, the next dy tile
//      while the current one is multiplied;
//   3b. `bwd_group`: one block owns a (batch, group, chunk, 64-row tile,
//      dB or dC, half of N).  dB = (sum over runs of dSc^T) C + sum_h
//      e^{cs_L - cs_s} dt_s (x_h dS_h), dC = (sum over runs of dSc) B +
//      sum_h e^{cs_t} (dy_h state_in_h): the group's score cotangent is
//      summed over all its heads BEFORE the dB and dC products, and each
//      head's state term is a product of unscaled bf16 rows with the split
//      state, scaled by row afterwards; dB and dC are written once, in the
//      input type, with no per-head partials.  The next head's tiles load
//      by cp.async while the current head's are multiplied;
//   3c. `bwd_ddt`: per (batch, head) the ddt terms of every position, the
//      reverse cumsum dda within each chunk, ddt and the head's dA.
// The clamp's halved gradient where cs_t - cs_s is exactly 0 below the
// diagonal is kept (f = 1/2 there).  At the training shape step 3a is 1152
// blocks (4 key tiles x 4 chunks x 4 batch x 3 groups x 6 runs; 209 KB of
// shared memory, one an SM), 3b 768 (90 KB, two an SM).  The scratch (cs,
// the state cotangents fp32 and split, the split entry states, the row
// terms and the summed score cotangents) is about 330 MB at the training
// shape, against the 604 MB of per-head dB and dC partials it replaces.
// fp32 inputs keep the exact FMA kernels below.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "ssd_tc.cuh"

namespace {

constexpr int NT = 256;        // threads: a 16 x 16 grid (ty, tx)
constexpr int TL = 64;         // chunk rows per tile
constexpr int PM = 64;         // head dim P, padded
constexpr int NM = 128;        // state dim N, padded
constexpr int MAXL = 256;      // longest chunk
constexpr int PITCH = TL + 1;  // odd row pitch against bank conflicts

// shared memory, in floats
constexpr int OFF_BT = 0;                     // Bt[n][s]; state_in St[n][p]
constexpr int OFF_XS = OFF_BT + NM * PITCH;   // Xs[s][p]
constexpr int OFF_CT = OFF_XS + TL * PITCH;   // Ct[n][t]
constexpr int OFF_DY = OFF_CT + NM * PITCH;   // DYs[t][p]
constexpr int OFF_MS = OFF_DY + TL * PM;      // Ms[t][s]
constexpr int OFF_DC = OFF_MS + TL * PITCH;   // DSc[t][s]
constexpr int OFF_DS = OFF_DC + TL * PITCH;   // dSs[n][p]: carried dS
constexpr int OFF_RED = OFF_DS + NM * PITCH;  // red[16][64]
constexpr int OFF_CS = OFF_RED + 16 * TL;     // cs[MAXL]
constexpr int OFF_DT = OFF_CS + MAXL;         // dt[MAXL]
constexpr int OFF_DCS = OFF_DT + MAXL;        // dcs[MAXL]
constexpr int OFF_DDT = OFF_DCS + MAXL;       // direct ddt[MAXL]
constexpr int OFF_R = OFF_DDT + MAXL;         // R[MAXL]
constexpr int SMEM_FLOATS = OFF_R + MAXL;

struct Params {
    const void* x;          // (Bb, S, H, P)
    const float* dt;        // (Bb, S, H)
    const float* A;         // (H,)
    const void* B;          // (Bb, S, G, N)
    const void* C;          // (Bb, S, G, N)
    const float* states_in; // (Bb, H, nc, P, N)
    const void* dy;         // (Bb, S, H, P)
    const float* dstate;    // (Bb, H, P, N); null means zero
    void* dx;               // (Bb, S, H, P)
    float* ddt;             // (Bb, S, H)
    float* dA_part;         // (Bb, H)
    float* dB_part;         // (Bb, S, H, N)
    float* dC_part;         // (Bb, S, H, N)
    int S, H, P, G, N, chunk, nc;
};

__device__ __forceinline__ long long row(const Params& p, int b, int pos) {
    return static_cast<long long>(b) * p.S + pos;
}

// rows [r0, r0 + TL) of B or C (group g) into a transposed [n][r] tile.
__device__ void load_bc_t(float* dst, const float* src, const Params& p, int b,
                          int g, int base, int r0, int rows) {
    for (int i = threadIdx.x; i < TL * NM; i += NT) {
        const int r = i / NM, n = i % NM;
        float v = 0.f;
        if (r0 + r < rows && n < p.N)
            v = src[(row(p, b, base + r0 + r) * p.G + g) * p.N + n];
        dst[n * PITCH + r] = v;
    }
}

// rows [r0, r0 + TL) of x or dy (head h) into a [r][p] tile of pitch `pitch`.
__device__ void load_rows(float* dst, int pitch, const float* src, const Params& p,
                          int b, int h, int base, int r0, int rows) {
    for (int i = threadIdx.x; i < TL * PM; i += NT) {
        const int r = i / PM, c = i % PM;
        float v = 0.f;
        if (r0 + r < rows && c < p.P)
            v = src[(row(p, b, base + r0 + r) * p.H + h) * p.P + c];
        dst[r * pitch + c] = v;
    }
}

__global__ void __launch_bounds__(NT, 1) ssd_bwd(Params p) {
    extern __shared__ float smem[];
    float* Bt = smem + OFF_BT;
    float* St = smem + OFF_BT;     // the entry state, once Bt is done
    float* Xs = smem + OFF_XS;
    float* Ct = smem + OFF_CT;
    float* DYs = smem + OFF_DY;
    float* Ms = smem + OFF_MS;
    float* DSc = smem + OFF_DC;
    float* dSs = smem + OFF_DS;
    float* red = smem + OFF_RED;
    float* cs = smem + OFF_CS;
    float* dts = smem + OFF_DT;
    float* dcs = smem + OFF_DCS;
    float* ddts = smem + OFF_DDT;
    float* Rs = smem + OFF_R;

    const int h = blockIdx.x, b = blockIdx.y;
    const int g = h / (p.H / p.G);
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const float a = p.A[h];
    const float* x = static_cast<const float*>(p.x);
    const float* Bm = static_cast<const float*>(p.B);
    const float* Cm = static_cast<const float*>(p.C);
    const float* dy = static_cast<const float*>(p.dy);
    float* dx = static_cast<float*>(p.dx);
    const long long bh = static_cast<long long>(b) * p.H + h;

    for (int i = tid; i < NM * PITCH; i += NT) {
        const int n = i / PITCH, pp = i % PITCH;
        dSs[i] = (p.dstate && n < p.N && pp < p.P)
            ? p.dstate[bh * p.P * p.N + pp * p.N + n] : 0.f;
    }
    float dA_acc = 0.f;                // thread 0's

    for (int c = p.nc - 1; c >= 0; --c) {
        const int base = c * p.chunk;
        const int rows = min(p.chunk, p.S - base);
        __syncthreads();
        for (int r = tid; r < MAXL; r += NT) {
            dts[r] = r < rows ? p.dt[row(p, b, base + r) * p.H + h] : 0.f;
            dcs[r] = 0.f;
            ddts[r] = 0.f;
            Rs[r] = 0.f;
        }
        __syncthreads();
        if (tid == 0) {
            float run = 0.f;
            for (int r = 0; r < MAXL; ++r) {
                run += dts[r] * a;
                cs[r] = run;
            }
        }
        __syncthreads();
        const float cs_last = cs[rows - 1];

        // ---- key tiles: dx, dB rows; dC via the partial buffer ----------
        for (int k0 = 0; k0 < rows; k0 += TL) {
            load_bc_t(Bt, Bm, p, b, g, base, k0, rows);
            load_rows(Xs, PITCH, x, p, b, h, base, k0, rows);
            float dxa[4][4], dBa[4][8], colQ[4], colD[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                colQ[i] = colD[i] = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) dxa[i][j] = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j) dBa[i][j] = 0.f;
            }
            for (int q0 = k0; q0 < rows; q0 += TL) {
                load_bc_t(Ct, Cm, p, b, g, base, q0, rows);
                load_rows(DYs, PM, dy, p, b, h, base, q0, rows);
                __syncthreads();
                // scores C.B^T and dM = dY x^T at (t = ty+16i, s = tx+16j)
                float sc[4][4], dm[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) sc[i][j] = dm[i][j] = 0.f;
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
#pragma unroll 4
                for (int pp = 0; pp < p.P; ++pp) {
                    float dv[4], xv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) dv[i] = DYs[(ty + 16 * i) * PM + pp];
#pragma unroll
                    for (int j = 0; j < 4; ++j) xv[j] = Xs[(tx + 16 * j) * PITCH + pp];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j) dm[i][j] += dv[i] * xv[j];
                }
                float rowQ[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int t = q0 + ty + 16 * i, s = k0 + tx + 16 * j;
                        float m = 0.f, dsc = 0.f;
                        if (s <= t && t < rows) {
                            const float expo = cs[t] - cs[s];
                            const float e = expf(fminf(expo, 0.f));
                            const float se = sc[i][j] * e;
                            m = se * dts[s];
                            dsc = dm[i][j] * e * dts[s];
                            colD[j] += dm[i][j] * se;
                            // the clamp's gradient: 1 below 0, 1/2 at 0
                            const float f = s < t ? (expo < 0.f ? 1.f : 0.5f)
                                                  : 0.f;
                            const float q = dm[i][j] * m * f;
                            rowQ[i] += q;
                            colQ[j] += q;
                        }
                        Ms[(ty + 16 * i) * PITCH + tx + 16 * j] = m;
                        DSc[(ty + 16 * i) * PITCH + tx + 16 * j] = dsc;
                    }
#pragma unroll
                for (int i = 0; i < 4; ++i) red[tx * TL + ty + 16 * i] = rowQ[i];
                __syncthreads();
                if (tid < TL) {
                    float sum = 0.f;
                    for (int k = 0; k < 16; ++k) sum += red[k * TL + tid];
                    dcs[q0 + tid] += sum;
                }
                // dx rows (s = ty+16i, p = tx+16j) += M^T dY;
                // dB rows (s = ty+16i, n = tx+16j) += dSc^T C
#pragma unroll 2
                for (int t = 0; t < TL; ++t) {
                    float mv[4], dsv[4], dv[4], cv[8];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        mv[i] = Ms[t * PITCH + ty + 16 * i];
                        dsv[i] = DSc[t * PITCH + ty + 16 * i];
                    }
#pragma unroll
                    for (int j = 0; j < 4; ++j) dv[j] = DYs[t * PM + tx + 16 * j];
#pragma unroll
                    for (int j = 0; j < 8; ++j) cv[j] = Ct[(tx + 16 * j) * PITCH + t];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) dxa[i][j] += mv[i] * dv[j];
#pragma unroll
                        for (int j = 0; j < 8; ++j) dBa[i][j] += dsv[i] * cv[j];
                    }
                }
                // dC rows (t = ty+16i, n = tx+16j) += dSc B
                float dca[4][8];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) dca[i][j] = 0.f;
#pragma unroll 2
                for (int s = 0; s < TL; ++s) {
                    float dsv[4], bv[8];
#pragma unroll
                    for (int i = 0; i < 4; ++i) dsv[i] = DSc[(ty + 16 * i) * PITCH + s];
#pragma unroll
                    for (int j = 0; j < 8; ++j) bv[j] = Bt[(tx + 16 * j) * PITCH + s];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 8; ++j) dca[i][j] += dsv[i] * bv[j];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int t = q0 + ty + 16 * i;
                    if (t >= rows) continue;
                    float* dst = p.dC_part + (row(p, b, base + t) * p.H + h) * p.N;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const int n = tx + 16 * j;
                        if (n < p.N) dst[n] = k0 == 0 ? dca[i][j] : dst[n] + dca[i][j];
                    }
                }
                __syncthreads();             // before the tiles are reloaded
            }

            // the state update's share of this key tile's rows:
            // BdS (s = ty+16i, p = tx+16j) and xdS (s = ty+16i, n = tx+16j)
            float bds[4][4], xds[4][8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) bds[i][j] = 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j) xds[i][j] = 0.f;
            }
#pragma unroll 4
            for (int n = 0; n < p.N; ++n) {
                float bv[4], sv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) bv[i] = Bt[n * PITCH + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) sv[j] = dSs[n * PITCH + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) bds[i][j] += bv[i] * sv[j];
            }
#pragma unroll 4
            for (int pp = 0; pp < p.P; ++pp) {
                float xv[4], sv[8];
#pragma unroll
                for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty + 16 * i) * PITCH + pp];
#pragma unroll
                for (int j = 0; j < 8; ++j) sv[j] = dSs[(tx + 16 * j) * PITCH + pp];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) xds[i][j] += xv[i] * sv[j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int s = k0 + ty + 16 * i;
                const float w = s < rows ? expf(cs_last - cs[s]) * dts[s] : 0.f;
                float rpart = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    rpart += Xs[(ty + 16 * i) * PITCH + tx + 16 * j] * bds[i][j];
                    dxa[i][j] += w * bds[i][j];
                }
#pragma unroll
                for (int j = 0; j < 8; ++j) dBa[i][j] += w * xds[i][j];
                red[tx * TL + ty + 16 * i] = rpart;
            }
            __syncthreads();
            if (tid < TL) {
                float sum = 0.f;
                for (int k = 0; k < 16; ++k) sum += red[k * TL + tid];
                Rs[k0 + tid] = sum;
            }
            __syncthreads();
            // column sums over t: dcs_s -= sum Q, direct ddt_s += sum dM C.B E
#pragma unroll
            for (int j = 0; j < 4; ++j) red[ty * TL + tx + 16 * j] = colQ[j];
            __syncthreads();
            if (tid < TL) {
                float sum = 0.f;
                for (int k = 0; k < 16; ++k) sum += red[k * TL + tid];
                dcs[k0 + tid] -= sum;
            }
            __syncthreads();
#pragma unroll
            for (int j = 0; j < 4; ++j) red[ty * TL + tx + 16 * j] = colD[j];
            __syncthreads();
            if (tid < TL) {
                float sum = 0.f;
                for (int k = 0; k < 16; ++k) sum += red[k * TL + tid];
                ddts[k0 + tid] += sum;
            }
            // write the finished dx and per-head dB rows of this key tile
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int s = k0 + ty + 16 * i;
                if (s >= rows) continue;
                float* dxr = dx + (row(p, b, base + s) * p.H + h) * p.P;
                float* dbr = p.dB_part + (row(p, b, base + s) * p.H + h) * p.N;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (tx + 16 * j < p.P) dxr[tx + 16 * j] = dxa[i][j];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (tx + 16 * j < p.N) dbr[tx + 16 * j] = dBa[i][j];
            }
            __syncthreads();                 // before Bt, Xs, red are reused
        }

        // ---- inter-chunk term and dS_in ------------------------------------
        const float* sin = p.states_in + (bh * p.nc + c) * p.P * p.N;
        for (int i = tid; i < NM * PITCH; i += NT) {
            const int n = i / PITCH, pp = i % PITCH;
            St[i] = (n < p.N && pp < p.P) ? sin[pp * p.N + n] : 0.f;
        }
        __syncthreads();
        // dS_in (p = ty+16i, n = tx+16j) starts at e^{cs_L} dS; the partial
        // sum of dS * state_in feeds dcs_L
        const float eL = expf(cs_last);
        float dsa[4][8];
        float sdst = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int k = (tx + 16 * j) * PITCH + ty + 16 * i;
                dsa[i][j] = eL * dSs[k];
                sdst += dSs[k] * St[k];
            }
        red[tid] = sdst;
        for (int q0 = 0; q0 < rows; q0 += TL) {
            load_bc_t(Ct, Cm, p, b, g, base, q0, rows);
            load_rows(DYs, PM, dy, p, b, h, base, q0, rows);
            __syncthreads();
            // Z = C . state_in at (t = ty+16i, p = tx+16j): dcs_t += dY . e^{cs_t} Z
            float z[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
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
                    for (int j = 0; j < 4; ++j) z[i][j] += cv[i] * sv[j];
            }
            float zpart[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float e = expf(cs[q0 + ty + 16 * i]);
                zpart[i] = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    zpart[i] += DYs[(ty + 16 * i) * PM + tx + 16 * j] * e * z[i][j];
            }
            // dC rows (t = ty+16i, n = tx+16j) += e^{cs_t} dY state_in
            float dca[4][8];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) dca[i][j] = 0.f;
#pragma unroll 4
            for (int pp = 0; pp < p.P; ++pp) {
                float dv[4], sv[8];
#pragma unroll
                for (int i = 0; i < 4; ++i) dv[i] = DYs[(ty + 16 * i) * PM + pp];
#pragma unroll
                for (int j = 0; j < 8; ++j) sv[j] = St[(tx + 16 * j) * PITCH + pp];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) dca[i][j] += dv[i] * sv[j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = q0 + ty + 16 * i;
                if (t >= rows) continue;
                const float e = expf(cs[t]);
                float* dst = p.dC_part + (row(p, b, base + t) * p.H + h) * p.N;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (tx + 16 * j < p.N) dst[tx + 16 * j] += e * dca[i][j];
            }
            // dS_in (p = ty+16i, n = tx+16j) += sum_t e^{cs_t} dY[t,p] C[t,n]
#pragma unroll 2
            for (int t = 0; t < TL; ++t) {
                const float e = expf(cs[q0 + t]);
                float dv[4], cv[8];
#pragma unroll
                for (int i = 0; i < 4; ++i) dv[i] = e * DYs[t * PM + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 8; ++j) cv[j] = Ct[(tx + 16 * j) * PITCH + t];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) dsa[i][j] += dv[i] * cv[j];
            }
            __syncthreads();                 // red[] holds sdst: use Ms
#pragma unroll
            for (int i = 0; i < 4; ++i) Ms[tx * TL + ty + 16 * i] = zpart[i];
            __syncthreads();
            if (tid < TL) {
                float sum = 0.f;
                for (int k = 0; k < 16; ++k) sum += Ms[k * TL + tid];
                dcs[q0 + tid] += sum;
            }
            __syncthreads();                 // before the tiles are reloaded
        }

        // ---- dcs -> dda (reverse cumsum), ddt, dA ---------------------------
        if (tid == 0) {
            float total = 0.f;
            for (int k = 0; k < NT; ++k) total += red[k];   // sum dS * state_in
            total *= eL;
            for (int t = 0; t < rows; ++t) {
                const float v = expf(cs_last - cs[t]) * dts[t] * Rs[t];
                total += v;
                dcs[t] -= v;
            }
            dcs[rows - 1] += total;
            float run = 0.f;
            for (int t = rows - 1; t >= 0; --t) {
                run += dcs[t];
                dcs[t] = run;                // now dda
                dA_acc += run * dts[t];
            }
        }
        __syncthreads();
        for (int t = tid; t < rows; t += NT)
            p.ddt[row(p, b, base + t) * p.H + h] =
                ddts[t] + expf(cs_last - cs[t]) * Rs[t] + a * dcs[t];
        // the carried state cotangent moves to the previous chunk
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                dSs[(tx + 16 * j) * PITCH + ty + 16 * i] = dsa[i][j];
    }
    if (tid == 0) p.dA_part[bh] = dA_acc;
}

// dB, dC (Bb, S, G, N) = the sums over each group's heads of the per-head
// partials (Bb, S, H, N), in head order.
__global__ void __launch_bounds__(NT) ssd_reduce_heads(
        const float* dB_part, const float* dC_part, float* dB, float* dC,
        long long total, int H, int G, int N) {
    const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
    if (i >= total) return;
    const int n = static_cast<int>(i % N);
    const long long rg = i / N;               // (b, s) * G + g
    const int g = static_cast<int>(rg % G);
    const long long bs = rg / G;
    const int rep = H / G;
    const long long first = (bs * H + static_cast<long long>(g) * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
        sb += dB_part[first + static_cast<long long>(r) * N];
        sc += dC_part[first + static_cast<long long>(r) * N];
    }
    dB[i] = sb;
    dC[i] = sc;
}


int launch_fp32(Params p, int Bb, float* dB, float* dC, cudaStream_t stream) {
    constexpr int smem_bytes = SMEM_FLOATS * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        &ssd_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchKernel(&ssd_bwd, dim3(p.H, Bb), dim3(NT), args,
                           smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    long long total = static_cast<long long>(Bb) * p.S * p.G * p.N;
    int H = p.H, G = p.G, N = p.N;
    void* rargs[] = {&p.dB_part, &p.dC_part, &dB, &dC, &total, &H, &G, &N};
    err = cudaLaunchKernel(&ssd_reduce_heads,
                           dim3(static_cast<unsigned>((total + NT - 1) / NT)),
                           dim3(NT), rargs, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ssd_tc {

__device__ __forceinline__ float* terms_of(const Params& p, int b, int h,
                                           int c, int k) {
    return p.terms + (bhc(p, b, h, c) * NTERMS + k) * p.chunk;
}

// The summed score cotangent tile (key tile kt, query tile qt) of run r:
// [s][t], TL x TL fp32.
__device__ __forceinline__ float* dscg_tile(const Params& p, int b, int c,
                                            int g, int r, int kt, int qt) {
    return p.dscg + ((((static_cast<long long>(b) * p.nc + c) * p.G + g)
                      * p.runs + r) * MAXT * MAXT + kt * MAXT + qt)
                    * TL * TL;
}

// Step 3a (the file's header).  Warp w owns key rows k0 + 16w + {g, g + 8}
// (g = lane / 4) of every product; columns are query positions t or P.
constexpr int HEADS_SBUF = 4 * MAXT * 8 * 32;  // float4: S^T, and dSc^T
constexpr int HEADS_SMEM = (3 * TL * PN + 3 * TL * PP) * 2
                           + 2 * HEADS_SBUF * 16 + (2 * MAXL + 4 * TL) * 4;

__global__ void __launch_bounds__(NT, 1) bwd_heads(Params p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Bk = reinterpret_cast<bf16*>(smem_raw);
    bf16* Cq = Bk + TL * PN;             // the score phase; then dS hi, lo
    bf16* dSh = Cq;
    bf16* dSl = Cq + TL * PN;
    bf16* Xk = dSl + TL * PN;
    bf16* DYb = Xk + TL * PP;            // two dy buffers
    float4* Sbuf = reinterpret_cast<float4*>(DYb + 2 * TL * PP);
    float4* Gbuf = Sbuf + HEADS_SBUF;
    float* cs = reinterpret_cast<float*>(Gbuf + HEADS_SBUF);
    float* dts = cs + MAXL;
    float* red = dts + MAXL;             // [4 warps][TL]

    const int kt = blockIdx.x, c = blockIdx.y;
    const int r = blockIdx.z % p.runs, bg = blockIdx.z / p.runs;
    const int g = bg % p.G, b = bg / p.G;
    const int base = c * p.chunk, rows = chunk_rows(p, c), k0 = kt * TL;
    if (k0 >= rows) return;
    const int nq = (rows + TL - 1) / TL;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long gn = static_cast<long long>(p.G) * p.N;
    const long long hp = static_cast<long long>(p.H) * p.P;
    int h_first, h_end;
    head_run(p, g, r, h_first, h_end);

    // the group's S^T[s][t] = B_s . C_t, once for the run; dSc^T sums = 0
    load_tile<NM>(Bk, nullptr, PN, p.B + (seq_row(p, b, base + k0) * p.G + g)
                  * p.N, gn, rows - k0, p.N, nullptr);
    for (int qt = kt; qt < nq; ++qt) {
        __syncthreads();                       // Cq is free
        load_tile<NM>(Cq, nullptr, PN, p.C + (seq_row(p, b, base + qt * TL)
                      * p.G + g) * p.N, gn, rows - qt * TL, p.N, nullptr);
        __syncthreads();
        float st[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NM / 16; ++kk) {
            uint32_t a[4];
            hopper::ldsm_a(a, Bk, PN, 16 * warp, 16 * kk);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bb[4];
                hopper::ldsm_b(bb, Cq, PN, 16 * np, 16 * kk);
                hopper::mma_bf16(st[2 * np], a, bb[0], bb[1]);
                hopper::mma_bf16(st[2 * np + 1], a, bb[2], bb[3]);
            }
        }
        const int qi = qt - kt;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int k = ((warp * MAXT + qi) * 8 + j) * 32 + lane;
            Sbuf[k] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
            Gbuf[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }

    const int s_lo = k0 + 16 * warp + (lane >> 2), s_hi = s_lo + 8;
    const int xr_lo = s_lo - k0, xr_hi = s_hi - k0;   // rows of Xk
    auto dy_tile = [&](int h, int qt) {
        return p.dy + (seq_row(p, b, base + qt * TL) * p.H + h) * p.P;
    };
    int di = 0;                                // dy tiles consumed so far
    for (int h = h_first; h < h_end; ++h) {
        __syncthreads();                       // cs, dts, dS, Xk are free
        copy_state<NM>(dSh, dSl, PN, hl_of(p.ds_hl, p, b, h, c), 0);
        copy_tile<PM>(Xk, PP, p.x + (seq_row(p, b, base + k0) * p.H + h)
                      * p.P, hp, rows - k0, p.P);
        copy_tile<PM>(DYb + (di & 1) * TL * PP, PP, dy_tile(h, kt), hp,
                      rows - k0, p.P);
        copy_cs(cs, dts, p, b, h, c, base, rows);   // log2 units
        hopper::cp_async_commit();
        hopper::cp_async_wait<0>();
        __syncthreads();
        const float cs_last = cs[rows - 1];
        // the state update's share: BdS[s][p] = B_s . dS[p]; R_s = x_s . BdS_s
        float dx[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dx[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NM / 16; ++kk) {
            uint32_t a[4];
            hopper::ldsm_a(a, Bk, PN, 16 * warp, 16 * kk);
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
                uint32_t bh[4], bl[4];
                hopper::ldsm_b(bh, dSh, PN, 16 * pp, 16 * kk);
                hopper::ldsm_b(bl, dSl, PN, 16 * pp, 16 * kk);
                hopper::mma_bf16(dx[2 * pp], a, bh[0], bh[1]);
                hopper::mma_bf16(dx[2 * pp], a, bl[0], bl[1]);
                hopper::mma_bf16(dx[2 * pp + 1], a, bh[2], bh[3]);
                hopper::mma_bf16(dx[2 * pp + 1], a, bl[2], bl[3]);
            }
        }
        float r_lo = 0.f, r_hi = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int pc = 8 * j + 2 * (lane & 3);
            r_lo += __bfloat162float(Xk[xr_lo * PP + pc]) * dx[j][0]
                  + __bfloat162float(Xk[xr_lo * PP + pc + 1]) * dx[j][1];
            r_hi += __bfloat162float(Xk[xr_hi * PP + pc]) * dx[j][2]
                  + __bfloat162float(Xk[xr_hi * PP + pc + 1]) * dx[j][3];
        }
        const float w_lo = s_lo < rows ? exp2f(cs_last - cs[s_lo]) * dts[s_lo]
                                       : 0.f;
        const float w_hi = s_hi < rows ? exp2f(cs_last - cs[s_hi]) * dts[s_hi]
                                       : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            dx[j][0] *= w_lo; dx[j][1] *= w_lo;
            dx[j][2] *= w_hi; dx[j][3] *= w_hi;
        }
        float ddt_lo = 0.f, ddt_hi = 0.f, qc_lo = 0.f, qc_hi = 0.f;
        for (int qt = kt; qt < nq; ++qt) {
            const int q0 = qt * TL, qi = qt - kt;
            __syncthreads();                   // the other dy buffer, red free
            if (qt + 1 < nq)
                copy_tile<PM>(DYb + ((di + 1) & 1) * TL * PP, PP,
                              dy_tile(h, qt + 1), hp, rows - q0 - TL, p.P);
            hopper::cp_async_commit();
            hopper::cp_async_wait<1>();        // dy tile di
            __syncthreads();
            const bf16* DYq = DYb + (di & 1) * TL * PP;
            ++di;
            // dM^T[s][t] = x_s . dy_t
            float dm[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) dm[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < PM / 16; ++kk) {
                uint32_t a[4];
                hopper::ldsm_a(a, Xk, PP, 16 * warp, 16 * kk);
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                    uint32_t bb[4];
                    hopper::ldsm_b(bb, DYq, PP, 16 * np, 16 * kk);
                    hopper::mma_bf16(dm[2 * np], a, bb[0], bb[1]);
                    hopper::mma_bf16(dm[2 * np + 1], a, bb[2], bb[3]);
                }
            }
            // elementwise: M^T, dSc^T (summed over the run's heads), the
            // rows' ddt and dcs terms and the columns' dcs terms
            float qrow[8][2];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int k = ((warp * MAXT + qi) * 8 + j) * 32 + lane;
                const float4 sv = Sbuf[k];
                float4 gv = Gbuf[k];
                const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
                float gs[4] = {gv.x, gv.y, gv.z, gv.w};
                const int t0 = q0 + 8 * j + 2 * (lane & 3);
                qrow[j][0] = qrow[j][1] = 0.f;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int s = e < 2 ? s_lo : s_hi, t = t0 + (e & 1);
                    float m = 0.f;
                    if (s <= t && t < rows) {
                        const float expo = cs[t] - cs[s];   // log2 units
                        const float ex = exp2f(fminf(expo, 0.f));
                        const float se = sc[e] * ex;
                        m = se * dts[s];
                        gs[e] += dm[j][e] * ex * dts[s];
                        const float dse = dm[j][e] * se;
                        // the clamp's gradient: 1 below 0, 1/2 at 0
                        const float f = s < t ? (expo < 0.f ? 1.f : 0.5f)
                                              : 0.f;
                        const float q = dm[j][e] * m * f;
                        if (e < 2) { ddt_lo += dse; qc_lo += q; }
                        else { ddt_hi += dse; qc_hi += q; }
                        qrow[j][e & 1] += q;
                    }
                    dm[j][e] = m;              // dm now holds M^T
                }
                Gbuf[k] = make_float4(gs[0], gs[1], gs[2], gs[3]);
            }
            // dx += M^T dy
#pragma unroll
            for (int kk = 0; kk < TL / 16; ++kk) {
                uint32_t a[4];
                hopper::acc_to_a(a, dm, kk);
#pragma unroll
                for (int pp = 0; pp < 4; ++pp) {
                    uint32_t bb[4];
                    hopper::ldsm_b_t(bb, DYq, PP, 16 * pp, 16 * kk);
                    hopper::mma_bf16(dx[2 * pp], a, bb[0], bb[1]);
                    hopper::mma_bf16(dx[2 * pp + 1], a, bb[2], bb[3]);
                }
            }
            // column sums of Q over the key rows: this key tile's share of
            // the query positions' dcs, summed over the warps in order
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float v = qrow[j][e];
                    v += __shfl_xor_sync(0xffffffffu, v, 4);
                    v += __shfl_xor_sync(0xffffffffu, v, 8);
                    v += __shfl_xor_sync(0xffffffffu, v, 16);
                    if (lane < 4) red[warp * TL + 8 * j + 2 * lane + e] = v;
                }
            __syncthreads();
            if (threadIdx.x < TL && q0 + threadIdx.x < rows) {
                const int u = threadIdx.x;
                terms_of(p, b, h, c, T_QROW + kt)[q0 + u] =
                    red[u] + red[TL + u] + red[2 * TL + u] + red[3 * TL + u];
            }
        }
        // the key rows' terms: quad sums over the columns
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
            r_lo += __shfl_xor_sync(0xffffffffu, r_lo, m);
            r_hi += __shfl_xor_sync(0xffffffffu, r_hi, m);
            ddt_lo += __shfl_xor_sync(0xffffffffu, ddt_lo, m);
            ddt_hi += __shfl_xor_sync(0xffffffffu, ddt_hi, m);
            qc_lo += __shfl_xor_sync(0xffffffffu, qc_lo, m);
            qc_hi += __shfl_xor_sync(0xffffffffu, qc_hi, m);
        }
        if ((lane & 3) == 0) {
            if (s_lo < rows) {
                terms_of(p, b, h, c, T_DDT)[s_lo] = ddt_lo;
                terms_of(p, b, h, c, T_QCOL)[s_lo] = qc_lo;
                terms_of(p, b, h, c, T_R)[s_lo] = r_lo;
            }
            if (s_hi < rows) {
                terms_of(p, b, h, c, T_DDT)[s_hi] = ddt_hi;
                terms_of(p, b, h, c, T_QCOL)[s_hi] = qc_hi;
                terms_of(p, b, h, c, T_R)[s_hi] = r_hi;
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int pc = 8 * j + 2 * (lane & 3);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int s = half ? s_hi : s_lo;
                if (s >= rows) continue;
                bf16* dxr = p.dx + (seq_row(p, b, base + s) * p.H + h) * p.P;
                if (pc < p.P) dxr[pc] = __float2bfloat16(dx[j][2 * half]);
                if (pc + 1 < p.P)
                    dxr[pc + 1] = __float2bfloat16(dx[j][2 * half + 1]);
            }
        }
    }
    hopper::cp_async_wait<0>();
    // the run's summed dSc^T tiles, [s][t]
    for (int qt = kt; qt < nq; ++qt) {
        float* dst = dscg_tile(p, b, c, g, r, kt, qt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float4 gv = Gbuf[((warp * MAXT + qt - kt) * 8 + j) * 32
                                   + lane];
            const int tc = 8 * j + 2 * (lane & 3);
            *reinterpret_cast<float2*>(dst + xr_lo * TL + tc) =
                make_float2(gv.x, gv.y);
            *reinterpret_cast<float2*>(dst + xr_hi * TL + tc) =
                make_float2(gv.z, gv.w);
        }
    }
}

// Step 3b (the file's header).  blockIdx.x = tile j, dB (0) or dC (1), half
// of N; warp w owns rows j0 + 16w + {g, g + 8} and the half's 64 columns.
constexpr int GROUP_SMEM = (2 * TL * PH + 3 * TL * PP + 4 * PM * PH) * 2;

__global__ void __launch_bounds__(NT) bwd_group(Params p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Vt = reinterpret_cast<bf16*>(smem_raw);  // C_q or B_k, [row][n]
    bf16* Cj = Vt + TL * PH;                       // C of the tile (dC)
    bf16* Gs = Cj + TL * PH;                       // summed dSc^T, [s][t]
    bf16* Ub = Gs + TL * PP;                       // 2 x: x or dy, [row][p]
    bf16* Mb = Ub + 2 * TL * PP;                   // 2 x: dS or state_in
                                                   //   hi, lo [p][n-half]
    const int j = blockIdx.x >> 2, is_dc = (blockIdx.x >> 1) & 1;
    const int nh = blockIdx.x & 1, c = blockIdx.y;
    const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
    const int base = c * p.chunk, rows = chunk_rows(p, c), j0 = j * TL;
    if (j0 >= rows) return;
    const int nq = (rows + TL - 1) / TL, n0 = nh * (NM / 2);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lr_lo = 16 * warp + (lane >> 2), lr_hi = lr_lo + 8;
    const long long gn = static_cast<long long>(p.G) * p.N;
    const long long hp = static_cast<long long>(p.H) * p.P;
    const bf16* V = is_dc ? p.B : p.C;
    const int h0 = p.hpg * g, h1 = p.hpg * (g + 1);
    // head h's rows of x (dB) or dy (dC), and its split dS (dB) or entry
    // state (dC), into buffer k
    auto fetch_head = [&](int h, int k) {
        copy_tile<PM>(Ub + k * TL * PP, PP, (is_dc ? p.dy : p.x)
                      + (seq_row(p, b, base + j0) * p.H + h) * p.P, hp,
                      rows - j0, p.P);
        copy_state<NM / 2>(Mb + k * 2 * PM * PH, Mb + k * 2 * PM * PH
                           + PM * PH, PH, hl_of(is_dc ? p.st_hl : p.ds_hl,
                                                p, b, h, c), n0);
    };
    fetch_head(h0, 0);                             // in flight meanwhile
    hopper::cp_async_commit();

    float acc[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
    if (is_dc)
        load_tile<NM / 2>(Cj, nullptr, PH, p.C + (seq_row(p, b, base + j0)
                          * p.G + g) * p.N + n0, gn, rows - j0, p.N - n0,
                          nullptr);
    // the group's score cotangent, summed over the runs in order and
    // rounded to bf16 in Gs: dB rows s take sum_{t >= s} dSc^T[s][t] C_t,
    // dC rows t take sum_{s <= t} dSc[t][s] B_s (Gs read transposed)
    constexpr int GV = TL * TL / 4 / NT;           // float4 a thread a tile
    const int o_lo = is_dc ? 0 : j, o_hi = is_dc ? j : nq - 1;
    for (int o = o_lo; o <= o_hi; ++o) {
        float4 sum[GV];
#pragma unroll
        for (int v = 0; v < GV; ++v) sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = 0; r < p.runs; ++r) {
            const float4* tile = reinterpret_cast<const float4*>(
                is_dc ? dscg_tile(p, b, c, g, r, o, j)
                      : dscg_tile(p, b, c, g, r, j, o));
            float4 f[GV];
#pragma unroll
            for (int v = 0; v < GV; ++v) f[v] = tile[threadIdx.x + v * NT];
#pragma unroll
            for (int v = 0; v < GV; ++v) {
                sum[v].x += f[v].x; sum[v].y += f[v].y;
                sum[v].z += f[v].z; sum[v].w += f[v].w;
            }
        }
        __syncthreads();                           // Vt and Gs are free
#pragma unroll
        for (int v = 0; v < GV; ++v) {
            const int i = (threadIdx.x + v * NT) * 4;
            uint2 pk;
            pk.x = hopper::pack_bf16(sum[v].x, sum[v].y);
            pk.y = hopper::pack_bf16(sum[v].z, sum[v].w);
            *reinterpret_cast<uint2*>(Gs + (i / TL) * PP + i % TL) = pk;
        }
        load_tile<NM / 2>(Vt, nullptr, PH, V + (seq_row(p, b, base + o * TL)
                          * p.G + g) * p.N + n0, gn, rows - o * TL,
                          p.N - n0, nullptr);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TL / 16; ++kk) {
            uint32_t a[4];
            if (is_dc) hopper::ldsm_a_t(a, Gs, PP, 16 * warp, 16 * kk);
            else hopper::ldsm_a(a, Gs, PP, 16 * warp, 16 * kk);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bb[4];
                hopper::ldsm_b_t(bb, Vt, PH, 16 * np, 16 * kk);
                hopper::mma_bf16(acc[2 * np], a, bb[0], bb[1]);
                hopper::mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
            }
        }
    }
    // the heads' state terms: u = x_h dS_h (dB) or dy_h state_in_h (dC),
    // then each row scaled -- by e^{cs_L - cs_s} dt_s or by e^{cs_t} -- and
    // added; dC's u also gives each head's inter-chunk dcs term
    // e^{cs_t} sum_n C[t][n] u[t][n].  The next head's tiles load while
    // this head's are multiplied.
    const int t_lo = j0 + lr_lo, t_hi = j0 + lr_hi;
    for (int h = h0; h < h1; ++h) {
        const int k = (h - h0) & 1;
        const float* csh = p.cs + bhc(p, b, h, c) * p.chunk;
        float w_lo = 0.f, w_hi = 0.f;
        if (is_dc) {
            if (t_lo < rows) w_lo = exp2f(csh[t_lo]);
            if (t_hi < rows) w_hi = exp2f(csh[t_hi]);
        } else {
            const float cs_l = csh[rows - 1];
            if (t_lo < rows)
                w_lo = exp2f(cs_l - csh[t_lo])
                     * p.dt[seq_row(p, b, base + t_lo) * p.H + h];
            if (t_hi < rows)
                w_hi = exp2f(cs_l - csh[t_hi])
                     * p.dt[seq_row(p, b, base + t_hi) * p.H + h];
        }
        __syncthreads();                           // buffer k ^ 1 is free
        if (h + 1 < h1) fetch_head(h + 1, k ^ 1);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();                // head h's tiles
        __syncthreads();
        const bf16* Ut = Ub + k * TL * PP;
        const bf16* Mh = Mb + k * 2 * PM * PH;
        const bf16* Ml = Mh + PM * PH;
        float u[8][4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) u[jj][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < PM / 16; ++kk) {
            uint32_t a[4];
            hopper::ldsm_a(a, Ut, PP, 16 * warp, 16 * kk);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t bh[4], bl[4];
                hopper::ldsm_b_t(bh, Mh, PH, 16 * np, 16 * kk);
                hopper::ldsm_b_t(bl, Ml, PH, 16 * np, 16 * kk);
                hopper::mma_bf16(u[2 * np], a, bh[0], bh[1]);
                hopper::mma_bf16(u[2 * np], a, bl[0], bl[1]);
                hopper::mma_bf16(u[2 * np + 1], a, bh[2], bh[3]);
                hopper::mma_bf16(u[2 * np + 1], a, bl[2], bl[3]);
            }
        }
        if (is_dc) {               // inter_t = e^{cs_t} sum_n C[t][n] u[t][n]
            float i_lo = 0.f, i_hi = 0.f;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const int nc_ = 8 * jj + 2 * (lane & 3);
                i_lo += __bfloat162float(Cj[lr_lo * PH + nc_]) * u[jj][0]
                      + __bfloat162float(Cj[lr_lo * PH + nc_ + 1]) * u[jj][1];
                i_hi += __bfloat162float(Cj[lr_hi * PH + nc_]) * u[jj][2]
                      + __bfloat162float(Cj[lr_hi * PH + nc_ + 1]) * u[jj][3];
            }
#pragma unroll
            for (int m = 1; m <= 2; m <<= 1) {
                i_lo += __shfl_xor_sync(0xffffffffu, i_lo, m);
                i_hi += __shfl_xor_sync(0xffffffffu, i_hi, m);
            }
            if ((lane & 3) == 0) {
                float* dst = terms_of(p, b, h, c, T_INTER + nh);
                if (t_lo < rows) dst[t_lo] = w_lo * i_lo;
                if (t_hi < rows) dst[t_hi] = w_hi * i_hi;
            }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            acc[jj][0] += w_lo * u[jj][0];
            acc[jj][1] += w_lo * u[jj][1];
            acc[jj][2] += w_hi * u[jj][2];
            acc[jj][3] += w_hi * u[jj][3];
        }
    }
    hopper::cp_async_wait<0>();
    bf16* out = is_dc ? p.dC : p.dB;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
        const int n = n0 + 8 * jj + 2 * (lane & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int t = j0 + (half ? lr_hi : lr_lo);
            if (t >= rows) continue;
            bf16* o = out + (seq_row(p, b, base + t) * p.G + g) * p.N;
            if (n < p.N) o[n] = __float2bfloat16(acc[jj][2 * half]);
            if (n + 1 < p.N) o[n + 1] = __float2bfloat16(acc[jj][2 * half + 1]);
        }
    }
}

// Step 3c: one (head, batch) a block, one position a thread.  Per chunk:
// dcs_u = sum over key tiles of Qrow - Qcol + inter - e^{cs_L - cs_u} dt_u
// R_u, plus at the last row e^{cs_L} sum dS * state_in + sum_u e^{cs_L -
// cs_u} dt_u R_u; dda = its reverse cumsum; ddt = the direct term +
// e^{cs_L - cs_u} R_u + A dda; dA = sum dda dt.
__global__ void __launch_bounds__(PASS_NT) bwd_ddt(Params p) {
    __shared__ float red[PASS_NT];
    __shared__ float scan[PASS_NT];
    const int h = blockIdx.x, b = blockIdx.y, u = threadIdx.x;
    const float a = p.A[h];
    float dA_acc = 0.f;
    for (int c = 0; c < p.nc; ++c) {
        const int base = c * p.chunk, rows = chunk_rows(p, c);
        const bool valid = u < rows;
        const float* csh = p.cs + bhc(p, b, h, c) * p.chunk;
        const float cs_l = csh[rows - 1];
        float dtu = 0.f, decay = 0.f, rr = 0.f, dcs = 0.f;
        if (valid) {
            dtu = p.dt[seq_row(p, b, base + u) * p.H + h];
            decay = exp2f(cs_l - csh[u]);
            rr = terms_of(p, b, h, c, T_R)[u];
            for (int kt = 0; kt <= u / TL; ++kt)
                dcs += terms_of(p, b, h, c, T_QROW + kt)[u];
            dcs += terms_of(p, b, h, c, T_INTER)[u]
                 + terms_of(p, b, h, c, T_INTER + 1)[u]
                 - terms_of(p, b, h, c, T_QCOL)[u];
        }
        const float v = decay * dtu * rr;
        dcs -= v;
        float sdst = 0.f;
        for (int k = 0; k < PASS_BLOCKS; ++k)
            sdst += p.sdst[bhc(p, b, h, c) * PASS_BLOCKS + k];
        const float total = exp2f(cs_l) * sdst + block_sum(v, red);
        if (u == rows - 1) dcs += total;
        // dda_u = sum_{u <= w < rows} dcs_w: a suffix scan, in fixed steps
        scan[u] = dcs;
        __syncthreads();
        for (int off = 1; off < PASS_NT; off <<= 1) {
            const float add = u + off < PASS_NT ? scan[u + off] : 0.f;
            __syncthreads();
            scan[u] += add;
            __syncthreads();
        }
        const float dda = scan[u];
        if (valid) {
            p.ddt[seq_row(p, b, base + u) * p.H + h] =
                terms_of(p, b, h, c, T_DDT)[u] + decay * rr + a * dda;
            dA_acc += dda * dtu;
        }
        __syncthreads();                           // scan is free
    }
    const float tot = block_sum(dA_acc, red);
    if (u == 0) p.dA_part[static_cast<long long>(b) * p.H + h] = tot;
}

// The scratch of the bf16 backward, in fp32 elements, and where each part
// starts: cs, the local state cotangents dS, sdst, terms, dscg, and the
// split entry states and exit cotangents (bf16, two a float).
constexpr int WS_PARTS = 7;

inline long long workspace(const Params& p, long long* off) {
    const long long bhn = static_cast<long long>(p.Bb) * p.H * p.nc;
    const long long sizes[WS_PARTS] = {
        bhn * p.chunk, bhn * p.P * p.N, bhn * PASS_BLOCKS,
        bhn * NTERMS * p.chunk,
        static_cast<long long>(p.Bb) * p.nc * p.G * p.runs * MAXT * MAXT
            * TL * TL,
        bhn * HL / 2, bhn * HL / 2};
    long long total = 0;
    for (int i = 0; i < WS_PARTS; ++i) {
        if (off) off[i] = total;
        total += (sizes[i] + 3) / 4 * 4;           // 16-byte aligned parts
    }
    return total;
}

int launch_bf16(Params& p, cudaStream_t stream) {
    cudaError_t err = launch(&chunk_state<false>, dim3(p.nc, p.H, p.Bb),
                             dim3(NT), CS_SMEM, p, stream);
    if (err == cudaSuccess)
        err = launch(&state_pass<false>, dim3(PASS_BLOCKS, p.H, p.Bb),
                     dim3(PASS_NT), 0, p, stream);
    if (err == cudaSuccess)
        err = launch(&bwd_heads, dim3(p.nt, p.nc, p.Bb * p.G * p.runs),
                     dim3(NT), HEADS_SMEM, p, stream);
    if (err == cudaSuccess)
        err = launch(&bwd_group, dim3(4 * p.nt, p.nc, p.Bb * p.G), dim3(NT),
                     GROUP_SMEM, p, stream);
    if (err == cudaSuccess)
        err = launch(&bwd_ddt, dim3(p.H, p.Bb), dim3(PASS_NT), 0, p, stream);
    return static_cast<int>(err);
}

}  // namespace ssd_tc

// Scratch (fp32 elements) the backward needs: the bf16 path's (cs, exit
// cotangents, row terms, summed score cotangents), or the fp32 path's
// per-head dB and dC partials (Bb, S, H, N) each.
extern "C" long long ssd_scan_bwd_workspace(int Bb, int S, int H, int P,
                                            int G, int N, int chunk,
                                            int is_bf16) {
    if (!is_bf16) return 2LL * Bb * S * H * N;
    ssd_tc::Params p = {};
    ssd_tc::set_shape(p, Bb, S, H, P, G, N, chunk);
    return ssd_tc::workspace(p, nullptr);
}

// Writes dx, ddt (Bb, S, H) fp32, dA_part (Bb, H) fp32 and dB, dC
// (Bb, S, G, N), using `workspace` (ssd_scan_bwd_workspace(...) fp32
// elements).  dstate may be null (a zero cotangent of the final state).
// Returns the first CUDA error (0 on success).  The caller has checked what
// ssd_scan_fwd's caller checks, and that dy is contiguous in x's type.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C,
                            const void* states_in, const void* dy,
                            const void* dstate, void* dx, void* ddt,
                            void* dA_part, void* dB, void* dC,
                            void* workspace, int Bb, int S, int H, int P,
                            int G, int N, int chunk, int is_bf16,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* ws = static_cast<float*>(workspace);
    if (is_bf16) {
        ssd_tc::Params p = {};
        ssd_tc::set_shape(p, Bb, S, H, P, G, N, chunk);
        p.x = static_cast<const __nv_bfloat16*>(x);
        p.dt = static_cast<const float*>(dt);
        p.A = static_cast<const float*>(A);
        p.B = static_cast<const __nv_bfloat16*>(B);
        p.C = static_cast<const __nv_bfloat16*>(C);
        p.states = const_cast<float*>(static_cast<const float*>(states_in));
        p.dy = static_cast<const __nv_bfloat16*>(dy);
        p.dstate = static_cast<const float*>(dstate);
        p.dx = static_cast<__nv_bfloat16*>(dx);
        p.ddt = static_cast<float*>(ddt);
        p.dA_part = static_cast<float*>(dA_part);
        p.dB = static_cast<__nv_bfloat16*>(dB);
        p.dC = static_cast<__nv_bfloat16*>(dC);
        long long off[ssd_tc::WS_PARTS];
        ssd_tc::workspace(p, off);
        p.cs = ws + off[0];
        p.dS = ws + off[1];
        p.sdst = ws + off[2];
        p.terms = ws + off[3];
        p.dscg = ws + off[4];
        p.st_hl = reinterpret_cast<__nv_bfloat16*>(ws + off[5]);
        p.ds_hl = reinterpret_cast<__nv_bfloat16*>(ws + off[6]);
        return ssd_tc::launch_bf16(p, st);
    }
    Params p = {};
    p.x = x;
    p.dt = static_cast<const float*>(dt);
    p.A = static_cast<const float*>(A);
    p.B = B;
    p.C = C;
    p.states_in = static_cast<const float*>(states_in);
    p.dy = dy;
    p.dstate = static_cast<const float*>(dstate);
    p.dx = dx;
    p.ddt = static_cast<float*>(ddt);
    p.dA_part = static_cast<float*>(dA_part);
    p.dB_part = ws;
    p.dC_part = ws + static_cast<long long>(Bb) * S * H * N;
    p.S = S;
    p.H = H;
    p.P = P;
    p.G = G;
    p.N = N;
    p.chunk = chunk;
    p.nc = (S + chunk - 1) / chunk;
    return launch_fp32(p, Bb, static_cast<float*>(dB), static_cast<float*>(dC),
                       st);
}
