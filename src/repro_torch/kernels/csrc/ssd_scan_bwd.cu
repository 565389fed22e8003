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
// Design.  One block owns one (batch, head) and runs its chunks in reverse,
// dS in shared memory.  Within a chunk the key tiles (64 rows) are the
// outer loop: each keeps its dx and dB rows in registers over the query
// tiles at or above it, and the query tiles' dC rows are summed in an fp32
// buffer that only this block touches.  dB and dC sum over the H/G heads of
// a group and dA over the batch, which cross blocks; so the block writes
// per-head fp32 partials -- dB and dC (Bb, S, H, N), dA (Bb, H) -- and a
// second kernel (ssd_reduce_heads) sums dB and dC over each group's heads
// in a fixed order; the wrapper sums dA over the batch.  Nothing is atomic,
// so the result does not depend on scheduling.  Row and column sums of the
// (t, s) tiles go through shared memory in a fixed order too.
//
// What bounds it on the H100: at the training shape (B 4, S 1024, 144
// heads in 3 groups, P 64, N 128, bf16) it reads x, dt, B, C, dy and the
// entry states and writes dx, ddt, dB, dC: 319 MB, 0.095 ms at 3.35 TB/s.
// The products it needs are about 59 GFLOP (0.06 ms on the bf16 tensor
// cores): the scores again and dB, dC over the causal pairs once per
// group, dM and dx over the pairs per head, and four (l, P, N) products
// per head (chip_smoke.py's _ssd_ops).  So bytes bound it.  Like the
// forward it runs on fp32 FMAs from shared-memory tiles, one 256-thread
// block per SM (175 KB), and recomputes C . B^T per head; the same
// redesign applies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

__device__ __forceinline__ long long row(const Params& p, int b, int pos) {
    return static_cast<long long>(b) * p.S + pos;
}

// rows [r0, r0 + TL) of B or C (group g) into a transposed [n][r] tile.
template <typename T>
__device__ void load_bc_t(float* dst, const T* src, const Params& p, int b,
                          int g, int base, int r0, int rows) {
    for (int i = threadIdx.x; i < TL * NM; i += NT) {
        const int r = i / NM, n = i % NM;
        float v = 0.f;
        if (r0 + r < rows && n < p.N)
            v = load_f(src + (row(p, b, base + r0 + r) * p.G + g) * p.N + n);
        dst[n * PITCH + r] = v;
    }
}

// rows [r0, r0 + TL) of x or dy (head h) into a [r][p] tile of pitch `pitch`.
template <typename T>
__device__ void load_rows(float* dst, int pitch, const T* src, const Params& p,
                          int b, int h, int base, int r0, int rows) {
    for (int i = threadIdx.x; i < TL * PM; i += NT) {
        const int r = i / PM, c = i % PM;
        float v = 0.f;
        if (r0 + r < rows && c < p.P)
            v = load_f(src + (row(p, b, base + r0 + r) * p.H + h) * p.P + c);
        dst[r * pitch + c] = v;
    }
}

template <typename T>
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
    const T* x = static_cast<const T*>(p.x);
    const T* Bm = static_cast<const T*>(p.B);
    const T* Cm = static_cast<const T*>(p.C);
    const T* dy = static_cast<const T*>(p.dy);
    T* dx = static_cast<T*>(p.dx);
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
                T* dxr = dx + (row(p, b, base + s) * p.H + h) * p.P;
                float* dbr = p.dB_part + (row(p, b, base + s) * p.H + h) * p.N;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (tx + 16 * j < p.P) store_f(dxr + tx + 16 * j, dxa[i][j]);
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
template <typename T>
__global__ void __launch_bounds__(NT) ssd_reduce_heads(
        const float* dB_part, const float* dC_part, T* dB, T* dC,
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
    store_f(dB + i, sb);
    store_f(dC + i, sc);
}

template <typename T>
int launch(Params p, int Bb, void* dB, void* dC, cudaStream_t stream) {
    constexpr int smem_bytes = SMEM_FLOATS * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        &ssd_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchKernel(&ssd_bwd<T>, dim3(p.H, Bb), dim3(NT), args,
                           smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    long long total = static_cast<long long>(Bb) * p.S * p.G * p.N;
    T* dBt = static_cast<T*>(dB);
    T* dCt = static_cast<T*>(dC);
    int H = p.H, G = p.G, N = p.N;
    void* rargs[] = {&p.dB_part, &p.dC_part, &dBt, &dCt, &total, &H, &G, &N};
    err = cudaLaunchKernel(&ssd_reduce_heads<T>,
                           dim3(static_cast<unsigned>((total + NT - 1) / NT)),
                           dim3(NT), rargs, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Writes dx, ddt (Bb, S, H) fp32, dA_part (Bb, H) fp32 and dB, dC
// (Bb, S, G, N) through the fp32 per-head partials dB_part, dC_part
// (Bb, S, H, N), which the caller allocates.  dstate may be null (a zero
// cotangent of the final state).  Returns the first CUDA error (0 on
// success).  The caller has checked what ssd_scan_fwd's caller checks, and
// that dy is contiguous in x's type.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C,
                            const void* states_in, const void* dy,
                            const void* dstate, void* dx, void* ddt,
                            void* dA_part, void* dB_part, void* dC_part,
                            void* dB, void* dC, int Bb, int S, int H, int P,
                            int G, int N, int chunk, int is_bf16,
                            void* stream) {
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
    p.dB_part = static_cast<float*>(dB_part);
    p.dC_part = static_cast<float*>(dC_part);
    p.S = S;
    p.H = H;
    p.P = P;
    p.G = G;
    p.N = N;
    p.chunk = chunk;
    p.nc = (S + chunk - 1) / chunk;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch<__nv_bfloat16>(p, Bb, dB, dC, st)
                   : launch<float>(p, Bb, dB, dC, st);
}
