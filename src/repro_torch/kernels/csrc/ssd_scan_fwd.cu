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
// Design.  The TPU grid is (B, H, nc) with the chunk axis sequential and the
// state in VMEM.  Blocks on Hopper run in no order, so here one block owns
// one (batch, head) and walks its chunks itself, the (P, N) fp32 state in
// registers (4 x 8 per thread, 64 x 128 = 32 KB over 256 threads) and a copy
// in shared memory for the inter-chunk term.  A 256-position chunk does not
// fit whole (its x, B, C and the (L, L) score tile would need ~450 KB of
// fp32), so it is cut into 64-row tiles: for each query tile the inter term
// C . state, then for each key tile at or below it the weighted scores
// (C . B^T) * decay * dt (a 64 x 64 tile) and their product with x; then the
// state update over the key tiles.  cs is a sequential fp32 cumsum per chunk
// (one thread, 256 adds; nothing against the ~10^7 FMAs of a chunk), and
// every decay is the exponent of a clamped difference, never a product
// e^{cs_t} e^{-cs_s}: cs falls to about -1200 within a chunk at mamba2's
// initialisation and e^{-cs_s} would overflow.  Positions past S are zero
// (x, B, C, dt = 0), which leaves the state unchanged, as the reference's
// zero padding does.  P <= 64, N <= 128 and chunk <= 256 at run time; tiles
// are zero-padded to 64 and 128.
//
// What bounds it on the H100: at the training shape (B 4, S 1024, 144 heads
// = 3 clients x 48, P 64, N 128, G 3, chunk 256, bf16) it moves about 250 MB
// (x, y and the fp32 entry states dominate: 0.076 ms at 3.35 TB/s) for
// about 29 GFLOP of products (0.03 ms on the bf16 tensor cores; C . B^T
// counted once per group, as chip_smoke.py's _ssd_ops does), so bytes
// bound it.  This first version reaches for neither: all products are fp32
// FMAs from shared-memory tiles (4 x 4 or 4 x 8 micro-tiles per thread), one
// code path exact for fp32 and bf16, with one 256-thread block per SM (135
// KB of shared memory).  With G = 1 every head of a group reads the same B
// and C, and each block recomputes C . B^T for its own head: a redesign
// starts there (share the score tile across the heads of a group, then
// mma/wgmma for the three products).  A B = 1 admission prefill of K = 2
// clients is only 96 blocks for 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// rows [r0, r0 + TL) of the chunk starting at sequence position `base`
// (rows at or past `rows` are zero), group g of B or C, into a transposed
// [n][r] tile.
template <typename T>
__device__ void load_bc_t(float* dst, const T* src, const Params& p, int b,
                          int g, int base, int r0, int rows) {
    for (int i = threadIdx.x; i < TL * NM; i += NT) {
        const int r = i / NM, n = i % NM;
        float v = 0.f;
        if (r0 + r < rows && n < p.N)
            v = load_f(src + ((static_cast<long long>(b) * p.S + base + r0 + r)
                              * p.G + g) * p.N + n);
        dst[n * PITCH + r] = v;
    }
}

// rows [r0, r0 + TL) of x for head h into Xs[r][p], each row scaled by
// scale[r0 + r] when `scale` is given.
template <typename T>
__device__ void load_x(float* dst, const T* src, const Params& p, int b,
                       int h, int base, int r0, int rows,
                       const float* scale) {
    for (int i = threadIdx.x; i < TL * PM; i += NT) {
        const int r = i / PM, c = i % PM;
        float v = 0.f;
        if (r0 + r < rows && c < p.P) {
            v = load_f(src + ((static_cast<long long>(b) * p.S + base + r0 + r)
                              * p.H + h) * p.P + c);
            if (scale) v *= scale[r0 + r];
        }
        dst[r * PM + c] = v;
    }
}

template <typename T>
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
    const T* x = static_cast<const T*>(p.x);
    const T* Bm = static_cast<const T*>(p.B);
    const T* Cm = static_cast<const T*>(p.C);
    T* y = static_cast<T*>(p.y);

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
                T* yrow = y + ((static_cast<long long>(b) * p.S + base + t) * p.H
                               + h) * p.P;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int pp = tx + 16 * j;
                    if (pp < p.P) store_f(yrow + pp, acc[i][j]);
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

template <typename T>
int launch(Params p, int Bb, cudaStream_t stream) {
    constexpr int smem_bytes = SMEM_FLOATS * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        &ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&p};
    err = cudaLaunchKernel(&ssd_fwd<T>, dim3(p.H, Bb), dim3(NT), args,
                           smem_bytes, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Writes y, final_state and states_in; returns the first CUDA error (0 on
// success).  The caller has checked shapes (P <= 64, N <= 128, chunk <= 256,
// H % G == 0), dtypes (x, B, C of one type; dt, A fp32), devices and that
// every tensor is contiguous.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y,
                            void* final_state, void* states_in, int Bb, int S,
                            int H, int P, int G, int N, int chunk,
                            int is_bf16, void* stream) {
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch<__nv_bfloat16>(p, Bb, st) : launch<float>(p, Bb, st);
}
