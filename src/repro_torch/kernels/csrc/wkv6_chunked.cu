// Chunk-parallel RWKV-6 (the flash-linear-attention form), chunks of C = 32
// tokens.  Per chunk, with cum the inclusive and ce the exclusive cumsum
// of log(max(w, 1e-38)) over the chunk:
//
//     o_i = (r_i exp(ce_i)) S                                  inter-chunk
//         + sum_{j<i} (sum_n r_in k_jn exp(ce_in - cum_jn)) v_j   intra-chunk
//         + (sum_n r_in u_n k_in) v_i                          diagonal bonus
//     S   = exp(cum_last) S + sum_j (k_j exp(cum_last - cum_j)) v_j^T
//
// Replaces the TPU kernel `_wkv6_chunked_kernel` / `wkv6_chunked` in
// src/repro/kernels/wkv6_chunked.py.
//
// Bound on the card: bytes, nearly tied with operations.  r, k, v, w are
// read once and o written once ([BH, T, N] f32), the state read and written
// once: 352 MB at T = 512, BH = 512, N = 64 (105 us at 3.35 TB/s), against
// about 6.4 GFLOP of f32 work (95 us at the f32 CUDA-core peak).  Tensor
// cores would lower the operations' bound, which does not bind, and TF32
// keeps about three digits against a 3e-4 check, so the kernel stays exact
// f32 on the CUDA cores.  What limits it in practice is shared memory: a
// 16-byte load takes four passes of a quarter-warp whatever it broadcasts,
// so the products are held to as few loaded values per FMA as the
// registers allow (two blocks of 256 threads a SM, 128 registers each).
//
// Design, one block per (b, h) head:
//   * sub-chunks with factored decays.  The chunk is cut into NB = 4
//     sub-blocks of L = 8 rows; b_I = ce at sub-block I's first row.  Each
//     row is decayed only to its own sub-block's boundaries,
//         rd_i = r_i exp(ce_i - b_I),   kf_j = k_j exp(b_{J+1} - cum_j),
//     and everything else is a per-channel factor between two boundaries:
//     for J < I the off-diagonal block is
//         A_IJ = (rd_I exp(b_I - b_{J+1})) kf_J^T,
//     a plain [L x N] [N x L] product with no exp inside it, and
//     r_i exp(ce_i) = rd_i exp(b_I), k_j exp(cum_last - cum_j) = kf_j
//     exp(cum_last - b_{J+1}).  Only the four diagonal sub-blocks keep the
//     mask-before-exp form, one exp per (i, j, n) with j < i: 4 x 28 x N
//     exps a chunk instead of 32 x 32 x N;
//   * every exp argument is a difference cumx[a] - cumx[b] with a >= b of
//     the exclusive cumsum (cumx[0] = 0, cumx[i + 1] = cum_i), which is
//     non-increasing because log w <= 0; `decay()` clamps the difference
//     at 0, so no rounding in the cumsum can make it positive.  Every
//     factor is therefore <= 1 and none overflows; where one underflows,
//     the true product is smaller still (a decay of 1e-6 underflows to 0
//     instead of overflowing);
//   * the state in registers.  A thread keeps a TN x TM tile of the state
//     (4 channels x 4 value columns at N = 64) for the whole sequence, as
//     `wkv6.cu` keeps its column.  The inter-chunk product (r exp(ce)) S
//     reads r as float4s, 16 FMAs per load, and the NG = N / TN lanes of
//     a column tile reduce-scatter their partial sums by shuffles, G rows
//     at a time, one output a lane; the intra-chunk A v is split over the
//     same lanes by j (A stored transposed, v_j in registers) and rides
//     the same reduction.  The state update is an outer product, 16 FMAs
//     per two float4 loads.  The diagonal bonus (r_i . u k_i) is folded
//     into A's diagonal.  Splitting the value columns over blocks (column
//     m of S and o depends only on v[:, m]) was slower on the card: each
//     block repeats the chunk's exps and A, and shared memory still holds
//     only two blocks a SM, so a block takes all N columns;
//   * the off-diagonal A in 4 x 4 tiles with the channels split over up
//     to four lanes (nine float4 loads per 64 FMAs), the diagonal blocks
//     as units of one row and two columns sharing r_i and ce_i;
//   * loads overlapped with compute.  The next chunk's r, k, w and v are
//     staged into the second buffer by 16-byte `cp.async` while the
//     current chunk computes.  log w is taken by all threads at once:
//     thread (segment, channel) sums the logs of its rows in registers
//     and adds the totals of the earlier segments;
//   * a ragged last chunk is zero-filled by `cp.async` (src-size 0) and its
//     rows past T are identity steps (log w = 0, r = k = v = 0), so any
//     T >= 1 is taken;
//   * log and exp are the accurate `logf` / `expf`, not the intrinsics:
//     near w = 1 the fast `__logf` has an absolute error comparable to
//     log w itself.
// s_out may alias s0 (each thread reads its own tile of its head's state
// before writing it); s0 null means a zero state.  r, k, v, w must be
// 16-byte aligned (the wrapper checks it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;                 // chunk length
constexpr int L = 8;                  // sub-block rows
constexpr int NB = C / L;             // sub-blocks a chunk
constexpr int PAIRS = NB * (NB - 1) / 2;    // off-diagonal (I, J), J < I
constexpr int LDA = C + 4;            // row stride of A^T
// the masked entries j < i of a diagonal sub-block as 16 units (row i,
// columns j and j + 1 where j + 1 < i): row and first column of unit x in
// nibble x
constexpr int DIAG_UNITS = 16;
constexpr unsigned long long DIAG_ROW = 0x7777666555443321ull;
constexpr unsigned long long DIAG_COL = 0x6420420420202000ull;
// per-channel factors (rows of `fac`): the pair factors exp(b_I - b_{J+1})
// (PAIRS rows), exp(cum_last - b_{J+1}) (NB rows), exp(b_I) for I >= 1
// (NB - 1 rows) and exp(cum_last)
constexpr int F_PAIR = 0, F_LAST = PAIRS, F_B = PAIRS + NB;
constexpr int F_DL = F_B + NB - 1, FACS = F_DL + 1;

// the state tile a thread keeps: TN channels x TM value columns
template <int N> constexpr int tn_of() { return N >= 16 ? 4 : 2; }
template <int N> constexpr int tm_of() { return N >= 32 ? 4 : N == 16 ? 2 : 1; }

template <int N>
struct Cfg {
    static constexpr int TN = tn_of<N>(), TM = tm_of<N>();
    static constexpr int NG = N / TN;            // lanes sharing a column tile
    static constexpr int THREADS = NG * (N / TM);
    static constexpr int RS = C * N / THREADS;   // rows a thread's cumsum
    static constexpr int G = NG / TM;            // output rows a group
    static constexpr int JL = C / NG;            // A v terms a lane, a row
    static constexpr int QN = N / 4;             // float4 pieces a row
    static constexpr int QS = QN < 4 ? QN : 4;   // lanes splitting an A tile
    static constexpr int DQ = QN < 8 ? QN : 8;   // lanes splitting a diagonal unit
    static constexpr int LDN = N + 4;
    // shared memory, in floats: two stages of r, k, w, v [C][LDN]; then
    // cumx [C + 1][LDN], kf [C][LDN], A^T [C][LDA] and the per-channel
    // factors [FACS][N]
    static constexpr int STAGE = 4 * C * LDN;
    static constexpr int CUMX = 2 * STAGE;
    static constexpr int KF = CUMX + (C + 1) * LDN;
    static constexpr int AT = KF + C * LDN;
    static constexpr int FAC = AT + C * LDA;
    static constexpr int FLOATS = FAC + FACS * N;
    static_assert(THREADS / N <= FACS, "segment totals fit in fac");
    static_assert(THREADS % 32 == 0 && THREADS % N == 0 && 32 % NG == 0,
                  "whole warps; a column tile's lanes in one warp");
    static_assert(G >= 1 && C % G == 0 && G * TM == NG,
                  "the reduce-scatter leaves one output a lane");
    static_assert(N % 4 == 0, "16-byte rows");
    static_assert((C * QN) % THREADS == 0 && 32 % QN == 0
                  && (NB * DIAG_UNITS * DQ) % THREADS == 0,
                  "a row's float4 pieces on neighbouring lanes");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                    "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// exp of a difference of cumulative log decays that is <= 0 in exact
// arithmetic; the clamp keeps it so under rounding
__device__ __forceinline__ float decay(float x) { return expf(fminf(x, 0.f)); }

__device__ __forceinline__ float4 ld4(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x)
{
    *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b)
{
    return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// x * exp(hi - lo), elementwise
__device__ __forceinline__ float4 decayed(float4 x, float4 hi, float4 lo)
{
    return make_float4(x.x * decay(hi.x - lo.x), x.y * decay(hi.y - lo.y),
                       x.z * decay(hi.z - lo.z), x.w * decay(hi.w - lo.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc)
{
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

// W consecutive floats from shared memory (W = 1, 2 or 4, aligned)
template <int W>
__device__ __forceinline__ void ldw(const float* p, float (&x)[W])
{
    if constexpr (W == 4) {
        const float4 y = ld4(p);
        x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
    } else if constexpr (W == 2) {
        const float2 y = *reinterpret_cast<const float2*>(p);
        x[0] = y.x; x[1] = y.y;
    } else {
        x[0] = *p;
    }
}

// Sum V values over the lanes that differ in the bits below 2 D of q,
// scattered: afterwards lane q holds, in a[0 .. V / (2 D)), the sums of
// the values at indices q' (V / (2 D)) + x, q' = q mod 2 D.  Each step
// sends the half the lane gives up and keeps the other.
template <int V, int D>
__device__ __forceinline__ void reduce_scatter(float (&a)[V], int q)
{
    if constexpr (D >= 1) {
        const bool up = q & D;
#pragma unroll
        for (int x = 0; x < V / 2; ++x) {
            const float send = up ? a[x] : a[x + V / 2];
            const float keep = up ? a[x + V / 2] : a[x];
            a[x] = keep + __shfl_xor_sync(0xffffffffu, send, D);
        }
        reduce_scatter<V / 2, D / 2>(
            reinterpret_cast<float (&)[V / 2]>(a), q);
    }
}

// the sub-blocks (I, J) of off-diagonal pair p = I (I - 1) / 2 + J
__device__ __forceinline__ void pair_of(int p, int& I, int& J)
{
    I = p < 1 ? 1 : p < 3 ? 2 : 3;
    J = p - I * (I - 1) / 2;
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::THREADS, 2) wkv6_chunked_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* o, float* s_out,
    int T)
{
    using K = Cfg<N>;
    constexpr int THREADS = K::THREADS, TN = K::TN, RS = K::RS;
    constexpr int TM = K::TM, NG = K::NG, G = K::G, JL = K::JL;
    constexpr int QN = K::QN, QS = K::QS, DQ = K::DQ, LDN = K::LDN;
    constexpr int TILES = PAIRS * 4;        // 4 x 4 tiles of the A_IJ
    extern __shared__ __align__(16) float sm[];
    float* cumx = sm + K::CUMX;  // row i: ce_i (row 0 = 0); row i + 1: cum_i
    float* kf = sm + K::KF;      // k_j exp(b_{J+1} - cum_j), J = j / L
    float* at = sm + K::AT;      // at[j * LDA + i] = A[i][j]; 0 for j > i
    float* fac = sm + K::FAC;    // [FACS][N] per-channel factors

    const int tid = threadIdx.x;
    const int ng = tid % NG, mg = tid / NG;  // the thread's state tile
    const int n0 = ng * TN, mt = mg * TM;
    const long long head = blockIdx.x;
    const long long base = head * T * N;
    const unsigned full = 0xffffffffu;

    // stage the chunk at t0 into buffer `stage`; rows past T are zeros
    auto load_chunk = [&](int stage, int t0) {
        float* st = sm + stage * K::STAGE;
        const int steps = min(C, T - t0);
        for (int e = tid; e < 4 * C * QN; e += THREADS) {
            const int a = e / (C * QN), i = (e / QN) % C, q = e % QN;
            const float* src = (a == 0 ? r : a == 1 ? k : a == 2 ? w : v)
                               + base + (long long)(t0 + min(i, steps - 1)) * N
                               + 4 * q;
            cp_async16(st + (a * C + i) * LDN + 4 * q, src,
                       i < steps ? 16 : 0);
        }
        cp_async_commit();
    };

    load_chunk(0, 0);
    for (int e = tid; e < C * LDA; e += THREADS)
        at[e] = 0.f;
    for (int e = tid; e < LDN; e += THREADS)
        cumx[e] = 0.f;
    const float* up = u + head * N + 4 * (tid % QN);   // u at 2a's piece
    float s[TN][TM];
#pragma unroll
    for (int a = 0; a < TN; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c)
            s[a][c] = s0 ? s0[head * N * N + (long long)(n0 + a) * N + mt + c]
                         : 0.f;

    const int nchunks = (T + C - 1) / C;
    for (int c = 0; c < nchunks; ++c) {
        const int t0 = c * C, steps = min(C, T - t0);
        float* rs = sm + (c & 1) * K::STAGE;  // r, then r exp(ce)
        float* ks = rs + C * LDN;              // k, then k exp(cum_last - cum)
        float* ws = ks + C * LDN;              // w, then r exp(ce - b_I)
        const float* vs = ws + C * LDN;
        if (c + 1 < nchunks) {
            load_chunk((c + 1) & 1, t0 + C);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // 1. log w and its cumsum over the chunk: thread (segment, n)
        //    sums the logs of RS rows in registers, then adds the totals
        //    of the earlier segments (staged in `fac`, written in 2b);
        //    rows past T are identity steps
        {
            const int n = tid % N, seg = tid / N;
            float x[RS], run = 0.f;
#pragma unroll
            for (int a = 0; a < RS; ++a) {
                const int i = seg * RS + a;
                run += i < steps ? logf(fmaxf(ws[i * LDN + n], 1e-38f)) : 0.f;
                x[a] = run;
            }
            fac[seg * N + n] = run;
            __syncthreads();
            float off = 0.f;
            for (int b = 0; b < seg; ++b)
                off += fac[b * N + n];
#pragma unroll
            for (int a = 0; a < RS; ++a)
                cumx[(seg * RS + a + 1) * LDN + n] = x[a] + off;
        }
        __syncthreads();

        // 2a. each row decayed to its own sub-block's boundaries: rd_i =
        //     r_i exp(ce_i - b_I), written over w (taken in step 1), and
        //     kf_i = k_i exp(b_{I+1} - cum_i); the bonus A[i][i] =
        //     r_i . u k_i, reduced over the QN lanes of row i
        float* rd = ws;
        const float4 u4 = make_float4(up[0], up[1], up[2], up[3]);
#pragma unroll
        for (int e0 = 0; e0 < C * QN; e0 += THREADS) {
            const int e = e0 + tid, i = e / QN, n = 4 * (e % QN);
            const int b = (i / L) * L;
            const float4 x = ld4(rs + i * LDN + n), y = ld4(ks + i * LDN + n);
            const float4 ce = ld4(cumx + i * LDN + n);
            const float4 cum = ld4(cumx + (i + 1) * LDN + n);
            st4(rd + i * LDN + n, decayed(x, ce, ld4(cumx + b * LDN + n)));
            st4(kf + i * LDN + n, decayed(y, ld4(cumx + (b + L) * LDN + n),
                                          cum));
            float bonus = dot4(x, mul4(u4, y), 0.f);
#pragma unroll
            for (int d = QN / 2; d > 0; d >>= 1)
                bonus += __shfl_xor_sync(full, bonus, d);
            if (e % QN == 0)
                at[i * LDA + i] = bonus;
        }
        // 2b. the per-channel factors between sub-block boundaries
        for (int e = tid; e < FACS * N; e += THREADS) {
            const int f = e / N, n = e % N;
            float hi, lo;
            if (f < F_LAST) {                  // exp(b_I - b_{J+1})
                int I, J;
                pair_of(f, I, J);
                hi = cumx[I * L * LDN + n];
                lo = cumx[(J + 1) * L * LDN + n];
            } else if (f < F_B) {              // exp(cum_last - b_{J+1})
                hi = cumx[C * LDN + n];
                lo = cumx[(f - F_LAST + 1) * L * LDN + n];
            } else {                           // exp(b_I), exp(cum_last)
                hi = cumx[(f - F_B + 1) * L * LDN + n];
                lo = 0.f;
            }
            fac[e] = decay(hi - lo);
        }
        // 2c. the diagonal sub-blocks, mask before exp: A[i][j], j < i in
        //    one sub-block, as 16 units a sub-block of one row i and one or
        //    two columns j (r_i and ce_i read once for both); the DQ lanes
        //    of a unit split the channels, a quarter-warp reading 128
        //    contiguous bytes of one row
#pragma unroll
        for (int e0 = 0; e0 < NB * DIAG_UNITS * DQ; e0 += THREADS) {
            const int unit = (e0 + tid) / DQ, part = tid % DQ;
            const int x = unit % DIAG_UNITS, blk = unit / DIAG_UNITS;
            const int i = blk * L + (int)((DIAG_ROW >> (4 * x)) & 15);
            const int j = blk * L + (int)((DIAG_COL >> (4 * x)) & 15);
            const bool two = j + 1 < i;
            float a0 = 0.f, a1 = 0.f;
#pragma unroll
            for (int y = 0; y < QN / DQ; ++y) {
                const int n = 4 * (y * DQ + part);
                const float4 ri = ld4(rs + i * LDN + n);
                const float4 ci = ld4(cumx + i * LDN + n);
                const float4 k0 = ld4(ks + j * LDN + n);
                const float4 c0 = ld4(cumx + (j + 1) * LDN + n);
                a0 = fmaf(ri.x * k0.x, decay(ci.x - c0.x), a0);
                a0 = fmaf(ri.y * k0.y, decay(ci.y - c0.y), a0);
                a0 = fmaf(ri.z * k0.z, decay(ci.z - c0.z), a0);
                a0 = fmaf(ri.w * k0.w, decay(ci.w - c0.w), a0);
                if (two) {
                    const float4 k1 = ld4(ks + (j + 1) * LDN + n);
                    const float4 c1 = ld4(cumx + (j + 2) * LDN + n);
                    a1 = fmaf(ri.x * k1.x, decay(ci.x - c1.x), a1);
                    a1 = fmaf(ri.y * k1.y, decay(ci.y - c1.y), a1);
                    a1 = fmaf(ri.z * k1.z, decay(ci.z - c1.z), a1);
                    a1 = fmaf(ri.w * k1.w, decay(ci.w - c1.w), a1);
                }
            }
#pragma unroll
            for (int d = 1; d < DQ; d <<= 1) {
                a0 += __shfl_xor_sync(full, a0, d);
                a1 += __shfl_xor_sync(full, a1, d);
            }
            if (part == 0) {
                at[j * LDA + i] = a0;
                if (two)
                    at[(j + 1) * LDA + i] = a1;
            }
        }
        __syncthreads();

        // 3a. the off-diagonal blocks A_IJ = (rd_I exp(b_I - b_{J+1}))
        //     kf_J^T in 4 x 4 tiles, the channels split over QS lanes
        //     (float4 pieces interleaved), reduce-scattered over them
#pragma unroll
        for (int e0 = 0; e0 < TILES * QS; e0 += THREADS) {
            const int e = e0 + tid, tile = e / QS, q = e % QS;
            const bool on = tile < TILES;
            const int p = on ? tile / 4 : 0;
            int I, J;
            pair_of(p, I, J);
            const int i0 = I * L + 4 * ((tile / 2) % 2);
            const int j0 = J * L + 4 * (tile % 2);
            float acc[16];
#pragma unroll
            for (int x = 0; x < 16; ++x)
                acc[x] = 0.f;
            if (on) {
#pragma unroll
                for (int y = 0; y < QN / QS; ++y) {
                    const int n = 4 * (y * QS + q);
                    const float4 f = ld4(fac + (F_PAIR + p) * N + n);
                    float4 xr[4], yk[4];
#pragma unroll
                    for (int a = 0; a < 4; ++a) {
                        xr[a] = mul4(ld4(rd + (i0 + a) * LDN + n), f);
                        yk[a] = ld4(kf + (j0 + a) * LDN + n);
                    }
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int b = 0; b < 4; ++b)
                            acc[a * 4 + b] = dot4(xr[a], yk[b], acc[a * 4 + b]);
                }
            }
            reduce_scatter<16, QS / 2>(acc, q);
            if (on) {
#pragma unroll
                for (int x = 0; x < 16 / QS; ++x) {
                    const int idx = q * (16 / QS) + x;
                    at[(j0 + idx % 4) * LDA + i0 + idx / 4] = acc[x];
                }
            }
        }
        // 3b. r exp(ce) = rd exp(b_I) over r, and k exp(cum_last - cum) =
        //     kf exp(cum_last - b_{J+1}) over k (2a and 2c have read r and k)
#pragma unroll
        for (int e0 = 0; e0 < 2 * C * QN; e0 += THREADS) {
            const int e = e0 + tid, kk = e >= C * QN;
            const int i = (e / QN) % C, n = 4 * (e % QN);
            if (kk) {
                st4(ks + i * LDN + n, mul4(ld4(kf + i * LDN + n),
                    ld4(fac + (F_LAST + i / L) * N + n)));
            } else if (i >= L) {
                st4(rs + i * LDN + n, mul4(ld4(rd + i * LDN + n),
                    ld4(fac + (F_B + i / L - 1) * N + n)));
            } else {
                st4(rs + i * LDN + n, ld4(rd + i * LDN + n));
            }
        }
        __syncthreads();

        // 4. o = (r exp(ce)) S + A v, G rows at a time: each lane's
        //    partial over its TN channels (inter-chunk) and over JL of
        //    the j (intra-chunk), reduce-scattered over the NG lanes of
        //    the column tile, one output a lane
        float vr[JL][TM];                      // v_j, j = jj NG + ng
#pragma unroll
        for (int jj = 0; jj < JL; ++jj)
            ldw<TM>(vs + (jj * NG + ng) * LDN + mt, vr[jj]);
#pragma unroll 2
        for (int g0 = 0; g0 < C; g0 += G) {
            float acc[G * TM];
#pragma unroll
            for (int g = 0; g < G; ++g) {
                float x[TN];
                ldw<TN>(rs + (g0 + g) * LDN + n0, x);
#pragma unroll
                for (int cc = 0; cc < TM; ++cc) {
                    float a = 0.f;
#pragma unroll
                    for (int b = 0; b < TN; ++b)
                        a = fmaf(x[b], s[b][cc], a);
                    acc[g * TM + cc] = a;
                }
            }
#pragma unroll
            for (int jj = 0; jj < JL; ++jj) {
                if (jj * NG > g0 + G - 1)      // A[i][j] = 0 for j > i
                    break;
                float y[G];
                ldw<G>(at + (jj * NG + ng) * LDA + g0, y);
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int cc = 0; cc < TM; ++cc)
                        acc[g * TM + cc] = fmaf(y[g], vr[jj][cc],
                                                acc[g * TM + cc]);
            }
            reduce_scatter<G * TM, NG / 2>(acc, ng);
            const int row = g0 + ng / TM;
            if (row < steps)
                o[base + (long long)(t0 + row) * N + mt + ng % TM] = acc[0];
        }

        // 5. S = exp(cum_last) S + sum_j (k_j exp(cum_last - cum_j)) v_j^T
        {
            float dl[TN];
            ldw<TN>(fac + F_DL * N + n0, dl);
#pragma unroll
            for (int a = 0; a < TN; ++a)
#pragma unroll
                for (int cc = 0; cc < TM; ++cc)
                    s[a][cc] *= dl[a];
        }
#pragma unroll 4
        for (int j = 0; j < C; ++j) {
            float x[TN], y[TM];
            ldw<TN>(ks + j * LDN + n0, x);
            ldw<TM>(vs + j * LDN + mt, y);
#pragma unroll
            for (int a = 0; a < TN; ++a)
#pragma unroll
                for (int cc = 0; cc < TM; ++cc)
                    s[a][cc] = fmaf(x[a], y[cc], s[a][cc]);
        }
        __syncthreads();       // the stage is refilled by the next chunk
    }
#pragma unroll
    for (int a = 0; a < TN; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c)
            s_out[head * N * N + (long long)(n0 + a) * N + mt + c] = s[a][c];
}

template <int N>
int launch(int BH, int T, const float* r, const float* k, const float* v,
           const float* w, const float* u, const float* s0, float* o,
           float* s_out, cudaStream_t st)
{
    const size_t smem = sizeof(float) * Cfg<N>::FLOATS;
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_chunked_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess)
        return (int)err;
    wkv6_chunked_kernel<N><<<BH, Cfg<N>::THREADS, smem, st>>>(
        r, k, v, w, u, s0, o, s_out, T);
    return (int)cudaGetLastError();
}

template <int N>
int config(int* out)
{
    const size_t smem = sizeof(float) * Cfg<N>::FLOATS;
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_chunked_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess)
        return (int)err;
    out[0] = Cfg<N>::THREADS;
    out[1] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], wkv6_chunked_kernel<N>, Cfg<N>::THREADS, smem);
}

bool misaligned(const void* p)
{
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// r, k, v, w, o: [BH, T, N] f32 contiguous, r/k/v/w 16-byte aligned; u:
// [BH, N]; s0 (nullable) and s_out: [BH, N, N] f32 contiguous, may alias.
// N in {8, 16, 32, 64}.
extern "C" int wkv6_chunked_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* o, void* s_out, int BH, int T,
    int N, void* stream)
{
    if (misaligned(r) || misaligned(k) || misaligned(v) || misaligned(w))
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS BH, T, static_cast<const float*>(r), \
    static_cast<const float*>(k), static_cast<const float*>(v), \
    static_cast<const float*>(w), static_cast<const float*>(u), \
    static_cast<const float*>(s0), static_cast<float*>(o), \
    static_cast<float*>(s_out), st
    switch (N) {
        case 8: return launch<8>(ARGS);
        case 16: return launch<16>(ARGS);
        case 32: return launch<32>(ARGS);
        case 64: return launch<64>(ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef ARGS
}

// The launch shape at head size N: out[0..2] = threads a block, dynamic
// shared memory in bytes, and blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int wkv6_chunked_config(int N, int* out)
{
    switch (N) {
        case 8: return config<8>(out);
        case 16: return config<16>(out);
        case 32: return config<32>(out);
        case 64: return config<64>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}
