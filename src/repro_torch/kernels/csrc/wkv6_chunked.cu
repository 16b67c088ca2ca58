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
// about 7 GFLOP of f32 work (about 104 us at the f32 CUDA-core peak).
//
// Design (SIMT f32; tensor cores are later work):
//   * one block per (b, h) head loops over the chunks; the [N, N] f32 state
//     stays in shared memory for the whole sequence (the TPU kernel's VMEM
//     scratch), and so do the chunk's r, k, v, the cumsums and the [C, C]
//     attention matrix: device memory sees only the r/k/v/w/o streams and
//     the state once;
//   * the decay mask is applied before the exp: only j < i is computed,
//     so every exponent is <= 0 and a decay of 1e-6 underflows to zero
//     instead of overflowing;
//   * the diagonal bonus is folded into att[i][i], so one pass att @ v
//     gives the intra-chunk and the bonus terms;
//   * a ragged last chunk is padded in shared memory with identity steps
//     (w = 1, r = k = v = 0), so any T >= 1 is taken;
//   * r and k are rescaled in place once att is built (r_i exp(ce_i), and
//     k_j exp(cum_last - cum_j)), so the inter-chunk product and the state
//     update are plain dot products over shared memory;
//   * the [C][N] tiles have a row stride of N + 1 words, so the 32 lanes
//     of a warp that read 32 rows j of one channel n hit 32 banks;
//   * log and exp are the accurate `logf` / `expf`, not the intrinsics:
//     near w = 1 the fast `__logf` has an absolute error comparable to
//     log w itself.
// s_out may alias s0 (each block reads its head's state before writing it);
// s0 null means a zero state.

#include <cuda_runtime.h>

namespace {

constexpr int C = 32;          // chunk length
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) wkv6_chunked_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* o, float* s_out,
    int T, int N)
{
    extern __shared__ float sm[];
    const int LD = N + 1;             // row stride of the [C][N] tiles
    float* S = sm;                    // [N][N]
    float* rs = S + N * N;            // [C][LD]  r, then r * exp(ce)
    float* ks = rs + C * LD;          // [C][LD]  k, then k * exp(last - cum)
    float* vs = ks + C * LD;          // [C][LD]
    float* cum = vs + C * LD;         // [C][LD]  inclusive cumsum of log w
    float* ce = cum + C * LD;         // [C][LD]  w, then exclusive cumsum
    float* att = ce + C * LD;         // [C][C]
    float* us = att + C * C;          // [N]
    const int tid = threadIdx.x;
    const long long head = blockIdx.x;
    const long long base = head * T * N;
    for (int e = tid; e < N * N; e += THREADS)
        S[e] = s0 ? s0[head * N * N + e] : 0.f;
    for (int e = tid; e < N; e += THREADS)
        us[e] = u[head * N + e];
    for (int t0 = 0; t0 < T; t0 += C) {
        const int steps = min(C, T - t0);
        // 1. the chunk; rows past T are identity steps
        for (int e = tid; e < C * N; e += THREADS) {
            const int i = e / N, x = i * LD + e % N;
            const bool real = i < steps;
            const long long g = base + (long long)t0 * N + e;
            rs[x] = real ? r[g] : 0.f;
            ks[x] = real ? k[g] : 0.f;
            vs[x] = real ? v[g] : 0.f;
            ce[x] = real ? w[g] : 1.f;
        }
        __syncthreads();
        // 2. cumsums of log w, one thread per channel n
        for (int n = tid; n < N; n += THREADS) {
            float run = 0.f;
            for (int i = 0; i < C; ++i) {
                const float lw = logf(fmaxf(ce[i * LD + n], 1e-38f));
                ce[i * LD + n] = run;
                run += lw;
                cum[i * LD + n] = run;
            }
        }
        __syncthreads();
        // 3. att[i][j], j < i: decayed r_i . k_j; att[i][i]: the u bonus
        for (int e = tid; e < C * C; e += THREADS) {
            const int i = e / C, j = e % C;
            float a = 0.f;
            if (j < i) {
                for (int n = 0; n < N; ++n)
                    a += rs[i * LD + n] * ks[j * LD + n]
                         * expf(ce[i * LD + n] - cum[j * LD + n]);
            } else if (j == i) {
                for (int n = 0; n < N; ++n)
                    a += rs[i * LD + n] * us[n] * ks[i * LD + n];
            }
            att[e] = a;
        }
        __syncthreads();
        // 4. rescale r and k in place for the inter-chunk and state terms
        for (int e = tid; e < C * N; e += THREADS) {
            const int n = e % N, x = (e / N) * LD + n;
            rs[x] *= expf(ce[x]);
            ks[x] *= expf(cum[(C - 1) * LD + n] - cum[x]);
        }
        __syncthreads();
        // 5. o_i = (r_i exp(ce_i)) S + sum_{j<=i} att[i][j] v_j
        for (int e = tid; e < steps * N; e += THREADS) {
            const int i = e / N, m = e % N;
            float a = 0.f;
            for (int n = 0; n < N; ++n)
                a += rs[i * LD + n] * S[n * N + m];
            for (int j = 0; j <= i; ++j)
                a += att[i * C + j] * vs[j * LD + m];
            o[base + (long long)t0 * N + e] = a;
        }
        __syncthreads();
        // 6. S = exp(cum_last) S + sum_j k'_j v_j^T
        for (int e = tid; e < N * N; e += THREADS) {
            const int n = e / N, m = e % N;
            float a = expf(cum[(C - 1) * LD + n]) * S[e];
            for (int j = 0; j < C; ++j)
                a += ks[j * LD + n] * vs[j * LD + m];
            S[e] = a;
        }
        __syncthreads();
    }
    for (int e = tid; e < N * N; e += THREADS)
        s_out[head * N * N + e] = S[e];
}

}  // namespace

// r, k, v, w, o: [BH, T, N] f32 contiguous; u: [BH, N]; s0 (nullable) and
// s_out: [BH, N, N] f32 contiguous, may alias.  1 <= N <= 64.
extern "C" int wkv6_chunked_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* o, void* s_out, int BH, int T,
    int N, void* stream)
{
    if (N < 1 || N > 64)
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(float) * ((size_t)N * N + 5 * C * (N + 1) + C * C + N);
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess)
        return (int)err;
    wkv6_chunked_kernel<<<BH, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(o), static_cast<float*>(s_out), T, N);
    return (int)cudaGetLastError();
}
