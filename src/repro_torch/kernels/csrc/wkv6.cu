// RWKV-6 time-mix recurrence, one step at a time.  Per head of size N, with
// receptance r_t, key k_t, value v_t, decay w_t (all [N]) and bonus u [N]:
//
//     o_t = r_t^T (diag(u) k_t v_t^T + S)
//     S   = diag(w_t) S + k_t v_t^T
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` in src/repro/kernels/wkv6.py.
//
// Bound on the card: bytes.  The work is r, k, v, w read once and o written
// once ([BH, T, N] f32 each), the state read and written once, and about
// 5 N^2 operations a step and head: at T = 512, BH = 512, N = 64 that is
// 352 MB (105 us at 3.35 TB/s) against 5.4 GFLOP (80 us at the f32 peak).
// In practice the loop is bound by latency: every step depends on the last.
//
// Design:
//   * one block per (b, h) head, one thread per value column j; thread j
//     keeps the column S[:, j] in registers for the whole sequence, so the
//     state never goes back to device memory between steps (the TPU kernel's
//     VMEM scratch), and o_j = sum_i r_i (u_i k_i v_j + S_ij) is reduced
//     inside the thread: no cross-thread reduction;
//   * the loop over T runs inside the block; it replaces the TPU's
//     sequential grid axis over time blocks.  Any T >= 1 is taken, so the
//     TPU wrapper's padding with identity steps is not needed;
//   * r, k, w, v of TS steps are staged in shared memory at once (each a
//     coalesced [TS, N] tile), so the latency of a device-memory load is
//     paid once per TS steps and not once per step;
//   * the state is read before it is written by the same thread, so
//     `s_out` may alias `s0` (the caller's state slice, updated in place).
//     `s0` null means a zero state.

#include <cuda_runtime.h>

namespace {

constexpr int TS = 32;   // time steps staged in shared memory at once

template <int N>
__global__ void __launch_bounds__(N) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* o, float* s_out,
    int T)
{
    __shared__ float rs[TS][N], ks[TS][N], ws[TS][N], vs[TS][N];
    __shared__ float us[N];
    const int j = threadIdx.x;
    const long long head = blockIdx.x;
    const long long base = head * T * N;
    us[j] = u[head * N + j];
    float s[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
        s[i] = s0 ? s0[head * N * N + (long long)i * N + j] : 0.f;
    for (int t0 = 0; t0 < T; t0 += TS) {
        const int steps = min(TS, T - t0);
        __syncthreads();                 // the last tile is no longer read
        for (int e = j; e < steps * N; e += N) {
            const long long g = base + (long long)t0 * N + e;
            rs[e / N][e % N] = r[g];
            ks[e / N][e % N] = k[g];
            ws[e / N][e % N] = w[g];
            vs[e / N][e % N] = v[g];
        }
        __syncthreads();
        for (int t = 0; t < steps; ++t) {
            const float vj = vs[t][j];
            float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
            for (int i = 0; i < N; i += 2) {
                const float kv0 = ks[t][i] * vj, kv1 = ks[t][i + 1] * vj;
                acc0 += rs[t][i] * (us[i] * kv0 + s[i]);
                acc1 += rs[t][i + 1] * (us[i + 1] * kv1 + s[i + 1]);
                s[i] = ws[t][i] * s[i] + kv0;
                s[i + 1] = ws[t][i + 1] * s[i + 1] + kv1;
            }
            o[base + (long long)(t0 + t) * N + j] = acc0 + acc1;
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
        s_out[head * N * N + (long long)i * N + j] = s[i];
}

template <int N>
void launch(int BH, int T, const float* r, const float* k, const float* v,
            const float* w, const float* u, const float* s0, float* o,
            float* s_out, cudaStream_t st)
{
    wkv6_kernel<N><<<BH, N, 0, st>>>(r, k, v, w, u, s0, o, s_out, T);
}

}  // namespace

// r, k, v, w, o: [BH, T, N] f32 contiguous; u: [BH, N]; s0 (nullable) and
// s_out: [BH, N, N] f32 contiguous, may alias.  N in {8, 16, 32, 64}.
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* o, void* s_out, int BH, int T,
    int N, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS BH, T, static_cast<const float*>(r), \
    static_cast<const float*>(k), static_cast<const float*>(v), \
    static_cast<const float*>(w), static_cast<const float*>(u), \
    static_cast<const float*>(s0), static_cast<float*>(o), \
    static_cast<float*>(s_out), st
    switch (N) {
        case 8: launch<8>(ARGS); break;
        case 16: launch<16>(ARGS); break;
        case 32: launch<32>(ARGS); break;
        case 64: launch<64>(ARGS); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef ARGS
    return (int)cudaGetLastError();
}
