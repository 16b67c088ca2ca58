// RWKV-6 time-mix recurrence, one step at a time.  Per head of size N, with
// receptance r_t, key k_t, value v_t, decay w_t (all [N]) and bonus u [N]:
//
//     o_t = r_t^T (diag(u) k_t v_t^T + S)
//     S   = diag(w_t) S + k_t v_t^T
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6` in src/repro/kernels/wkv6.py.
//
// Bound on the card: bytes, with the f32 pipe close behind.  r, k, v, w are
// read once and o written once ([BH, T, N] f32 each), the state read and
// written once: at T = 512, BH = 512, N = 64 that is 352 MB (105 us at
// 3.35 TB/s).  The step loop costs three f32 instructions per state entry
// and step (k_i v_j, the output's FMA, the state's FMA): 3.2e9 lane
// instructions, 96 us at 128 lanes a clock on 132 SMs at 1.98 GHz.  At T =
// 1 (decode) the 16.8 MB of state in and out is all.
//
// What binds in practice is instruction issue.  By the source's count a
// warp issues about 260 instructions a step at N = 64: 192 are the state
// entries' f32 operations, the rest the bonus, the loads, the reduction
// over channels and the store.  With two warps a scheduler they issue at
// about 0.7 a clock (the shuffles' latency, bank conflicts of the
// three-operand FMAs): some 720 cycles a step for the four heads of a SM.  Tiles with more threads a head (4 x 4, 4 x 8,
// 8 x 4) give more warps but more loads and reductions per state entry, and
// were slower on the card, as were a reduction through shared memory and
// two steps fused into one update (fewer FMAs, more bank conflicts).
//
// Design, one block per (b, h) head:
//   * a thread keeps a TN x TM = 8 x 8 tile of the state in registers for
//     the whole sequence: channels n0 .. n0 + 8, value columns m0 .. m0 + 8;
//     at N = 64 that is 64 threads a head, ~200 registers, four blocks a
//     SM, so the 512 heads of the serve path run in one wave on 132 SMs
//     (N = 8, 16, 32 take 1, 4, 16 threads).  Per step a thread loads its 8
//     channels of r, k, w and its 8 columns of v from shared memory, eight
//     16-byte loads for 216 f32 instructions;
//   * S_ij evolves by itself: the state never crosses threads, and step
//     t + 1's update does not wait for step t's output.  Only o_j is a sum
//     over channels: the NG = N / TN lanes of a column tile sit in one warp
//     and reduce-scatter their TM partial sums by shuffles, one output a
//     lane (no shared memory, no barrier a step), a warp storing 128
//     contiguous bytes of o;
//   * the bonus is folded into the partial sums: o_j = v_j sum_i r_i u_i k_i
//     + sum_i r_i S_ij, so each lane adds p v_j, p its channels' part of
//     r . (u k), and the sum over channels takes both terms at once;
//   * the next TS steps of r, k, w and v (rows contiguous in device memory)
//     are staged by one thread's four bulk copies, completing on an
//     mbarrier, into the second of two buffers while the current TS
//     compute; the step loop stops at T, so nothing is padded;
//   * the state goes in and out through shared memory (16-byte `cp.async`
//     pieces of whole rows, XOR-swizzled against bank conflicts), so each
//     warp's device-memory accesses are contiguous rows.
// s_out may alias s0 (the whole state is read before any of it is
// written); s0 null means a zero state.  r, k, v, w and the states must be
// 16-byte aligned (the wrapper checks it; the launcher returns
// cudaErrorMisalignedAddress).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// the tile (TN channels x TM value columns a thread), the stage (TS steps)
// and the unrolling of the step loop
constexpr int TN = 8, TM = 8, TS = 16, UNROLL = 4;

template <int N>
struct Cfg {
    static constexpr int NG = N / TN;              // lanes sharing a column tile
    static constexpr int THREADS = NG * (N / TM);
    static constexpr int OUT = TM / NG;            // sums a lane keeps
    static constexpr int QN = N / 4;               // 16-byte pieces a row
    static constexpr int STAGE = 4 * TS * N;       // floats: r, k, w, v
    // two stages, then their two mbarriers
    static constexpr int SMEM = 2 * STAGE * (int)sizeof(float) + 16;
    static_assert(N % TN == 0 && TN % 4 == 0 && TM % 4 == 0,
                  "16-byte tile rows");
    static_assert(NG <= TM, "each lane of a column tile keeps an output");
    static_assert(THREADS >= 32 ? THREADS % 32 == 0 : 32 % THREADS == 0,
                  "whole warps, or one partial warp");
    static_assert(N <= 4 * TS, "the state fits a stage buffer");
    static_assert(SMEM <= 48 * 1024, "no opt-in to more shared memory");
};

// a bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device to shared memory, completing as transaction bytes on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                    "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
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

// W consecutive floats (W a multiple of 4, 16-byte aligned)
template <int W>
__device__ __forceinline__ void ldw(const float* p, float (&x)[W])
{
#pragma unroll
    for (int c = 0; c < W; c += 4) {
        const float4 y = *reinterpret_cast<const float4*>(p + c);
        x[c] = y.x; x[c + 1] = y.y; x[c + 2] = y.z; x[c + 3] = y.w;
    }
}

// Sum V values over the lanes that differ in the bits below 2 D of q (V >=
// 2 D).  Each step keeps half the values and sends the other half, so lane
// q ends with the sums of indices (q mod 2 D) * OUT + x, x < OUT = V / 2 D.
template <int V, int D>
__device__ __forceinline__ void reduce_lanes(float (&a)[V], int q,
                                             unsigned mask)
{
    if constexpr (D >= 1) {
        static_assert(V >= 2 * D, "a value for every lane");
        const bool up = q & D;
#pragma unroll
        for (int x = 0; x < V / 2; ++x) {
            const float send = up ? a[x] : a[x + V / 2];
            const float keep = up ? a[x + V / 2] : a[x];
            a[x] = keep + __shfl_xor_sync(mask, send, D);
        }
        reduce_lanes<V / 2, D / 2>(
            reinterpret_cast<float (&)[V / 2]>(a), q, mask);
    }
}

template <int N>
__global__ void __launch_bounds__(Cfg<N>::THREADS, 4) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* o, float* s_out,
    int T)
{
    using K = Cfg<N>;
    constexpr int NG = K::NG, THREADS = K::THREADS, QN = K::QN;
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x;
    const int ng = tid % NG, n0 = ng * TN, m0 = (tid / NG) * TM;
    const long long head = blockIdx.x;
    const long long base = head * T * N;
    const unsigned mask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1;

    // stage steps t0 .. t0 + TS (those before T) of r, k, w, v into buffer
    // `buf`: one thread issues a bulk copy of each operand's rows
    // (contiguous in device memory), whose bytes complete on the buffer's
    // mbarrier
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + 2 * K::STAGE);
    const float* const src[4] = {r, k, w, v};
    if (tid == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        mbar_fence_init();
    }
    __syncthreads();
    auto stage = [&](int buf, int t0) {
        if (tid == 0) {
            const uint32_t bytes = min(TS, T - t0) * N * (uint32_t)sizeof(float);
            fence_proxy_async();
            mbar_expect_tx(&bars[buf], 4 * bytes);
#pragma unroll
            for (int a = 0; a < 4; ++a)
                bulk_copy(sm + buf * K::STAGE + a * TS * N,
                          src[a] + base + (long long)t0 * N, bytes,
                          &bars[buf]);
        }
    };

    // the state goes through shared memory as whole 16-byte rows, so each
    // warp's device-memory accesses are contiguous; piece c of row i sits at
    // piece c ^ swz(i), which spreads the rows a quarter-warp reads of its
    // tiles over distinct banks
    auto swz = [](int i) { return (i / TN) % (QN < 8 ? QN : 8); };
    auto state_at = [&](float* ss, int i, int c) {   // row i, column c
        return ss + i * N + 4 * ((c / 4) ^ swz(i)) + c % 4;
    };
    float* ss = sm + K::STAGE;                       // buffer 1, free until tile 1
    stage(0, 0);
    if (s0) {
        for (int e = tid; e < N * QN; e += THREADS)
            cp_async16(state_at(ss, e / QN, 4 * (e % QN)),
                       s0 + (head * N + e / QN) * N + 4 * (e % QN));
    }
    cp_async_commit();
    float uu[TN], s[TN][TM];
#pragma unroll
    for (int a = 0; a < TN; ++a)
        uu[a] = u[head * N + n0 + a];
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int a = 0; a < TN; ++a)
#pragma unroll
        for (int c = 0; c < TM; c += 4) {
            const float4 x = s0 ? *reinterpret_cast<const float4*>(
                                      state_at(ss, n0 + a, m0 + c))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            s[a][c] = x.x; s[a][c + 1] = x.y; s[a][c + 2] = x.z;
            s[a][c + 3] = x.w;
        }
    __syncthreads();                 // buffer 1 takes tile 1 next

    const int ntiles = (T + TS - 1) / TS;
    for (int tile = 0; tile < ntiles; ++tile) {
        const int t0 = tile * TS, steps = min(TS, T - t0);
        const float* rs = sm + (tile & 1) * K::STAGE;
        const float* ks = rs + TS * N;
        const float* ws = ks + TS * N;
        const float* vs = ws + TS * N;
        if (tile + 1 < ntiles)
            stage((tile + 1) & 1, t0 + TS);
        mbar_wait(&bars[tile & 1], (tile >> 1) & 1);

        // the output of step i from this lane's sums over its channels:
        // reduced over the NG lanes of the column tile and stored
        auto emit = [&](float (&acc)[TM], int i) {
            reduce_lanes<TM, NG / 2>(acc, ng, mask);
#pragma unroll
            for (int x = 0; x < K::OUT; ++x)
                o[base + (long long)(t0 + i) * N + m0 + ng * K::OUT + x]
                    = acc[x];
        };
        // step i: o_j = p v_j + sum_i r_i S_ij over this thread's channels
        // (p = r . (u k) over them: the bonus folded in), then the state
#pragma unroll UNROLL
        for (int i = 0; i < steps; ++i) {
            float x[TN], y[TN], z[TN], vv[TM], acc[TM];
            ldw<TN>(rs + i * N + n0, x);
            ldw<TN>(ks + i * N + n0, y);
            ldw<TN>(ws + i * N + n0, z);
            ldw<TM>(vs + i * N + m0, vv);
            float p = 0.f;
#pragma unroll
            for (int a = 0; a < TN; ++a)
                p = fmaf(x[a], uu[a] * y[a], p);
#pragma unroll
            for (int c = 0; c < TM; ++c)
                acc[c] = p * vv[c];
#pragma unroll
            for (int a = 0; a < TN; ++a)
#pragma unroll
                for (int c = 0; c < TM; ++c)
                    acc[c] = fmaf(x[a], s[a][c], acc[c]);
#pragma unroll
            for (int a = 0; a < TN; ++a)
#pragma unroll
                for (int c = 0; c < TM; ++c)
                    s[a][c] = fmaf(z[a], s[a][c], y[a] * vv[c]);
            emit(acc, i);
        }
        __syncthreads();             // the stage is refilled two tiles on
    }
#pragma unroll
    for (int a = 0; a < TN; ++a)
#pragma unroll
        for (int c = 0; c < TM; c += 4)
            *reinterpret_cast<float4*>(state_at(sm, n0 + a, m0 + c))
                = make_float4(s[a][c], s[a][c + 1], s[a][c + 2], s[a][c + 3]);
    __syncthreads();
    for (int e = tid; e < N * QN; e += THREADS)
        *reinterpret_cast<float4*>(s_out + (head * N + e / QN) * N
                                   + 4 * (e % QN))
            = *reinterpret_cast<const float4*>(state_at(sm, e / QN,
                                                        4 * (e % QN)));
}

template <int N>
int launch(int BH, int T, const float* r, const float* k, const float* v,
           const float* w, const float* u, const float* s0, float* o,
           float* s_out, cudaStream_t st)
{
    wkv6_kernel<N><<<BH, Cfg<N>::THREADS, Cfg<N>::SMEM, st>>>(
        r, k, v, w, u, s0, o, s_out, T);
    return (int)cudaGetLastError();
}

template <int N>
int config(int* out)
{
    out[0] = Cfg<N>::THREADS;
    out[1] = Cfg<N>::SMEM;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], wkv6_kernel<N>, Cfg<N>::THREADS, Cfg<N>::SMEM);
}

bool misaligned(const void* p)
{
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// r, k, v, w, o: [BH, T, N] f32 contiguous; u: [BH, N]; s0 (nullable) and
// s_out: [BH, N, N] f32 contiguous, may alias.  r, k, v, w and the states
// 16-byte aligned.  N in {8, 16, 32, 64}.
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* o, void* s_out, int BH, int T,
    int N, void* stream)
{
    if (misaligned(r) || misaligned(k) || misaligned(v) || misaligned(w)
        || misaligned(s0) || misaligned(s_out))
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

// The launch shape at head size N: out[0..2] = threads a block (one block a
// head), dynamic shared memory in bytes, and blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int wkv6_config(int N, int* out)
{
    switch (N) {
        case 8: return config<8>(out);
        case 16: return config<16>(out);
        case 32: return config<32>(out);
        case 64: return config<64>(out);
        default: return (int)cudaErrorInvalidValue;
    }
}
