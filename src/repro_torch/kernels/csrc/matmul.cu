// Blocked matrix product out = x @ y with an f32 accumulator, the paper's
// central benchmark kernel (section 3.1).  x [M, K] and y [K, N] are both
// f32 or both bf16, out [M, N] is f32 or bf16 (rounded once, to nearest
// even, at the store).  Any M, N, K, with no padded copies.
//
// Replaces the TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul.py, whose (bm, bn, bk) VMEM blocks feed the
// 128x128 MXU with an f32 accumulator carried across the K grid axis.
//
// Bound on the card: operations at the shapes that matter (2 M N K against
// bytes that grow as M N + N K + M K).  Two kernels; the caller picks one
// before the launch (kernels/matmul.py `matmul_route`):
//
// * wgmma (bf16 operands that TMA can address: 16-byte-aligned bases and
//   row strides).  A block owns a 128 x 256 output tile.  One producer
//   thread streams K slabs by TMA into a 4-stage ring (x [128, 64] and y
//   [64, 256] as four 64-wide boxes, 48 KB a stage, 128-byte swizzle),
//   each stage guarded by a full and an empty mbarrier.  Two consumer
//   warpgroups each run wgmma.m64n256k16 on their 64 rows, y read MN-major
//   through the descriptor's transpose bit (no transposed copy), and free
//   a stage once the products that read it have retired, one slab behind
//   the newest.  TMA zero-fills rows and columns past M, N and K, and the
//   store is guarded.  setmaxnreg gives the consumers 232 registers.
//
// * simt (f32, and bf16 that TMA cannot address).  True f32 FMAs on the
//   CUDA cores: f32 parity with an f32 dot needs them (TF32 keeps ~3
//   digits).  The caller chooses the tile by problem size (128, 64, 32 or
//   16 square), the largest that still gives every SM a block, so small
//   problems such as the paper's n = 181 spread over the card.  K slabs
//   are double-buffered: the next slab is in flight (cp.async, 16 bytes a
//   copy where rows and bases are aligned; bf16 through registers) while
//   this one computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// tensor cores: TMA -> 4-stage mbarrier ring -> wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;            // x slab [128, 64]
constexpr int B_BOX = BK * 64 * 2;              // one y box [64, 64]
constexpr int STAGE_BYTES = A_BYTES + 4 * B_BOX;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

template <typename O>
__global__ void __launch_bounds__(THREADS, 1) matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap ty,
    O* __restrict__ out, int M, int N, int K, long long ldo)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;

    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int nk = (K + BK - 1) / BK;
    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);            // one arrival per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {                              // producer warpgroup
        regs_dec<40>();
        if (threadIdx.x == 256) {
            for (int t = 0; t < nk; ++t) {
                const int s = t % STAGES;
                mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
                uint8_t* a = smem + s * STAGE_BYTES;
                mbar_expect_tx(&full[s], STAGE_BYTES);
                tma_load_2d(a, &tx, &full[s], t * BK, m0);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    tma_load_2d(a + A_BYTES + j * B_BOX, &ty, &full[s],
                                n0 + 64 * j, t * BK);
            }
        }
    } else {                                    // consumer warpgroups 0, 1
        regs_inc<232>();
        float acc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
        const int lane = threadIdx.x % 32;
        for (int t = 0; t < nk; ++t) {
            const int s = t % STAGES;
            mbar_wait(&full[s], (t / STAGES) & 1);
            const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + wg * 64 * 128;
            const uint32_t b = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_m64n256k16_ss<1>(acc, wgmma_desc(a + kk * 32, 16, 1024),
                                       wgmma_desc(b + kk * 16 * 128, B_BOX, 1024));
            wgmma_commit();
            wgmma_wait<1>();                    // slab t - 1 has been read
            if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
        }
        wgmma_wait<0>();
        reg_fence(acc);

        const int warp = (threadIdx.x % 128) / 32;
        const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
        const bool pairs = (ldo & 1) == 0;
#pragma unroll
        for (int i = 0; i < 128; i += 2) {
            const int r = r0 + 8 * ((i >> 1) & 1);
            const int c = n0 + 8 * (i >> 2) + 2 * (lane & 3);
            if (r >= M) continue;
            O* p = out + (long long)r * ldo + c;
            if (pairs && c + 1 < N) {
                if constexpr (std::is_same<O, float>::value)
                    *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
                else
                    *reinterpret_cast<__nv_bfloat162*>(p) =
                        __floats2bfloat162_rn(acc[i], acc[i + 1]);
            } else {
                if (c < N) store(p, acc[i]);
                if (c + 1 < N) store(p + 1, acc[i + 1]);
            }
        }
    }
}

template <typename O>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           long long ldx, long long ldy, long long ldo, cudaStream_t st)
{
    CUtensorMap tx, ty;
    const long long xd[2] = {K, M}, yd[2] = {N, K};
    const int xb[2] = {64, BM}, yb[2] = {64, BK};
    int err = make_bf16_map(&tx, x, 2, xd, &ldx, xb);
    if (err) return err;
    err = make_bf16_map(&ty, y, 2, yd, &ldy, yb);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(
        matmul_wgmma_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    matmul_wgmma_kernel<O><<<grid, THREADS, SMEM, st>>>(
        tx, ty, static_cast<O*>(out), M, N, K, ldo);
    return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA cores: f32 FMAs, double-buffered K slabs
// ---------------------------------------------------------------------------

namespace simt {

constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Square output tile BT x BT, K slab BK, a TT x TT register tile a thread;
// 16 threads across the tile's columns, so a warp covers two thread rows.
template <int BT_, int BK_>
struct Tile {
    static constexpr int BT = BT_, BK = BK_, TT = BT_ / 16, XP = BK_ + 4;
    static_assert(TT * TT * THREADS == BT * BT, "256 threads cover the tile");
};

// Stages the slab of step t into buffer `buf`: issue() starts the copies,
// land() finishes them (f32: cp.async, 16 bytes a copy when VEC; bf16:
// loads into registers, widened into shared memory by land()).  Out of
// range elements land as zero.
template <typename T, class C, bool VEC>
struct Loader {
    static constexpr int BT = C::BT, BK = C::BK, XP = C::XP;
    static constexpr bool F32 = std::is_same<T, float>::value;
    static constexpr int NX = F32 ? 1 : BT * BK / THREADS;
    static constexpr int NY = F32 ? 1 : BK * BT / THREADS;
    const T* x; const T* y;
    int M, N, K, m0, n0;
    long long ldx, ldy;
    float rx[NX], ry[NY];

    __device__ void issue(int t, float (*xs)[XP], float (*ys)[BT])
    {
        const int k0 = t * BK, tid = threadIdx.x;
        if constexpr (F32 && VEC) {
            for (int c = tid; c < BT * BK / 4; c += THREADS) {
                const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
                const int gr = m0 + r, gk = k0 + kc;
                const int n = gr < M ? max(0, min(4, K - gk)) : 0;
                cp_async16(&xs[r][kc], n ? x + gr * ldx + gk : x, 4 * n);
            }
            for (int c = tid; c < BK * BT / 4; c += THREADS) {
                const int r = c / (BT / 4), nc = (c % (BT / 4)) * 4;
                const int gk = k0 + r, gn = n0 + nc;
                const int n = gk < K ? max(0, min(4, N - gn)) : 0;
                cp_async16(&ys[r][nc], n ? y + gk * ldy + gn : y, 4 * n);
            }
            cp_async_commit();
        } else if constexpr (F32) {
            for (int e = tid; e < BT * BK; e += THREADS) {
                const int r = e / BK, c = e % BK;
                const bool in = m0 + r < M && k0 + c < K;
                cp_async4(&xs[r][c], in ? x + (m0 + r) * ldx + k0 + c : x,
                          in ? 4 : 0);
            }
            for (int e = tid; e < BK * BT; e += THREADS) {
                const int r = e / BT, c = e % BT;
                const bool in = k0 + r < K && n0 + c < N;
                cp_async4(&ys[r][c], in ? y + (k0 + r) * ldy + n0 + c : y,
                          in ? 4 : 0);
            }
            cp_async_commit();
        } else {
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                const int e = tid + i * THREADS, r = e / BK, c = e % BK;
                rx[i] = (m0 + r < M && k0 + c < K)
                    ? to_f(x[(m0 + r) * ldx + k0 + c]) : 0.f;
            }
#pragma unroll
            for (int i = 0; i < NY; ++i) {
                const int e = tid + i * THREADS, r = e / BT, c = e % BT;
                ry[i] = (k0 + r < K && n0 + c < N)
                    ? to_f(y[(k0 + r) * ldy + n0 + c]) : 0.f;
            }
        }
    }

    __device__ void land(float (*xs)[XP], float (*ys)[BT])
    {
        if constexpr (F32) {
            cp_async_wait_all();
        } else {
            const int tid = threadIdx.x;
#pragma unroll
            for (int i = 0; i < NX; ++i) {
                const int e = tid + i * THREADS;
                xs[e / BK][e % BK] = rx[i];
            }
#pragma unroll
            for (int i = 0; i < NY; ++i) {
                const int e = tid + i * THREADS;
                ys[e / BT][e % BT] = ry[i];
            }
        }
    }
};

template <typename T, typename O, class C, bool VEC>
__global__ void __launch_bounds__(THREADS) matmul_simt_kernel(
    const T* __restrict__ x, const T* __restrict__ y, O* __restrict__ out,
    int M, int N, int K, long long ldx, long long ldy, long long ldo)
{
    constexpr int BT = C::BT, BK = C::BK, TT = C::TT, XP = C::XP;
    __shared__ __align__(16) float xs[2][BT][XP];   // x slab, as in memory
    __shared__ __align__(16) float ys[2][BK][BT];   // y slab, as in memory
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    Loader<T, C, VEC> ld{x, y, M, N, K, (int)blockIdx.y * BT,
                         (int)blockIdx.x * BT, ldx, ldy};
    float acc[TT][TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

    const int nk = (K + BK - 1) / BK;
    if (nk > 0) {
        ld.issue(0, xs[0], ys[0]);
        ld.land(xs[0], ys[0]);
    }
    __syncthreads();
    for (int t = 0; t < nk; ++t) {
        const int cur = t & 1;
        if (t + 1 < nk) ld.issue(t + 1, xs[cur ^ 1], ys[cur ^ 1]);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TT], b[TT];
#pragma unroll
            for (int i = 0; i < TT; ++i) a[i] = xs[cur][ty + 16 * i][k];
#pragma unroll
            for (int j = 0; j < TT; ++j) b[j] = ys[cur][k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TT; ++i)
#pragma unroll
                for (int j = 0; j < TT; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (t + 1 < nk) ld.land(xs[cur ^ 1], ys[cur ^ 1]);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TT; ++i) {
        const int r = ld.m0 + ty + 16 * i;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const int c = ld.n0 + tx + 16 * j;
            if (c < N) store(&out[r * ldo + c], acc[i][j]);
        }
    }
}

template <typename T, typename O, class C, bool VEC>
int launch_tile(const void* x, const void* y, void* out, int M, int N, int K,
                long long ldx, long long ldy, long long ldo, cudaStream_t st)
{
    const dim3 grid((N + C::BT - 1) / C::BT, (M + C::BT - 1) / C::BT);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    matmul_simt_kernel<T, O, C, VEC><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<O*>(out), M, N, K, ldx, ldy, ldo);
    return (int)cudaGetLastError();
}

template <typename T, typename O, bool VEC>
int launch_vec(const void* x, const void* y, void* out, int M, int N, int K,
               long long ldx, long long ldy, long long ldo, int tile,
               cudaStream_t st)
{
    switch (tile) {
    case 128: return launch_tile<T, O, Tile<128, 16>, VEC>(x, y, out, M, N, K, ldx, ldy, ldo, st);
    case 64: return launch_tile<T, O, Tile<64, 32>, VEC>(x, y, out, M, N, K, ldx, ldy, ldo, st);
    case 32: return launch_tile<T, O, Tile<32, 32>, VEC>(x, y, out, M, N, K, ldx, ldy, ldo, st);
    case 16: return launch_tile<T, O, Tile<16, 64>, VEC>(x, y, out, M, N, K, ldx, ldy, ldo, st);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, typename O>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           long long ldx, long long ldy, long long ldo, int tile, int vec,
           cudaStream_t st)
{
    // 16-byte copies (f32 only): the caller found the bases and row
    // strides 16-byte aligned
    if constexpr (std::is_same<T, float>::value)
        if (vec)
            return launch_vec<T, O, true>(x, y, out, M, N, K, ldx, ldy, ldo, tile, st);
    return launch_vec<T, O, false>(x, y, out, M, N, K, ldx, ldy, ldo, tile, st);
}

}  // namespace simt

}  // namespace

// Row strides ld* in elements; M, N > 0, K >= 0, ceil(M / 128) <= 65535.
// in_bf16 / out_bf16 select bf16 (else f32) operands / output; wgmma
// selects the tensor-core kernel (bf16 operands that TMA can address,
// K > 0), else the CUDA-core kernel with a tile x tile output tile (128,
// 64, 32 or 16) and, for f32 with aligned bases and row strides, vec
// 16-byte copies (kernels/matmul.py `simt_config`).  Returns a
// cudaError_t, or a negative code when a TMA tensor map could not be
// encoded (hopper.cuh).
extern "C" int matmul_launch(const void* x, const void* y, void* out, int M,
                             int N, int K, long long ldx, long long ldy,
                             long long ldo, int in_bf16, int out_bf16,
                             int wgmma, int tile, int vec, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using bf16 = __nv_bfloat16;
    if (wgmma) {
        if (!in_bf16 || K < 1) return (int)cudaErrorInvalidValue;
        return out_bf16
            ? tc::launch<bf16>(x, y, out, M, N, K, ldx, ldy, ldo, st)
            : tc::launch<float>(x, y, out, M, N, K, ldx, ldy, ldo, st);
    }
    if (in_bf16)
        return out_bf16
            ? simt::launch<bf16, bf16>(x, y, out, M, N, K, ldx, ldy, ldo, tile, vec, st)
            : simt::launch<bf16, float>(x, y, out, M, N, K, ldx, ldy, ldo, tile, vec, st);
    return out_bf16
        ? simt::launch<float, bf16>(x, y, out, M, N, K, ldx, ldy, ldo, tile, vec, st)
        : simt::launch<float, float>(x, y, out, M, N, K, ldx, ldy, ldo, tile, vec, st);
}
