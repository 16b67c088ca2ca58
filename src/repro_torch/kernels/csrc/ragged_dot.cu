// Grouped (ragged) matrix product out[M, N] = xs[M, K] @ w[g(m)], rows
// sorted by group: group e owns rows [off[e], off[e] + group_sizes[e]),
// off the exclusive prefix sum of group_sizes [E] (int32, on the device);
// rows past the last group are zero.  bf16 or f32 operands, f32 sums, the
// output in the operands' dtype (rounded once, to nearest even).
//
// Replaces jax.lax.ragged_dot in src/repro/models/moe.py:132-136 (the
// drop-free MoE dispatch of the serve path).  It is not a TPU kernel: XLA
// lowers ragged_dot itself.  The port needs its own because the group
// sizes are computed on the device inside a CUDA graph, so nothing may
// read them on the host: a loop of per-expert products would.
//
// Grid: static in M.  Each block of the x axis is one BM-row tile of one
// group: the groups' tiles are numbered in group order, then the tiles of
// the rows past the last group (written as zeros).  Their count is at most
// ceil(M / BM) + E, the grid's x extent, whatever the sizes are; a block
// finds its tile with a warp scan of group_sizes and exits when its number
// is past the last tile.  The y axis splits N into BN-column tiles.
//
// Bound on the card: bytes at the decode shapes (each touched expert's
// [K, N] weight read once for a few rows), operations for a long prefill
// (2 M K N against M K + E K N + M N).  Two kernels; the caller picks one
// before the launch (kernels/ragged_dot.py `ragged_route`):
//
// * mma (bf16 operands whose bases and row strides are 16-byte aligned, K
//   and N multiples of 8): a 64 x 64 output tile a block, four warps of
//   32 x 32, mma.sync m16n8k16 fed by ldmatrix (w read K-major through
//   ldmatrix.trans, no transposed copy), K slabs of 32 through a 4-stage
//   cp.async ring so each block keeps three slabs of weights in flight.
//   Rows of the tile that belong to another group are zero-filled.
// * simt (f32): true f32 FMAs on the CUDA cores (the f32 contract is parity with an f32 dot; TF32 keeps
//   ~3 digits), a 64 x 64 tile a block, a 4 x 4 register tile a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64;

// Tile `tile` of the schedule, found by warp 0: sched = {group, first row,
// end row}; group E marks the zero tail, -1 a block past the last tile.
__device__ void find_tile(const int* __restrict__ sizes, int E, int M,
                          int tile, int* sched)
{
    const int lane = threadIdx.x;
    int rows = 0, tiles = 0;             // carried over the chunks of 32
    for (int base = 0; base < E; base += 32) {
        const int e = base + lane;
        const int s = e < E ? min(max(sizes[e], 0), M) : 0;
        int inc = s;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += v;
        }
        const int start = min(rows + inc - s, M), end = min(rows + inc, M);
        const int nt = (end - start + BM - 1) / BM;
        int tinc = nt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, tinc, d);
            if (lane >= d) tinc += v;
        }
        const int t0 = tiles + tinc - nt;
        const bool hit = tile >= t0 && tile < t0 + nt;
        const unsigned who = __ballot_sync(0xffffffffu, hit);
        if (hit) {
            sched[0] = e;
            sched[1] = start + (tile - t0) * BM;
            sched[2] = end;
        }
        if (who) return;
        rows = min(rows + __shfl_sync(0xffffffffu, inc, 31), M);
        tiles += __shfl_sync(0xffffffffu, tinc, 31);
    }
    if (lane == 0) {
        const int nt = (M - rows + BM - 1) / BM;
        const bool tail = tile - tiles < nt;
        sched[0] = tail ? E : -1;
        sched[1] = rows + (tile - tiles) * BM;
        sched[2] = M;
    }
}

template <typename T>
__device__ void zero_tile(T* __restrict__ out, int r0, int r1, int n0, int N,
                          long long ldo)
{
    for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
        const int r = r0 + i / BN, c = n0 + i % BN;
        if (r < r1 && c < N) store(&out[(long long)r * ldo + c], 0.f);
    }
}

// ---------------------------------------------------------------------------
// tensor cores: mma.sync m16n8k16, 4-stage cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 32, STAGES = 4, NT = 128;
constexpr int AP = BK + 8;     // row pitches (elements): 16-byte rows for
constexpr int BP = BN + 8;     // ldmatrix, no bank conflict between rows

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros where bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The A fragments of a 16 x 16 tile: lane l addresses row l % 16, column
// 8 (l / 16).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// The B fragments of two 8-column n-tiles over 16 k from a [k][n] tile:
// lane l addresses k row l % 16, column 8 (l / 16).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// C[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 sums.  C of lane
// l: c0, c1 at (row l / 4, cols 2 (l % 4) + 0, 1), c2, c3 at row l / 4 + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NT) ragged_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out, const int* __restrict__ sizes, int M,
    int N, int K, int E, long long ldx, long long ldw, long long wes,
    long long ldo)
{
    __shared__ __align__(16) __nv_bfloat16 as[STAGES][BM][AP];
    __shared__ __align__(16) __nv_bfloat16 bs[STAGES][BK][BP];
    __shared__ int sched[3];
    if (threadIdx.x < 32) find_tile(sizes, E, M, blockIdx.x, sched);
    __syncthreads();
    const int g = sched[0], r0 = sched[1], r1 = min(sched[2], r0 + BM);
    const int n0 = blockIdx.y * BN;
    if (g < 0) return;
    if (g == E) {
        zero_tile(out, r0, r1, n0, N, ldo);
        return;
    }
    const __nv_bfloat16* wg = w + (long long)g * wes;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;      // the warp's 32 x 32 quarter
    const int nk = (K + BK - 1) / BK;

    auto load = [&](int t, int s) {
        const int k0 = t * BK;
#pragma unroll
        for (int i = 0; i < 2; ++i) {            // xs rows: 64 x 4 chunks
            const int c = tid + i * NT, r = c / 4, kc = (c % 4) * 8;
            const int gr = r0 + r, gk = k0 + kc;
            const bool in = gr < r1 && gk < K;
            cp_async16(&as[s][r][kc], in ? x + gr * ldx + gk : x, in ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {            // w rows: 32 x 8 chunks
            const int c = tid + i * NT, r = c / 8, nc = (c % 8) * 8;
            const int gk = k0 + r, gn = n0 + nc;
            const bool in = gk < K && gn < N;
            cp_async16(&bs[s][r][nc], in ? wg + gk * ldw + gn : wg,
                       in ? 16 : 0);
        }
    };

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load(s, s);
        cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();             // slab t has landed
        __syncthreads();                         // and slab t - 1 is read
        if (t + STAGES - 1 < nk) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
        cp_async_commit();
        const int s = t % STAGES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[2][4], b[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
                ldmatrix_x4(a[mi], &as[s][wm * 32 + mi * 16 + (lane & 15)]
                                      [kk * 16 + 8 * (lane >> 4)]);
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, &bs[s][kk * 16 + (lane & 15)]
                                        [wn * 32 + nj * 16 + 8 * (lane >> 4)]);
                b[2 * nj][0] = r[0];
                b[2 * nj][1] = r[1];
                b[2 * nj + 1][0] = r[2];
                b[2 * nj + 1][1] = r[3];
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + wm * 32 + mi * 16 + lane / 4 + 8 * h;
                const int c = n0 + wn * 32 + ni * 8 + 2 * (lane % 4);
                if (r < r1 && c < N)
                    *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c) =
                        __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                              acc[mi][ni][2 * h + 1]);
            }
}

int launch(const void* x, const void* w, void* out, const int* sizes, int M,
           int N, int K, int E, long long ldx, long long ldw, long long wes,
           long long ldo, cudaStream_t st)
{
    const dim3 grid((M + BM - 1) / BM + E, (N + BN - 1) / BN);
    ragged_mma_kernel<<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), sizes, M, N, K, E, ldx, ldw, wes,
        ldo);
    return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA cores: f32 FMAs
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BK = 16, NT = 256, TT = 4;

__global__ void __launch_bounds__(NT) ragged_simt_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out,
    const int* __restrict__ sizes, int M, int N, int K, int E, long long ldx,
    long long ldw, long long wes, long long ldo)
{
    __shared__ float xs[BK][BM + 1];         // the xs slab, k-major
    __shared__ float ws[BK][BN];
    __shared__ int sched[3];
    if (threadIdx.x < 32) find_tile(sizes, E, M, blockIdx.x, sched);
    __syncthreads();
    const int g = sched[0], r0 = sched[1], r1 = min(sched[2], r0 + BM);
    const int n0 = blockIdx.y * BN;
    if (g < 0) return;
    if (g == E) {
        zero_tile(out, r0, r1, n0, N, ldo);
        return;
    }
    const float* wg = w + (long long)g * wes;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    float acc[TT][TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int e = tid; e < BM * BK; e += NT) {
            const int r = e / BK, c = e % BK;
            xs[c][r] = (r0 + r < r1 && k0 + c < K)
                ? x[(long long)(r0 + r) * ldx + k0 + c] : 0.f;
        }
        for (int e = tid; e < BK * BN; e += NT) {
            const int r = e / BN, c = e % BN;
            ws[r][c] = (k0 + r < K && n0 + c < N)
                ? wg[(long long)(k0 + r) * ldw + n0 + c] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TT], b[TT];
#pragma unroll
            for (int i = 0; i < TT; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TT; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TT; ++i)
#pragma unroll
                for (int j = 0; j < TT; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TT; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r >= r1) continue;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const int c = n0 + tx + 16 * j;
            if (c < N) out[(long long)r * ldo + c] = acc[i][j];
        }
    }
}

int launch(const void* x, const void* w, void* out, const int* sizes, int M,
           int N, int K, int E, long long ldx, long long ldw, long long wes,
           long long ldo, cudaStream_t st)
{
    const dim3 grid((M + BM - 1) / BM + E, (N + BN - 1) / BN);
    ragged_simt_kernel<<<grid, NT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), sizes, M, N, K, E, ldx, ldw, wes, ldo);
    return (int)cudaGetLastError();
}

}  // namespace simt

}  // namespace

// xs [M, K] (row stride ldx), w [E, K, N] (row stride ldw, expert stride
// wes), out [M, N] (row stride ldo), all in elements; group_sizes [E]
// int32 on the device, each >= 0.  M, N, E > 0, K >= 0, M < 2^26,
// ceil(N / 64) <= 65535.  bf16 selects bf16 operands and output on the
// tensor-core kernel (16-byte-aligned bases and row strides, K and N
// multiples of 8, K > 0: kernels/ragged_dot.py `check_ragged_dot`), else
// f32 on the CUDA cores.  Returns a cudaError_t.
extern "C" int ragged_dot_launch(const void* x, const void* w, void* out,
                                 const void* group_sizes, int M, int N, int K,
                                 int E, long long ldx, long long ldw,
                                 long long wes, long long ldo, int bf16,
                                 void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* sizes = static_cast<const int*>(group_sizes);
    if (M < 1 || N < 1 || E < 1 || K < 0 || M >= (1 << 26)
        || (N + BN - 1) / BN > 65535)
        return (int)cudaErrorInvalidValue;
    if (bf16) {
        if (K < 1 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
        return tc::launch(x, w, out, sizes, M, N, K, E, ldx, ldw, wes, ldo, st);
    }
    return simt::launch(x, w, out, sizes, M, N, K, E, ldx, ldw, wes, ldo, st);
}
