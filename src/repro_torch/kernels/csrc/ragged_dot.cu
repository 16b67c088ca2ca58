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
// Grid: static in (M, N, K, E).  Every route cuts the output into BM-row
// tiles of one group and BN-column tiles: the groups' row tiles are
// numbered in group order, then the tiles of the rows past the last group
// (written as zeros).  Their count is at most ceil(M / BM) + E, whatever
// the sizes are; a block finds its tile with a warp scan of group_sizes
// and exits when its number is past the last tile, before it loads
// anything, so an untouched expert costs no bytes.  The tensor-core
// routes number their blocks column tile fastest: the blocks of one row
// tile run side by side and share its rows of xs through the L2.  No
// split of K: each output element is one block's sum in a fixed order,
// so two launches on the same operands agree bit for bit.
//
// Bound on the card: bytes at the decode shapes (each touched expert's
// [K, N] weight read once for a few rows) and at a 2,048-token prefill
// over 32 experts (M K + E K N + M N against 2 M K N); operations only
// when a few experts hold every row.  Three kernels; the caller picks
// one before the launch from the dtype and the static shapes
// (kernels/ragged_dot.py `ragged_route`):
//
// * mma (bf16, few rows per expert: decode).  A stream of the touched
//   experts' weights.  32 x 64 output tiles, so an expert's [K, N] weight
//   splits into N / 64 strips spread over the SMs (176 strips of 128 KB
//   for 22 touched experts at N = 512, all resident at once: 4 blocks fit
//   a SM).  One producer thread issues TMA boxes (w [64 k, 64 n] through
//   a 3-D map over [E, K, N], xs [32 rows, 64 k] through a 2-D map, both
//   in the 128-byte swizzle) into a 4-stage mbarrier ring: 32 KB of
//   weights in flight a block, where the card needs ~20 KB a SM to cover
//   DRAM latency (8 and 12 stages timed no faster: fewer blocks fit; an
//   evict-first L2 policy on the weight boxes timed alike with a clean L2:
//   PERF.md §6).  Four consumer warps each own 16 columns and run mma.sync
//   m16n8k16 fed by ldmatrix (w read K-major through ldmatrix.trans,
//   addresses un-swizzled by XOR); the tile's second 16 rows are skipped
//   when the group has 16 rows or fewer.
// * wgmma (bf16, many rows per expert: prefill).  matmul.cu's design over
//   groups: 128 x 128 tiles of one group, a producer warpgroup whose one
//   thread streams K slabs by TMA (xs [128, 64] through the 2-D map, w as
//   two boxes of [64 k, 64 n] through the 3-D map) into a 6-stage
//   mbarrier ring, two consumer warpgroups of wgmma.m64n128k16 with w read
//   MN-major through the descriptor's transpose bit.  A tile's box may run
//   past its group's last row into the next group's rows: they are
//   computed and masked at the store; TMA zero-fills rows past M and
//   columns past K and N.  One tile a block: a persistent variant (one
//   block a SM walking the tiles) and 128 x 256 tiles timed slower at the
//   2,048-token up/gate shape (PERF.md §6).
// * simt (f32): true f32 FMAs on the CUDA cores (the f32 contract is
//   parity with an f32 dot; TF32 keeps ~3 digits), a 64 x 64 tile a
//   block, a 4 x 4 register tile a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Row tile `tile` of the schedule for BM-row tiles, found by warp 0:
// sched = {group, first row, end row}; group E marks the zero tail, -1 a
// block past the last tile.
template <int BM>
__device__ __forceinline__ void find_tile(const int* __restrict__ sizes,
                                          int E, int M, int tile, int* sched)
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

template <int BM, int BN, typename T>
__device__ void zero_tile(T* __restrict__ out, int r0, int r1, int n0, int N,
                          long long ldo)
{
    for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
        const int r = r0 + i / BN, c = n0 + i % BN;
        if (r < r1 && c < N) store(&out[(long long)r * ldo + c], 0.f);
    }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p)
{
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The tensor maps of both tensor-core routes: xs [M, K] in boxes of [bm
// rows, 64 k], w [E, K, N] in boxes of [1, 64 k, 64 n], both 128-byte
// swizzled.  Returns 0 or hopper.cuh's negative encode error.
int make_maps(CUtensorMap* tx, CUtensorMap* tw, const void* x, const void* w,
              int M, int N, int K, int E, long long ldx, long long ldw,
              long long wes, int bm)
{
    const long long xd[2] = {K, M}, wd[3] = {N, K, E}, ws[2] = {ldw, wes};
    const int xb[2] = {64, bm}, wb[3] = {64, 64, 1};
    int err = make_bf16_map(tx, x, 2, xd, &ldx, xb);
    if (!err) err = make_bf16_map(tw, w, 3, wd, ws, wb);
    return err;
}

// ---------------------------------------------------------------------------
// route mma: few rows per expert, a deep TMA ring of weight boxes
// ---------------------------------------------------------------------------

namespace mma {

constexpr int BM = 32, BN = 64, BK = 64, STAGES = 4, CONSUMERS = 4;
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int X_BYTES = BM * BK * 2;            // xs box [32 rows, 64 k]
constexpr int W_BYTES = BK * BN * 2;            // w box [64 k, 64 n]
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// Byte offset of 16-byte chunk c of row r in a box of 128-byte rows
// written in the 128-byte swizzle (1024-aligned): chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c)
{
    return r * 128 + ((c ^ (r & 7)) << 4);
}

// The A fragments of a 16 x 16 tile: lane l addresses row l % 16, column
// 8 (l / 16).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The B fragments of two 8-column n-tiles over 16 k from a [k][n] tile:
// lane l addresses k row l % 16, column 8 (l / 16).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
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

__global__ void __launch_bounds__(THREADS, 4) ragged_mma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw,
    __nv_bfloat16* __restrict__ out, const int* __restrict__ sizes, int M,
    int N, int K, int E, int n_tiles, long long ldo)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    __shared__ int sched[3];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n0 = (blockIdx.x % n_tiles) * BN;
    if (warp == 0) {
        find_tile<BM>(sizes, E, M, blockIdx.x / n_tiles, sched);
    } else if (threadIdx.x == 32) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS);    // one arrival a consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();
    const int g = sched[0], r0 = sched[1], r1 = min(sched[2], r0 + BM);
    if (g < 0) return;
    if (g == E) {
        zero_tile<BM, BN>(out, r0, r1, n0, N, ldo);
        return;
    }
    const int nk = (K + BK - 1) / BK;

    if (warp == CONSUMERS) {                    // producer
        if (lane == 0) {
            for (int t = 0; t < nk; ++t) {
                const int s = t % STAGES;
                mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
                uint8_t* st = smem + s * STAGE_BYTES;
                mbar_expect_tx(&full[s], STAGE_BYTES);
                tma_load_3d(st + X_BYTES, &tw, &full[s], n0, t * BK, g);
                tma_load_2d(st, &tx, &full[s], t * BK, r0);
            }
        }
        return;
    }

    // consumer warp `warp`: columns [16 warp, 16 warp + 16) of the tile,
    // rows 0-15 and, when the group has more, 16-31
    const bool two = r1 - r0 > 16;
    float acc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        mbar_wait(&full[s], (t / STAGES) & 1);
        const uint32_t xa = smem_u32(smem + s * STAGE_BYTES);
        const uint32_t wb = xa + X_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[2][4], b[4];
            const int ar = lane & 15, ac = 2 * kk + (lane >> 4);
            ldmatrix_x4(a[0], xa + swz(ar, ac));
            if (two) ldmatrix_x4(a[1], xa + swz(16 + ar, ac));
            ldmatrix_x4_trans(b, wb + swz(16 * kk + (lane & 15),
                                          2 * warp + (lane >> 4)));
            mma_bf16(acc[0][0], a[0], b[0], b[1]);
            mma_bf16(acc[0][1], a[0], b[2], b[3]);
            if (two) {
                mma_bf16(acc[1][0], a[1], b[0], b[1]);
                mma_bf16(acc[1][1], a[1], b[2], b[3]);
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = r0 + 16 * mi + lane / 4 + 8 * h;
                const int c = n0 + 16 * warp + 8 * ni + 2 * (lane % 4);
                if (r < r1 && c < N)
                    *reinterpret_cast<__nv_bfloat162*>(
                        out + (long long)r * ldo + c) =
                        __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                              acc[mi][ni][2 * h + 1]);
            }
}

}  // namespace mma

// ---------------------------------------------------------------------------
// route wgmma: many rows per expert, TMA -> 6-stage mbarrier ring -> wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 6, THREADS = 384;
constexpr int NB = BN / 64;                     // w boxes a slab
constexpr int A_BYTES = BM * BK * 2;            // xs slab [128, 64]
constexpr int B_BOX = BK * 64 * 2;              // one w box [64 k, 64 n]
constexpr int STAGE_BYTES = A_BYTES + NB * B_BOX;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int ACC = BN / 2;                     // accumulators a thread

__global__ void __launch_bounds__(THREADS, 1) ragged_wgmma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw,
    __nv_bfloat16* __restrict__ out, const int* __restrict__ sizes, int M,
    int N, int K, int E, int n_tiles, long long ldo)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    __shared__ int sched[3];
    const int n0 = (blockIdx.x % n_tiles) * BN;
    if (threadIdx.x < 32) {
        find_tile<BM>(sizes, E, M, blockIdx.x / n_tiles, sched);
    } else if (threadIdx.x == 32) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);            // one arrival per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();
    const int g = sched[0], r0 = sched[1], r1 = min(sched[2], r0 + BM);
    if (g < 0) return;
    if (g == E) {
        zero_tile<BM, BN>(out, r0, r1, n0, N, ldo);
        return;
    }
    const int nk = (K + BK - 1) / BK;
    const int wgi = threadIdx.x / 128;

    if (wgi == 2) {                             // producer warpgroup
        regs_dec<40>();
        if (threadIdx.x == 256) {
            for (int t = 0; t < nk; ++t) {
                const int s = t % STAGES;
                mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
                uint8_t* a = smem + s * STAGE_BYTES;
                mbar_expect_tx(&full[s], STAGE_BYTES);
                tma_load_2d(a, &tx, &full[s], t * BK, r0);
#pragma unroll
                for (int j = 0; j < NB; ++j)
                    tma_load_3d(a + A_BYTES + j * B_BOX, &tw, &full[s],
                                n0 + 64 * j, t * BK, g);
            }
        }
        return;
    }

    regs_inc<232>();                            // consumer warpgroups 0, 1
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    const int lane = threadIdx.x % 32;
    for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES;
        mbar_wait(&full[s], (t / STAGES) & 1);
        const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + wgi * 64 * 128;
        const uint32_t b = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n128k16_ss<1>(acc, wgmma_desc(a + kk * 32, 16, 1024),
                                   wgmma_desc(b + kk * 16 * 128, B_BOX, 1024));
        wgmma_commit();
        wgmma_wait<1>();                        // slab t - 1 has been read
        if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    wgmma_wait<0>();
    reg_fence(acc);

    const int warp = (threadIdx.x % 128) / 32;
    const int rb = r0 + wgi * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < ACC; i += 2) {
        const int r = rb + 8 * ((i >> 1) & 1);
        const int c = n0 + 8 * (i >> 2) + 2 * (lane & 3);
        if (r < r1 && c < N)
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * ldo + c) =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
}

}  // namespace wg

// One launch of a tensor-core route's kernel (ragged_mma_kernel or
// ragged_wgmma_kernel, which share their parameters): xs boxes of bm rows,
// a grid of (ceil(M / bm) + E) row tiles times ceil(N / bn) column tiles.
int launch_tc(const void* kernel, int bm, int bn, int threads, int smem,
              const void* x, const void* w, void* out, const int* sizes,
              int M, int N, int K, int E, long long ldx, long long ldw,
              long long wes, long long ldo, cudaStream_t st)
{
    CUtensorMap tx, tw;
    const int err = make_maps(&tx, &tw, x, w, M, N, K, E, ldx, ldw, wes, bm);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int n_tiles = (N + bn - 1) / bn;
    const long long blocks = (long long)((M + bm - 1) / bm + E) * n_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    void* args[] = {&tx, &tw, &o, &sizes, &M, &N, &K, &E, &n_tiles, &ldo};
    return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks),
                                 dim3(threads), args, (size_t)smem, st);
}

// ---------------------------------------------------------------------------
// CUDA cores: f32 FMAs
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256, TT = 4;

__global__ void __launch_bounds__(NT) ragged_simt_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out,
    const int* __restrict__ sizes, int M, int N, int K, int E, long long ldx,
    long long ldw, long long wes, long long ldo)
{
    __shared__ float xs[BK][BM + 1];         // the xs slab, k-major
    __shared__ float ws[BK][BN];
    __shared__ int sched[3];
    if (threadIdx.x < 32) find_tile<BM>(sizes, E, M, blockIdx.x, sched);
    __syncthreads();
    const int g = sched[0], r0 = sched[1], r1 = min(sched[2], r0 + BM);
    const int n0 = blockIdx.y * BN;
    if (g < 0) return;
    if (g == E) {
        zero_tile<BM, BN>(out, r0, r1, n0, N, ldo);
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
// ceil(N / 64) <= 65535.  route: 0 simt (f32 operands and output), 1 mma,
// 2 wgmma (bf16 operands and output; 16-byte-aligned bases and row
// strides, K and N multiples of 8, K > 0: kernels/ragged_dot.py
// `check_ragged_dot`).  Returns a cudaError_t, or a negative code when a
// TMA tensor map could not be encoded (hopper.cuh).
extern "C" int ragged_dot_launch(const void* x, const void* w, void* out,
                                 const void* group_sizes, int M, int N, int K,
                                 int E, long long ldx, long long ldw,
                                 long long wes, long long ldo, int route,
                                 void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* sizes = static_cast<const int*>(group_sizes);
    if (M < 1 || N < 1 || E < 1 || K < 0 || M >= (1 << 26)
        || (N + 63) / 64 > 65535)
        return (int)cudaErrorInvalidValue;
    if (route == 0)
        return simt::launch(x, w, out, sizes, M, N, K, E, ldx, ldw, wes, ldo,
                            st);
    if (K < 1 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    if (route == 1)
        return launch_tc((const void*)mma::ragged_mma_kernel, mma::BM, mma::BN,
                         mma::THREADS, mma::SMEM, x, w, out, sizes, M, N, K,
                         E, ldx, ldw, wes, ldo, st);
    if (route == 2)
        return launch_tc((const void*)wg::ragged_wgmma_kernel, wg::BM, wg::BN,
                         wg::THREADS, wg::SMEM, x, w, out, sizes, M, N, K, E,
                         ldx, ldw, wes, ldo, st);
    return (int)cudaErrorInvalidValue;
}
