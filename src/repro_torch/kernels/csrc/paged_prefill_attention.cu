// Paged prefill attention: the chunk query t of row b sits at absolute
// position starts[b] + t and attends causally over logical positions
// [0, starts[b] + t] (the cache plus the chunk's own, already written, KV),
// reading keys and values through the page table (continuation prefill:
// forks, radix-cache hits, the re-prefilled tail of a partial restore).
//
// Replaces the TPU kernel `_paged_prefill_kernel` /
// `paged_prefill_attention` in src/repro/kernels/paged_prefill_attention.py,
// including its int8-pool variant (`quantized`).
//
// Bound on the card: at the serve shapes (chunks of 16-256 tokens over a
// few hundred cached tokens, D = 128, G = 7 query heads per KV head) the
// work is ~4 x D x G operations per (query token, reachable key) against
// 2 x D x itemsize bytes per key page fetched per query block: operations
// for long chunks, bytes for short ones; at the radix serve shape both
// bounds are a few microseconds, so latency (page fetches, the causal
// walk) sets the time.  What both kernels share:
//   * the TPU grid's sequential page axis becomes a loop inside the block;
//     one block per (query block, KV head, row) holds bq whole chunk
//     tokens x the G query heads of the group as rows (token-major,
//     group-minor: row r is token r / G, head r % G), so each page is
//     read once per query block, not G times;
//   * the block walks pages 0 .. min(last_reachable_page, max_pages - 1),
//     the TPU kernel's clamp: pages above the block's causal diagonal are
//     neither loaded nor computed.  Each page-table entry is read right
//     before the page's burst (one translation per page); -1 clamps to
//     frame 0 (such keys are causally masked or feed don't-care padded
//     rows, as in the TPU kernel);
//   * int8 pools are a compile-time variant: bytes are loaded narrow and
//     dequantized after the load (x * kv_scale, rounded to the query's
//     dtype, as the TPU kernel does in VMEM);
//   * q is read through its strides (the [B, S, Hkv, G, D] view of the
//     projection, no copy); the output is written contiguous, so the
//     caller's reshape to [B, S, Hq * D] costs nothing; padded query rows
//     (t >= S) are neither read nor written; a row with no visible key
//     gives 0 (l == 0 guard).
// Two kernels; the caller picks one before the launch
// (kernels/paged_prefill_attention.py `prefill_route`):
//
// * wgmma (bf16 q; bf16 or int8 pools; D % 16 == 0 up to 128; page % 8
//   == 0 up to 64; G <= 16): the design of flash_attention.cu's tensor-core
//   kernel read through the page table.  128 query rows a block (bq = 128
//   / G tokens: 18 at G = 7), 64 for each of two consumer warpgroups.  Q
//   is read once with 16-byte loads into the 128-byte swizzle.  The pool
//   is a 3-D TMA tensor map (D, Hkv, P x page); a page is a box of
//   {64 elements, 1 head, page rows} at (64 x half, h, frame x page), so
//   a producer thread reads each page's entry and issues that page's
//   boxes into a 2-stage mbarrier ring of 128-key tiles (128 / page whole
//   pages).  S = Q K^T on wgmma (both K-major), the online softmax on the
//   accumulator fragments, P rounded to bf16 as the register A operand of
//   O += P V with V MN-major (the transpose bit).  Masks only where a
//   tile crosses a row's causal diagonal or is not full.  int8 pools:
//   TMA brings the int8 page boxes (64 bytes a row, no swizzle) into
//   their own ring; the consumers dequantize each tile into one bf16 K
//   and V tile in the swizzle wgmma reads, so device memory still moves
//   one byte per element;
//
// * simt (f32, other D, pages or views): f32 FMAs from shared memory, 64
//   rows a block (bq = 64 / G: 9 at G = 7), 4 threads per row, up to 64
//   keys (whole pages) staged as f32 at once, ~113 KB of shared memory at
//   D = 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int DMAX = 128;  // largest head_dim taken
constexpr int PMAX = 64;   // largest page taken

// ---------------------------------------------------------------------------
// tensor cores: page boxes by TMA -> mbarrier ring -> wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int ROWS = 128;      // query rows per block, 64 per consumer warpgroup
constexpr int BN = 128;        // key slots per KV tile (128 / page whole pages)
constexpr int STAGES = 2;      // KV tiles in flight
constexpr int THREADS = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int ROW = 128;       // bytes of one swizzled bf16 row: 64 of D
constexpr int DP = 128;        // D as computed: two 64-wide halves, zero past D
constexpr int NB = DP / 64;
constexpr int Q_BOX = ROWS * ROW, KV_BOX = BN * ROW;   // one half of Q, K or V
constexpr int Q_BYTES = NB * Q_BOX, KV_BYTES = NB * KV_BOX;
constexpr int RAW_ROW = 64;    // int8: bytes of one unswizzled half row
constexpr int RAW_BOX = BN * RAW_ROW, RAW_BYTES = NB * RAW_BOX;

// bf16 pools: Q, then STAGES K tiles and STAGES V tiles.  int8 pools: Q,
// one bf16 K and one bf16 V tile, then STAGES x (int8 K, int8 V).
template <bool QUANT>
struct L {
    static constexpr int KV_TILES = QUANT ? 1 : STAGES;
    static constexpr int RAW = QUANT ? STAGES * 2 * RAW_BYTES : 0;
    static constexpr int SMEM = Q_BYTES + 2 * KV_TILES * KV_BYTES + RAW
                              + 3 * STAGES * 8 + 1024;
};

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled box.
__device__ __forceinline__ int swz(int r, int c)
{
    return r * ROW + ((c ^ (r & 7)) << 4);
}

// grid (Hkv, B, ceil(S / bq)), query blocks in reverse.  tk / tv: 3-D maps (D, Hkv, P x page) of
// the pools, boxes {64, 1, page}.  q strides (elements): batch, token, KV
// head, group; unit stride along D.  o: contiguous [B, S, Hkv, G, D].
template <bool QUANT>
__global__ void __launch_bounds__(THREADS, 1) paged_prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ table,
    const int* __restrict__ starts, __nv_bfloat16* __restrict__ o,
    int S, int Hkv, int G, int D, int page, int max_pages, long long table_sb,
    int bq, float scale_log2, float kv_scale,
    long long qsb, long long qss, long long qsh, long long qsg)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* qs = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* ks = qs + Q_BYTES;                       // [KV_TILES][KV_BYTES]
    uint8_t* vs = ks + L<QUANT>::KV_TILES * KV_BYTES;
    uint8_t* raw = vs + L<QUANT>::KV_TILES * KV_BYTES;  // [STAGES][K, V] int8
    uint64_t* k_full = reinterpret_cast<uint64_t*>(raw + L<QUANT>::RAW);
    uint64_t* v_full = k_full + STAGES;
    uint64_t* empty = v_full + STAGES;

    // the last query blocks reach the most pages: they are dispatched first
    const int qb = gridDim.z - 1 - blockIdx.z, h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, wg = tid / 128;
    const int start = starts[b];
    const int t0 = qb * bq, rows = bq * G;
    // the TPU kernel's clamp: the last page any row of the block (padded
    // block end) can causally reach, capped at the table
    const int last = (start + (qb + 1) * bq - 1) / page;
    const int n_pages = min(last + 1, max_pages);
    const int tp = BN / page;                         // pages per tile
    const int n_tiles = (n_pages + tp - 1) / tp;

    // Q once, 16-byte loads through its strides into the swizzle; zero
    // past D and in padded rows
    const __nv_bfloat16* qh = q + b * qsb + h * qsh;
    for (int i = tid; i < ROWS * (DP / 8); i += THREADS) {
        const int r = i / (DP / 8), c = i % (DP / 8);
        const int t = t0 + r / G;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && t < S && c * 8 < D)
            x = *reinterpret_cast<const uint4*>(qh + t * qss + (r % G) * qsg
                                                + c * 8);
        *reinterpret_cast<uint4*>(qs + (c / 8) * Q_BOX + swz(r, c % 8)) = x;
    }
    if (!QUANT) {
        // key slots that no page of a tile fills must hold finite values:
        // P is 0 there, and 0 x NaN is NaN
        uint4* kv = reinterpret_cast<uint4*>(ks);
        for (int i = tid; i < 2 * STAGES * KV_BYTES / 16; i += THREADS)
            kv[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&empty[s], 8);                  // one per consumer warp
        }
        mbar_fence_init();
    }
    fence_proxy_async();                              // Q and zeros -> wgmma, TMA
    __syncthreads();

    if (wg == 2) {                                    // producer warpgroup
        regs_dec<40>();
        if (tid < 256 + 32) {                          // one warp: lane 0 issues
            const int lane = tid % 32;
            const int* trow = table + b * table_sb;
            const int row_bytes = QUANT ? RAW_ROW : ROW;
            const int half_bytes = QUANT ? RAW_BOX : KV_BOX;
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % STAGES;
                const int p0 = t * tp, np = min(tp, n_pages - p0);
                // THE translation: logical page -> physical frame, each of
                // the tile's (<= 16) entries read by its own lane right
                // before the tile's bursts, while the stage drains
                const int fr = lane < np ? max(trow[p0 + lane], 0) : 0;
                mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
                uint8_t* kt = QUANT ? raw + s * 2 * RAW_BYTES : ks + s * KV_BYTES;
                uint8_t* vt = QUANT ? kt + RAW_BYTES : vs + s * KV_BYTES;
                const uint32_t bytes = np * NB * page * row_bytes;
                if (lane == 0) {
                    mbar_expect_tx(&k_full[s], bytes);
                    mbar_expect_tx(&v_full[s], bytes);
                }
                for (int j = 0; j < np; ++j) {
                    const int frame = __shfl_sync(0xffffffffu, fr, j);
                    if (lane) continue;
#pragma unroll
                    for (int hf = 0; hf < NB; ++hf) {
                        const int off = hf * half_bytes + j * page * row_bytes;
                        tma_load_3d(kt + off, &tk, &k_full[s], 64 * hf, h,
                                    frame * page);
                        tma_load_3d(vt + off, &tv, &v_full[s], 64 * hf, h,
                                    frame * page);
                    }
                }
            }
        }
        return;
    }

    regs_inc<232>();                                  // consumer warpgroups
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int wrow = wg * 64;                         // first row of this warpgroup
    const int r0 = wrow + warp * 16 + lane / 4;       // rows r0 and r0 + 8
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) qpos[r] = start + t0 + (r0 + 8 * r) / G;
    const int wg_qpos = start + t0 + wrow / G;        // its first row's position
    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t qa = smem_u32(qs) + wrow * ROW;

    for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, k0 = t * tp * page;
        const uint32_t parity = (t / STAGES) & 1;
        const int tile_keys = min(tp, n_pages - t * tp) * page;
        uint32_t ka, va;
        if (QUANT) {
            mbar_wait(&k_full[s], parity);
            mbar_wait(&v_full[s], parity);
            named_bar_sync(1, 256);       // both warpgroups done with the last tile
            // dequantize: 16 int8 of a half row -> 16 bf16, two swizzled
            // chunks; x * kv_scale rounded to bf16, as load_kv
            const uint8_t* src = raw + s * 2 * RAW_BYTES;
            for (int i = tid; i < 2 * NB * BN * 4; i += 256) {
                const int c = i % 4, r = (i / 4) % BN, hf = (i / (4 * BN)) % NB;
                const int kv = i / (4 * BN * NB);
                const int4 x = *reinterpret_cast<const int4*>(
                    src + kv * RAW_BYTES + hf * RAW_BOX + r * RAW_ROW + c * 16);
                const int8_t* e = reinterpret_cast<const int8_t*>(&x);
                uint32_t w[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const __nv_bfloat162 p = __floats2bfloat162_rn(
                        (float)e[2 * j] * kv_scale,
                        (float)e[2 * j + 1] * kv_scale);
                    w[j] = *reinterpret_cast<const uint32_t*>(&p);
                }
                uint8_t* dst = (kv ? vs : ks) + hf * KV_BOX;
                *reinterpret_cast<uint4*>(dst + swz(r, 2 * c)) =
                    make_uint4(w[0], w[1], w[2], w[3]);
                *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1)) =
                    make_uint4(w[4], w[5], w[6], w[7]);
            }
            fence_proxy_async();
            named_bar_sync(1, 256);
            if (lane == 0) mbar_arrive(&empty[s]);   // the int8 stage is free
            ka = smem_u32(ks);
            va = smem_u32(vs);
        } else {
            ka = smem_u32(ks + s * KV_BYTES);
            va = smem_u32(vs + s * KV_BYTES);
            mbar_wait(&k_full[s], parity);
        }
        // S = Q K^T, both K-major (D contiguous)
        float sacc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_m64n128k16_ss<0>(
                sacc,
                wgmma_desc(qa + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, 1024),
                wgmma_desc(ka + (kk / 4) * KV_BOX + (kk % 4) * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sacc);

        // online softmax on the fragment, scores in log2 units; masked
        // only where the tile crosses the warpgroup's causal diagonal or
        // holds fewer than 128 keys
        const bool masked = tile_keys < BN || k0 + BN - 1 > wg_qpos;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            float x = sacc[i] * scale_log2;
            if (masked) {
                const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
                if (col >= tile_keys || k0 + col > qpos[(i >> 1) & 1])
                    x = -INFINITY;
            }
            sacc[i] = x;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float ref[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            ref[r] = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far
            alpha[r] = exp2f(m[r] - ref[r]);
            m[r] = m_new;
        }
        // P in bf16 as wgmma's A fragments (flash_attention.cu's layout)
        uint32_t pa[BN / 16][4];
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
            const int r = (i >> 1) & 1;
            const float p0 = exp2f(sacc[i] - ref[r]);
            const float p1 = exp2f(sacc[i + 1] - ref[r]);
            rs[r] += p0 + p1;
            const __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
            pa[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pp);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

        // O += P V, V MN-major (D contiguous): the transpose bit
        if (!QUANT) mbar_wait(&v_full[s], parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            const uint64_t dv = wgmma_desc(va + kk * 16 * ROW, KV_BOX, 1024);
            wgmma_m64n128k16_rs<1>(oacc, pa[kk], dv);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(oacc);
        if (!QUANT && lane == 0) mbar_arrive(&empty[s]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];      // l == 0 guard
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r, tq = t0 + row / G;
        if (row >= rows || tq >= S) continue;
        __nv_bfloat16* orow =
            o + ((((long long)b * S + tq) * Hkv + h) * G + row % G) * D;
#pragma unroll
        for (int i = 2 * r; i < DP / 2; i += 4) {
            const int col = 8 * (i >> 2) + 2 * (lane & 3);
            if (col < D)                               // D % 16 == 0: pairs
                *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                    __floats2bfloat162_rn(oacc[i] * inv[r],
                                          oacc[i + 1] * inv[r]);
        }
    }
}

template <bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* starts, void* o,
           const long long* qs, int B, int S, int Hkv, int G, int D,
           int page, int max_pages, int bq, long long table_sb, float scale,
           float kv_scale, int n_frames, cudaStream_t stream)
{
    // the pool [P, page, Hkv, D] as 3-D (D, Hkv, P x page), innermost
    // first; a box is 64 elements of one head's row, `page` rows deep
    CUtensorMap tk, tv;
    const long long dims[3] = {D, Hkv, (long long)n_frames * page};
    const long long strides[2] = {D, (long long)Hkv * D};
    const int box[3] = {64, 1, page};
    const CUtensorMapDataType dt = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapSwizzle sw = QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE
                                        : CU_TENSOR_MAP_SWIZZLE_128B;
    const int eb = QUANT ? 1 : 2;
    int err = make_map(&tk, dt, eb, k_pool, 3, dims, strides, box, sw);
    if (!err) err = make_map(&tv, dt, eb, v_pool, 3, dims, strides, box, sw);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_wgmma_kernel<QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L<QUANT>::SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(Hkv, B, (S + bq - 1) / bq);
    paged_prefill_wgmma_kernel<QUANT><<<grid, THREADS, L<QUANT>::SMEM, stream>>>(
        tk, tv, static_cast<const __nv_bfloat16*>(q),
        static_cast<const int*>(table), static_cast<const int*>(starts),
        static_cast<__nv_bfloat16*>(o), S, Hkv, G, D, page, max_pages,
        table_sb, bq, scale * 1.4426950408889634f, kv_scale,
        qs[0], qs[1], qs[2], qs[3]);
    return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA cores: f32 FMAs from shared memory
// ---------------------------------------------------------------------------

namespace simt {

constexpr int ROWS = 64;   // query rows (bq tokens x G heads) per block
constexpr int BK = 64;     // keys staged per tile (whole pages)
constexpr int NT = 256;    // threads per block: 4 per query row

// grid (ceil(S / bq), Hkv, B).  q strides (elements): batch, token, KV
// head, group; unit stride along D.  o: contiguous [B, S, Hkv, G, D].
template <typename T, bool QUANT>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ starts, T* __restrict__ o,
    int S, int Hkv, int G, int D, int page, int max_pages, long long table_sb,
    int bq, int tile_pages, float scale, float kv_scale,
    long long qsb, long long qss, long long qsh, long long qsg)
{
    extern __shared__ float smem[];
    const int ld = D + 1;                    // padded rows: no bank conflicts
    float* Qs = smem;                        // [ROWS][D+1]
    float* Ks = Qs + ROWS * ld;              // [BK][D+1]
    float* Vs = Ks + BK * ld;                // [BK][D]
    float* Ps = Vs + BK * D;                 // [ROWS][BK+1]

    const int qb = blockIdx.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int r = tid >> 2;                  // query row of this thread
    const int c4 = tid & 3;                  // its quarter of the row
    const int rows = bq * G;
    const int t0 = qb * bq;                  // first chunk token of the block
    const int start = starts[b];

    const T* qb_ptr = q + b * qsb + h * qsh;
    for (int i = tid; i < ROWS * D; i += NT) {
        const int rr = i / D, d = i - rr * D;
        const int tq = t0 + rr / G;
        float x = 0.f;
        if (rr < rows && tq < S)
            x = to_f(qb_ptr[tq * qss + (rr % G) * qsg + d]);
        Qs[rr * ld + d] = x;
    }

    float acc[DMAX / 4];
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) acc[i] = 0.f;
    float m = -INFINITY, l = 0.f;
    const int tq = t0 + r / G;
    const bool row_in = r < rows && tq < S;
    const int qpos = start + tq;             // absolute position of the row

    // last page any row of this block can causally reach (the padded
    // block end: the TPU kernel's last_reachable_page), capped at the table
    const int last = (start + (qb + 1) * bq - 1) / page;
    const int n_pages = min(last + 1, max_pages);
    const int* trow = table + b * table_sb;

    for (int p0 = 0; p0 < n_pages; p0 += tile_pages) {
        const int ntok = min(tile_pages, n_pages - p0) * page;
        __syncthreads();                     // Q staged / last tile consumed
        for (int i = tid; i < BK * D; i += NT) {
            const int t = i / D, d = i - t * D;
            float kx = 0.f, vx = 0.f;
            if (t < ntok) {
                // THE translation: logical page -> physical frame, per burst
                const int frame = max(trow[p0 + t / page], 0);
                const long long idx =
                    (((long long)frame * page + t % page) * Hkv + h) * D + d;
                kx = load_kv<T, QUANT>(k_pool, idx, kv_scale);
                vx = load_kv<T, QUANT>(v_pool, idx, kv_scale);
            }
            Ks[t * ld + d] = kx;
            Vs[t * D + d] = vx;
        }
        __syncthreads();

        float s[BK / 4];
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) {
            const int kk = c4 + 4 * j;
            const int kpos = p0 * page + kk;
            float dot = 0.f;
            for (int d = 0; d < D; ++d) dot += Qs[r * ld + d] * Ks[kk * ld + d];
            const bool ok = row_in && kk < ntok && kpos <= qpos;
            s[j] = ok ? dot * scale : -INFINITY;
            tmax = fmaxf(tmax, s[j]);
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m, tmax);
        const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) {
            const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
            Ps[r * (BK + 1) + c4 + 4 * j] = p;
            psum += p;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l = l * alpha + psum;
        m = m_new;
        __syncwarp();                        // the row's P is in shared memory
#pragma unroll
        for (int i = 0; i < DMAX / 4; ++i) {
            const int d = c4 + 4 * i;
            if (d < D) {
                float a = acc[i] * alpha;
                for (int kk = 0; kk < ntok; ++kk)
                    a += Ps[r * (BK + 1) + kk] * Vs[kk * D + d];
                acc[i] = a;
            }
        }
    }

    if (row_in) {
        const float inv = (l == 0.f) ? 1.f : 1.f / l;   // l == 0 guard
        T* ob = o + ((((long long)b * S + tq) * Hkv + h) * G + r % G) * D;
#pragma unroll
        for (int i = 0; i < DMAX / 4; ++i) {
            const int d = c4 + 4 * i;
            if (d < D) store(ob + d, acc[i] * inv);
        }
    }
}

template <typename T, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* starts, void* o,
           const long long* qs, int B, int S, int Hkv, int G, int D,
           int page, int max_pages, int bq, long long table_sb, float scale,
           float kv_scale, cudaStream_t stream)
{
    const size_t smem = sizeof(float) *
        (size_t)(ROWS * (D + 1) + BK * (D + 1) + BK * D + ROWS * (BK + 1));
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<T, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int tile_pages = BK / page;
    const dim3 grid((S + bq - 1) / bq, Hkv, B);
    paged_prefill_kernel<T, QUANT><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), k_pool, v_pool,
        static_cast<const int*>(table), static_cast<const int*>(starts),
        static_cast<T*>(o), S, Hkv, G, D, page, max_pages, table_sb, bq,
        tile_pages, scale, kv_scale, qs[0], qs[1], qs[2], qs[3]);
    return (int)cudaGetLastError();
}

}  // namespace simt

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the query's and output's type; the
// pools hold the same type, or int8 when quantized != 0).  q_strides: the
// element strides of q's batch, token, KV-head and group axes.  bq: query
// tokens per block.  n_frames: the pools' first dimension.  wgmma selects
// the tensor-core kernel (bf16 q, D % 16 == 0, page % 8 == 0, bq * G <=
// 128, 16-byte-aligned q rows and pools), else the CUDA-core kernel (bq *
// G <= 64).  Takes D <= 128 and page <= 64.  Returns a cudaError_t, or a
// negative code when a TMA tensor map could not be encoded (hopper.cuh).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* starts, void* o, const void* q_strides, int B, int S,
    int Hkv, int G, int D, int page, int max_pages, int bq,
    long long table_sb, float scale, float kv_scale, int dtype,
    int quantized, int n_frames, int wgmma, void* stream)
{
    if (D < 1 || D > DMAX || page < 1 || page > PMAX || bq < 1 || G < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long* qs = static_cast<const long long*>(q_strides);
#define ARGS q, k_pool, v_pool, table, starts, o, qs, B, S, Hkv, G, D, page, \
    max_pages, bq, table_sb, scale, kv_scale
    if (wgmma) {
        if (dtype != 1 || D % 16 || page % 8 || bq * G > tc::ROWS)
            return (int)cudaErrorInvalidValue;
        if (quantized) return tc::launch<true>(ARGS, n_frames, st);
        return tc::launch<false>(ARGS, n_frames, st);
    }
    if (bq * G > simt::ROWS) return (int)cudaErrorInvalidValue;
    if (dtype == 0 && !quantized) return simt::launch<float, false>(ARGS, st);
    if (dtype == 0 && quantized) return simt::launch<float, true>(ARGS, st);
    if (dtype == 1 && !quantized)
        return simt::launch<__nv_bfloat16, false>(ARGS, st);
    if (dtype == 1 && quantized)
        return simt::launch<__nv_bfloat16, true>(ARGS, st);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}
