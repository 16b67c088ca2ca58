// Paged decode attention: one query token per sequence attends over its KV
// pages through the page table (the ADDRGEN/MMU analogue, paper C1 + C2).
//
// Replaces the TPU kernel `_paged_attn_kernel` / `paged_decode_attention`
// in src/repro/kernels/paged_attention.py, including its int8-pool variant
// (`quantized`, src/repro/kernels/paged_attention.py:74-98).
//
// Bound on the card: bytes.  Each (sequence, KV head) reads len x D keys
// and values once and does ~4 x G x D operations per token read (G query
// heads share the page), far below the card's balance point; at the serve
// shapes (~2 MB a call) latency and launch set the time.  Both kernels:
//   * one block serves all G query heads of its KV head, so every K/V page
//     is read from device memory once, not G times;
//   * the page range of a sequence is split over blocks (flash-decoding),
//     block (KV head, sequence, split), so a decode batch of B sequences
//     fills B x Hkv x n_split blocks, which keeps the memory system busy
//     at small batch;
//   * each page-table entry is read right before its page's burst (one
//     translation per burst), -1 clamps to frame 0, only positions in
//     [max(len - window, 0), len) count; an empty sequence yields zeros;
//   * int8 pools are a compile-time variant: pages are loaded at one byte
//     per element and dequantized after the load (x * kv_scale, rounded to
//     the query's dtype, as the TPU kernel does in VMEM).
// Two kernels; the caller picks one before the launch
// (kernels/paged_attention.py `decode_route`):
//
// * mma (bf16 q; bf16 or int8 pools; D % 16 == 0 up to 256; page % 8 ==
//   0; G <= 16): one launch.  A split takes its own sequence's reached
//   pages, cut evenly over n_split (<= 8), so no split of a short sequence
//   sits idle while another walks several pages.  Its 4 warps take the
//   split's 16-key slices in turn, each through its own 3-stage cp.async
//   ring of bf16 (or int8) K/V rows, no f32 staging.  The G heads are the
//   A rows of mma.sync m16n8k16 (padded to 16), the slice's keys the B
//   columns of S and the rows of P V (V by ldmatrix.trans; int8 pairs
//   dequantized in registers); the online softmax runs in f32 on the
//   fragments with quad shuffles.  The warps merge in shared memory, and
//   the splits of a (sequence, KV head), one thread block cluster, merge
//   through distributed shared memory: at these sizes the call is a chain
//   of device-memory round trips, and a merge through scratch in device
//   memory (the last split to arrive, by a counter) added one per split.
//   A template on the largest D (128 or 256): at 256 a warp's output
//   accumulator alone is 128 registers a thread, so Q's A fragments are
//   staged once in shared memory and read per k-step instead of held in
//   64 more registers, and the 3-stage ring of 528-byte rows takes 198 KB
//   (one block a SM); the D <= 128 code is unchanged;
//
// * simt (f32, other D, pages or views): each split walks
//   `pages_per_split` pages of the table's width, staging up to 64 tokens
//   (whole pages) as f32 in shared memory, the dot products and P V as
//   serial loops per thread; a second kernel merges the splits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;                     // 4 warps
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// grid (Hkv, B, n_split).  Partials: acc [B, Hkv, n_split, G, D] and
// ml [B, Hkv, n_split, G, 2] (running max, normaliser), both f32.
template <typename T, bool QUANT>
__global__ void __launch_bounds__(NT) paged_decode_partial(
    const T* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lens, float* __restrict__ part_acc,
    float* __restrict__ part_ml,
    int Hkv, int G, int D, int page, int max_pages, long long table_sb,
    int window, float scale, float kv_scale, int pages_per_split,
    int tile_pages)
{
    extern __shared__ float smem[];
    const int tile = tile_pages * page;      // tokens staged at once
    const int ld = D + 1;
    float* Qs = smem;                        // [G][D]
    float* Ks = Qs + G * D;                  // [tile][D+1]
    float* Vs = Ks + tile * ld;              // [tile][D]
    float* Ss = Vs + tile * D;               // [G][tile] scores, then p
    float* Acc = Ss + G * tile;              // [G][D]
    float* M = Acc + G * D;                  // [G] running max
    float* L = M + G;                        // [G] running normaliser
    float* Al = L + G;                       // [G] this tile's rescale

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int sp = blockIdx.z;
    const int n_split = gridDim.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const T* qb = q + ((long long)b * Hkv + h) * G * D;
    for (int i = tid; i < G * D; i += NT) {
        Qs[i] = to_f(qb[i]);
        Acc[i] = 0.f;
    }
    for (int g = tid; g < G; g += NT) {
        M[g] = -INFINITY;
        L[g] = 0.f;
    }

    const int len = lens[b];
    const int lo = window > 0 ? max(len - window, 0) : 0;
    const int p_end = min((len + page - 1) / page, max_pages);
    const int p0 = lo / page + sp * pages_per_split;
    const int p1 = min(p0 + pages_per_split, p_end);
    const int* trow = table + b * table_sb;

    for (int p = p0; p < p1; p += tile_pages) {
        const int ntok = min(tile_pages, p1 - p) * page;
        __syncthreads();                     // previous tile consumed
        for (int i = tid; i < ntok * D; i += NT) {
            const int t = i / D, d = i - t * D;
            // THE translation: logical page -> physical frame, per burst
            const int frame = max(trow[p + t / page], 0);
            const long long idx =
                (((long long)frame * page + t % page) * Hkv + h) * D + d;
            Ks[t * ld + d] = load_kv<T, QUANT>(k_pool, idx, kv_scale);
            Vs[t * D + d] = load_kv<T, QUANT>(v_pool, idx, kv_scale);
        }
        __syncthreads();
        for (int i = tid; i < G * ntok; i += NT) {
            const int g = i / ntok, t = i - g * ntok;
            const int pos = p * page + t;
            float dot = 0.f;
            for (int d = 0; d < D; ++d) dot += Qs[g * D + d] * Ks[t * ld + d];
            const bool valid = pos < len && pos >= lo;
            Ss[g * tile + t] = valid ? dot * scale : -INFINITY;
        }
        __syncthreads();
        for (int g = warp; g < G; g += NWARP) {   // one warp per query head
            float mx = -INFINITY;
            for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, Ss[g * tile + t]);
            mx = warp_max(mx);
            const float m_old = M[g];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
            for (int t = lane; t < ntok; t += 32) {
                const float s = Ss[g * tile + t];
                const float e = (s == -INFINITY) ? 0.f : expf(s - m_new);
                Ss[g * tile + t] = e;
                sum += e;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha =
                    (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
                L[g] = L[g] * alpha + sum;
                M[g] = m_new;
                Al[g] = alpha;
            }
        }
        __syncthreads();
        for (int i = tid; i < G * D; i += NT) {
            const int g = i / D, d = i - g * D;
            float a = Acc[i] * Al[g];
            for (int t = 0; t < ntok; ++t) a += Ss[g * tile + t] * Vs[t * D + d];
            Acc[i] = a;
        }
    }
    __syncthreads();
    const long long base = ((long long)b * Hkv + h) * n_split + sp;
    for (int i = tid; i < G * D; i += NT) part_acc[base * G * D + i] = Acc[i];
    for (int g = tid; g < G; g += NT) {
        part_ml[(base * G + g) * 2] = M[g];
        part_ml[(base * G + g) * 2 + 1] = L[g];
    }
}

// grid (Hkv, B): merge the splits of one (sequence, KV head).  One warp
// per query head turns the splits' running maxima into weights once (in
// shared memory, with the merged normaliser); then every output element
// reads each split's accumulator once.
template <typename T>
__global__ void __launch_bounds__(NT) paged_decode_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ o, int Hkv, int G, int D, int n_split)
{
    extern __shared__ float wsm[];
    float* W = wsm;                          // [G][n_split] split weights
    float* Den = W + G * n_split;            // [G] merged normaliser
    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const long long base = ((long long)b * Hkv + h) * n_split;
    for (int g = warp; g < G; g += NWARP) {
        float mx = -INFINITY;
        for (int s = lane; s < n_split; s += 32)
            mx = fmaxf(mx, part_ml[((base + s) * G + g) * 2]);
        mx = warp_max(mx);
        float den = 0.f;
        for (int s = lane; s < n_split; s += 32) {
            const float m = part_ml[((base + s) * G + g) * 2];
            // a split that saw no valid token has m == -inf and weight 0
            const float w = (m == -INFINITY) ? 0.f : expf(m - mx);
            W[g * n_split + s] = w;
            den += w * part_ml[((base + s) * G + g) * 2 + 1];
        }
        den = warp_sum(den);
        if (lane == 0) Den[g] = den;
    }
    __syncthreads();
    T* ob = o + ((long long)b * Hkv + h) * G * D;
    for (int i = tid; i < G * D; i += NT) {
        const int g = i / D;
        float num = 0.f;
        for (int s = 0; s < n_split; ++s) {
            const float w = W[g * n_split + s];
            if (w != 0.f) num += w * part_acc[(base + s) * G * D + i];
        }
        const float den = Den[g];
        store(ob + i, num / (den == 0.f ? 1.f : den));   // l == 0 guard
    }
}

template <typename T, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lens, void* o, float* part_acc,
           float* part_ml, int B, int Hkv, int G, int D, int page,
           int max_pages, long long table_sb, int window, float scale,
           float kv_scale, int pages_per_split, int n_split, int tile_pages,
           cudaStream_t stream)
{
    const int tile = tile_pages * page;
    const size_t smem = sizeof(float) *
        (size_t)(2 * G * D + tile * (D + 1) + tile * D + G * tile + 3 * G);
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_partial<T, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    paged_decode_partial<T, QUANT><<<dim3(Hkv, B, n_split), NT, smem, stream>>>(
        static_cast<const T*>(q), k_pool, v_pool,
        static_cast<const int*>(table), static_cast<const int*>(lens),
        part_acc, part_ml, Hkv, G, D, page, max_pages, table_sb, window,
        scale, kv_scale, pages_per_split, tile_pages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t wsmem = sizeof(float) * (size_t)(G * n_split + G);
    err = cudaFuncSetAttribute(
        paged_decode_combine<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsmem);
    if (err != cudaSuccess) return (int)err;
    paged_decode_combine<T><<<dim3(Hkv, B), NT, wsmem, stream>>>(
        part_acc, part_ml, static_cast<T*>(o), Hkv, G, D, n_split);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor cores: mma.sync m16n8k16 over 16-key slices, one launch
// ---------------------------------------------------------------------------

namespace mma {

constexpr int NT = 128;        // 4 warps, each an independent stream of slices
constexpr int NW = NT / 32;
constexpr int SLICE = 16;      // keys a warp takes at once
constexpr int STAGES = 3;      // slices in flight per warp
constexpr int DMAX = 256;      // the largest D; Q in registers up to QREG_D
constexpr int QREG_D = 128;
constexpr int GMAX = 16;       // query heads: the A rows, padded to 16
constexpr int NSMAX = 8;       // splits: a portable cluster's largest size

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
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

// Four 8x8 bf16 matrices, transposed: the B fragments of two 8-column
// n-tiles over 16 keys.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p)
{
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// C[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 sums.  Fragments
// of lane l (g = l / 4, t = l % 4): A a0 (row g, k 2t..2t+1), a1 (row
// g + 8), a2 (row g, k 2t+8..), a3 (row g + 8, k 2t+8..); B b0 (k 2t..2t+1,
// col g), b1 (k 2t+8..); C c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g + 8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// two int8 pool values -> bf16 pair, x * kv_scale rounded as load_kv
__device__ __forceinline__ uint32_t deq2(int8_t lo, int8_t hi, float scale)
{
    return pack_bf16((float)lo * scale, (float)hi * scale);
}

// Shared memory: each warp's ring of STAGES x (K slice, V slice), rows of
// D elements padded by 16 bytes (so 8 rows read at one column fall in 8
// different bank groups), then, for D > QREG_D, Q as 16 bf16 rows of D + 8
// (zero past G); the ring is reused after the loop for the warps' merge.
__host__ __device__ __forceinline__ int row_bytes(int D, bool quant)
{
    return D * (quant ? 1 : 2) + 16;
}

__host__ __device__ __forceinline__ int ring_bytes(int D, bool quant)
{
    return NW * STAGES * 2 * SLICE * row_bytes(D, quant);
}

__host__ __device__ __forceinline__ int smem_bytes(int D, bool quant)
{
    const int q = D > QREG_D ? GMAX * (D + 8) * 2 : 0;
    const int ring = ring_bytes(D, quant) + q;
    const int merge = (NW + 1) * GMAX * (2 + D + 8) * 4;
    return ring > merge ? ring : merge;
}

// grid (n_split, Hkv, B), clusters of (n_split, 1, 1): one cluster per
// (sequence, KV head).  Split sp of sequence b takes the reached pages
// [p_lo, p_end) of b itself, [max(len - window, 0), len), cut evenly into
// n_split ranges; its 4 warps take the range's 16-key slices in turn.
// The warps' states merge in shared memory into the split's partial (f32
// running max in log2 units, normaliser, accumulator), and the cluster's
// ranks merge the partials through distributed shared memory, each rank
// writing 1 / n_split of the output.  Nothing goes through device memory
// but q, the pages read and the output.
template <int DM, bool QUANT>
__global__ void __launch_bounds__(NT) paged_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ o, int Hkv,
    int G, int D, int page, int max_pages, long long table_sb, int window,
    float scale_log2, float kv_scale)
{
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr int ES = QUANT ? 1 : 2;                 // pool element bytes
    const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int n_split = gridDim.x;                    // the cluster's size
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g4 = lane / 4, t4 = lane % 4;
    const int RS = row_bytes(D, QUANT), SB = SLICE * RS;
    uint8_t* ring = smem + warp * STAGES * 2 * SB;

    // Q as A fragments: rows are the G heads, zero past G (loaded before
    // the length, which the rest depends on).  Up to QREG_D held in
    // registers; past it staged in shared memory behind the ring and read
    // per k-step (rows of D + 8: 8 rows at one column in 8 bank groups)
    constexpr bool QSMEM = DM > QREG_D;
    const int nk = D / 16;
    const __nv_bfloat16* qh = q + ((long long)b * Hkv + h) * G * D;
    uint32_t qa[QSMEM ? 1 : DM / 16][4];
    const int QLD = D + 8;
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
        smem + ring_bytes(D, QUANT));
    if constexpr (QSMEM) {
        for (int i = tid; i < GMAX * (D / 8); i += NT) {
            const int row = i / (D / 8), c = i % (D / 8);
            *reinterpret_cast<uint4*>(qs + row * QLD + c * 8) = row < G
                ? *reinterpret_cast<const uint4*>(qh + row * D + c * 8)
                : make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();
    } else {
#pragma unroll
        for (int kk = 0; kk < DM / 16; ++kk) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int row = g4 + 8 * (j & 1);
                const int col = kk * 16 + 2 * t4 + 8 * (j >> 1);
                qa[kk][j] = (kk < nk && row < G)
                    ? *reinterpret_cast<const uint32_t*>(qh + row * D + col)
                    : 0u;
            }
        }
    }

    // the table row's first 64 entries, read beside the length (on which
    // the split's pages depend), so the translations need no third round
    // trip to device memory; entries past 64 are read per slice
    const int* trow = table + b * table_sb;
    const int tab0 = lane < max_pages ? __ldg(trow + lane) : 0;
    const int tab1 = lane + 32 < max_pages ? __ldg(trow + lane + 32) : 0;

    const int len = lens[b];
    const int lo = window > 0 ? max(len - window, 0) : 0;
    const int p_lo = lo / page;
    const int p_end = min((len + page - 1) / page, max_pages);
    const int n_pg = max(p_end - p_lo, 0);
    const int pa = p_lo + (int)((long long)n_pg * sp / n_split);
    const int pb = p_lo + (int)((long long)n_pg * (sp + 1) / n_split);
    const int k_lo = pa * page, k_hi = min(pb * page, len);
    const int n_slices = k_hi > k_lo ? (k_hi - k_lo + SLICE - 1) / SLICE : 0;
    const int mine = n_slices > warp ? (n_slices - warp + NW - 1) / NW : 0;

    const uint8_t* kbytes = static_cast<const uint8_t*>(k_pool);
    const uint8_t* vbytes = static_cast<const uint8_t*>(v_pool);
    const int ch = D * ES / 16;                       // 16-byte chunks per row
    // copy this warp's slice j into ring stage st (an empty group past the end)
    auto issue = [&](int j, int st) {
        if (j < mine) {
            const int k0 = k_lo + (warp + j * NW) * SLICE;
            uint8_t* kt = ring + st * 2 * SB;
            // THE translation: logical page -> physical frame, right
            // before the page's copy; a 16-key slice spans at most two
            // pages (their entries from the row read at entry)
            const int pg0 = k0 / page;
            int f[2];
#pragma unroll
            for (int j2 = 0; j2 < 2; ++j2) {
                const int pg = pg0 + j2;
                const int v0 = __shfl_sync(0xffffffffu, tab0, pg & 31);
                const int v1 = __shfl_sync(0xffffffffu, tab1, pg & 31);
                f[j2] = pg < 32 ? v0 : pg < 64 ? v1
                      : pg * page < k_hi ? __ldg(trow + pg) : 0;
                f[j2] = max(f[j2], 0);
            }
#pragma unroll 4
            for (int i = lane; i < SLICE * ch; i += 32) {
                const int key = i / ch, c = i % ch, pos = k0 + key;
                if (pos >= k_hi) {
                    // a V row no key fills must be finite: P is 0 there,
                    // and 0 x NaN is NaN (K rows are masked to -inf)
                    *reinterpret_cast<uint4*>(kt + SB + key * RS + c * 16) =
                        make_uint4(0u, 0u, 0u, 0u);
                } else {
                    const int frame = pos / page == pg0 ? f[0] : f[1];
                    const long long off =
                        (((long long)frame * page + pos % page) * Hkv + h)
                        * D * ES + c * 16;
                    cp_async16(kt + key * RS + c * 16, kbytes + off);
                    cp_async16(kt + SB + key * RS + c * 16, vbytes + off);
                }
            }
        }
        cp_async_commit();
    };

    float oacc[DM / 8][4];
#pragma unroll
    for (int n = 0; n < DM / 8; ++n)
        oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) issue(st, st);
    for (int j = 0; j < mine; ++j) {
        issue(j + STAGES - 1, (j + STAGES - 1) % STAGES);
        cp_async_wait<STAGES - 1>();
        __syncwarp();
        const uint8_t* kt = ring + (j % STAGES) * 2 * SB;
        const uint8_t* vt = kt + SB;
        const int k0 = k_lo + (warp + j * NW) * SLICE;

        // S = Q K^T: two n-tiles of 8 keys; B pairs are two adjacent d of
        // one key row
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < DM / 16; ++kk) {
            if (kk >= nk) break;
            uint32_t af[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if constexpr (QSMEM) {
                    const int row = g4 + 8 * (j & 1);
                    const int col = kk * 16 + 2 * t4 + 8 * (j >> 1);
                    af[j] = *reinterpret_cast<const uint32_t*>(
                        qs + row * QLD + col);
                } else {
                    af[j] = qa[kk][j];
                }
            }
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const uint8_t* kr = kt + (n * 8 + g4) * RS;
                const int d = kk * 16 + 2 * t4;
                uint32_t b0, b1;
                if (QUANT) {
                    const int8_t* e = reinterpret_cast<const int8_t*>(kr);
                    b0 = deq2(e[d], e[d + 1], kv_scale);
                    b1 = deq2(e[d + 8], e[d + 9], kv_scale);
                } else {
                    b0 = *reinterpret_cast<const uint32_t*>(kr + 2 * d);
                    b1 = *reinterpret_cast<const uint32_t*>(kr + 2 * d + 16);
                }
                mma_bf16(sc[n], af, b0, b1);
            }
        }

        // online softmax on the fragments: rows g4 and g4 + 8, keys
        // k0 + 8 n + 2 t4 + (e & 1); the row's max and sum over the quad
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int pos = k0 + n * 8 + 2 * t4 + (e & 1);
                const float x = (pos >= lo && pos < k_hi)
                    ? sc[n][e] * scale_log2 : -INFINITY;
                sc[n][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float ref[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            ref[r] = m_new == -INFINITY ? 0.f : m_new;
            alpha[r] = exp2f(m[r] - ref[r]);
            m[r] = m_new;
        }
        float p[2][4], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                p[n][e] = exp2f(sc[n][e] - ref[e >> 1]);
                rs[e >> 1] += p[n][e];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
        // P (rounded to bf16, as the TPU kernel casts p to V's dtype) as
        // the A fragment over the slice's 16 keys
        const uint32_t pf[4] = {pack_bf16(p[0][0], p[0][1]),
                                pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]),
                                pack_bf16(p[1][2], p[1][3])};

        // O += P V over n-tiles of 8 columns of D
#pragma unroll
        for (int n = 0; n < DM / 8; ++n) {
            oacc[n][0] *= alpha[0];
            oacc[n][1] *= alpha[0];
            oacc[n][2] *= alpha[1];
            oacc[n][3] *= alpha[1];
        }
        if (QUANT) {
            const int8_t* e = reinterpret_cast<const int8_t*>(vt);
#pragma unroll
            for (int n = 0; n < DM / 8; ++n) {
                if (n >= 2 * nk) break;
                const int d = n * 8 + g4;
                const uint32_t b0 = deq2(e[(2 * t4) * RS + d],
                                         e[(2 * t4 + 1) * RS + d], kv_scale);
                const uint32_t b1 = deq2(e[(2 * t4 + 8) * RS + d],
                                         e[(2 * t4 + 9) * RS + d], kv_scale);
                mma_bf16(oacc[n], pf, b0, b1);
            }
        } else {
            // lanes 0-7 / 8-15 / 16-23 / 24-31 address keys 0-7 / 8-15 at
            // column 16 dd, then the same at 16 dd + 8
            const uint8_t* vrow =
                vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 16 * (lane >> 4);
#pragma unroll
            for (int dd = 0; dd < DM / 16; ++dd) {
                if (dd >= nk) break;
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, vrow + dd * 32);
                mma_bf16(oacc[2 * dd], pf, bv[0], bv[1]);
                mma_bf16(oacc[2 * dd + 1], pf, bv[2], bv[3]);
            }
        }
        __syncwarp();                                 // the stage may be refilled
    }
    cp_async_wait<0>();

    // merge the 4 warps' states in shared memory into the block's partial
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __syncthreads();                                  // every ring drained
    float* wm = reinterpret_cast<float*>(smem);       // [NW][16] max (log2)
    float* wl = wm + NW * GMAX;                       // [NW][16] normaliser
    const int WLD = D + 8;       // padded rows: 2-way, not 8-way, conflicts
    float* wo = wl + NW * GMAX;                       // [NW][16][D + 8]
    float* pm = wo + NW * GMAX * WLD;                 // the block's partial:
    float* pl = pm + GMAX;                            // max, normaliser and
    float* po = pl + GMAX;                            // accumulator [G][D]
    if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            wm[warp * GMAX + g4 + 8 * r] = m[r];
            wl[warp * GMAX + g4 + 8 * r] = l[r];
        }
    }
#pragma unroll
    for (int n = 0; n < DM / 8; ++n) {
        if (n >= 2 * nk) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            wo[(warp * GMAX + g4 + 8 * (e >> 1)) * WLD + n * 8 + 2 * t4
               + (e & 1)] = oacc[n][e];
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
        const int g = i / D;
        float mm = -INFINITY;
#pragma unroll
        for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wm[w * GMAX + g]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float mw = wm[w * GMAX + g];
            const float sc = mw == -INFINITY ? 0.f : exp2f(mw - mm);
            num += sc * wo[(w * GMAX + g) * WLD + i % D];
            den += sc * wl[w * GMAX + g];
        }
        po[i] = num;
        if (i % D == 0) {
            pm[g] = mm;
            pl[g] = den;
        }
    }

    // merge the splits of the cluster: after the barrier every rank reads
    // the others' partials from their shared memory (DSMEM) and writes its
    // share of the output; the second barrier keeps each block's shared
    // memory alive until every rank has read it
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    cluster.sync();
    const float* rpm[NSMAX];
    const float* rpl[NSMAX];
    const float* rpo[NSMAX];
#pragma unroll
    for (int r = 0; r < NSMAX; ++r) {
        const int rr = r < n_split ? r : 0;
        rpm[r] = cluster.map_shared_rank(pm, rr);
        rpl[r] = cluster.map_shared_rank(pl, rr);
        rpo[r] = cluster.map_shared_rank(po, rr);
    }
    __nv_bfloat16* ob = o + ((long long)b * Hkv + h) * G * D;
    for (int i = rank * NT + tid; i < G * D; i += n_split * NT) {
        const int g = i / D;
        float ms[NSMAX], ls[NSMAX], os[NSMAX];
#pragma unroll
        for (int r = 0; r < NSMAX; ++r) {         // independent remote loads
            if (r < n_split) {
                ms[r] = rpm[r][g];
                ls[r] = rpl[r][g];
                os[r] = rpo[r][i];
            }
        }
        float mm = -INFINITY;
#pragma unroll
        for (int r = 0; r < NSMAX; ++r)
            if (r < n_split) mm = fmaxf(mm, ms[r]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int r = 0; r < NSMAX; ++r) {
            if (r < n_split && ms[r] != -INFINITY) {   // a split with no key
                const float w = exp2f(ms[r] - mm);
                num += w * os[r];
                den += w * ls[r];
            }
        }
        ob[i] = __float2bfloat16(num / (den == 0.f ? 1.f : den));  // l == 0 guard
    }
    cluster.sync();
}

template <int DM, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lens, void* o, int B, int Hkv,
           int G, int D, int page, int max_pages, long long table_sb,
           int window, float scale, float kv_scale, int n_split,
           cudaStream_t stream)
{
    const int smem = smem_bytes(D, QUANT);
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_mma_kernel<DM, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    // one cluster of n_split blocks per (sequence, KV head)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_split, Hkv, B);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, paged_decode_mma_kernel<DM, QUANT>,
        static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
        static_cast<const int*>(table), static_cast<const int*>(lens),
        static_cast<__nv_bfloat16*>(o), Hkv, G, D, page, max_pages, table_sb,
        window, scale * 1.4426950408889634f, kv_scale);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace mma

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the query's and output's type; the
// pools hold the same type, or int8 when quantized != 0).  window <= 0
// means no window.  simt: part_acc / part_ml are f32 scratch of
// B * Hkv * n_split * G * D and B * Hkv * n_split * G * 2 elements, and
// each split covers pages_per_split pages, staged tile_pages at a time.
// use_mma selects the tensor-core kernel (bf16, D % 16 == 0 up to 256,
// page % 8 == 0, G <= 16, 16-byte-aligned bases, n_split <= 8: a
// cluster), whose splits cut each sequence's own pages and which needs no
// scratch; D <= 128 and D <= 256 are two instantiations.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lens, void* o, void* part_acc, void* part_ml, int B, int Hkv,
    int G, int D, int page, int max_pages, long long table_sb, int window,
    float scale, float kv_scale, int pages_per_split, int n_split,
    int tile_pages, int dtype, int quantized, int use_mma, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* acc = static_cast<float*>(part_acc);
    float* ml = static_cast<float*>(part_ml);
    if (use_mma) {
        if (dtype != 1 || D % 16 || D > mma::DMAX || page % 8 || G > mma::GMAX
            || n_split < 1 || n_split > mma::NSMAX)
            return (int)cudaErrorInvalidValue;
#define ARGS q, k_pool, v_pool, table, lens, o, B, Hkv, G, D, page, \
    max_pages, table_sb, window, scale, kv_scale, n_split, st
        if (D > mma::QREG_D)
            return quantized ? mma::launch<mma::DMAX, true>(ARGS)
                             : mma::launch<mma::DMAX, false>(ARGS);
        return quantized ? mma::launch<mma::QREG_D, true>(ARGS)
                         : mma::launch<mma::QREG_D, false>(ARGS);
#undef ARGS
    }
#define ARGS q, k_pool, v_pool, table, lens, o, acc, ml, B, Hkv, G, D, page, \
    max_pages, table_sb, window, scale, kv_scale, pages_per_split, n_split, \
    tile_pages, st
    if (dtype == 0 && !quantized) return launch<float, false>(ARGS);
    if (dtype == 0 && quantized) return launch<float, true>(ARGS);
    if (dtype == 1 && !quantized) return launch<__nv_bfloat16, false>(ARGS);
    if (dtype == 1 && quantized) return launch<__nv_bfloat16, true>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}
