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
// for long chunks, bytes for short ones.  This first version is a plain
// SIMT kernel (f32 FMAs from shared memory, no tensor cores), the shape of
// the port's flash_attention kernel with the KV read through the table:
//   * the TPU grid's sequential page axis becomes a loop inside the block;
//     one block per (query block, KV head, row) holds ROWS = bq x G query
//     rows (token-major, group-minor: row r is token r / G, head r % G),
//     4 threads per row, the f32 accumulator in registers;
//   * bq = 64 / G whole query tokens (9 at G = 7), so the accumulator fits
//     in registers and shared memory stays ~113 KB at D = 128 (dynamic
//     opt-in).  `pages_touched` in the wrapper module counts with this bq;
//   * the block walks pages 0 .. min(last_reachable_page, max_pages - 1),
//     the TPU kernel's clamp: pages above the block's causal diagonal are
//     neither loaded nor computed.  Each page-table entry is read by the
//     block right before its burst (one translation per page); -1 clamps
//     to frame 0 (such keys are causally masked or feed don't-care padded
//     rows, as in the TPU kernel);
//   * up to 64 keys (whole pages) are staged in shared memory at once and
//     shared by all G heads of the group, so each page is read from device
//     memory once per query block, not G times;
//   * int8 pools are a compile-time variant: bytes are loaded narrow and
//     dequantized after the load (x * kv_scale, rounded to the query's
//     dtype, as the TPU kernel does in VMEM);
//   * q is read through its strides (the [B, S, Hkv, G, D] view of the
//     projection, no copy); the output is written contiguous, so the
//     caller's reshape to [B, S, Hq * D] costs nothing;
//   * padded query rows (t >= S) are neither read nor written; a row with
//     no visible key would give 0 (l == 0 guard).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 64;   // query rows (bq tokens x G heads) per block
constexpr int BK = 64;     // keys staged per tile (whole pages)
constexpr int NT = 256;    // threads per block: 4 per query row
constexpr int DMAX = 128;  // largest head_dim taken

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the query's and output's type; the
// pools hold the same type, or int8 when quantized != 0).  q_strides: the
// element strides of q's batch, token, KV-head and group axes.  bq: query
// tokens per block, bq * G <= 64.  Takes D <= 128 and page <= 64.
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* starts, void* o, const void* q_strides, int B, int S,
    int Hkv, int G, int D, int page, int max_pages, int bq,
    long long table_sb, float scale, float kv_scale, int dtype,
    int quantized, void* stream)
{
    if (D < 1 || D > DMAX || page < 1 || page > BK || bq < 1 || G < 1
        || bq * G > ROWS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long* qs = static_cast<const long long*>(q_strides);
#define ARGS q, k_pool, v_pool, table, starts, o, qs, B, S, Hkv, G, D, page, \
    max_pages, bq, table_sb, scale, kv_scale, st
    if (dtype == 0 && !quantized) return launch<float, false>(ARGS);
    if (dtype == 0 && quantized) return launch<float, true>(ARGS);
    if (dtype == 1 && !quantized) return launch<__nv_bfloat16, false>(ARGS);
    if (dtype == 1 && quantized) return launch<__nv_bfloat16, true>(ARGS);
#undef ARGS
    return (int)cudaErrorInvalidValue;
}
