// Paged decode attention: one query token per sequence attends over its KV
// pages through the page table (the ADDRGEN/MMU analogue, paper C1 + C2).
//
// Replaces the TPU kernel `_paged_attn_kernel` / `paged_decode_attention`
// in src/repro/kernels/paged_attention.py, including its int8-pool variant
// (`quantized`, src/repro/kernels/paged_attention.py:74-98).
//
// Bound on the card: bytes.  Each (sequence, KV head) reads len x D keys
// and values once and does ~4 x G x D operations per token read (G query
// heads share the page), far below the card's balance point.  The design:
//   * the page range of a sequence is split over blocks (flash-decoding):
//     block (KV head, sequence, split) walks `pages_per_split` pages and
//     writes an unnormalised partial (running max, normaliser, f32
//     accumulator); a second kernel merges the splits.  A decode batch of
//     B sequences thus fills B x Hkv x n_split blocks instead of B x Hkv,
//     which is what keeps the memory system busy at small batch;
//   * one block serves all G query heads of its KV head, so every K/V page
//     is read from device memory once, not G times;
//   * the block reads the page-table entry of each page it stages (one
//     translation per page-bounded burst), clamps -1 to frame 0, and only
//     visits pages that intersect [max(len - window, 0), len);
//   * up to 64 tokens (whole pages) are staged in shared memory at once,
//     so the block synchronises four times per tile, not per page;
//   * int8 pools are a compile-time variant: pages are loaded at one byte
//     per element and dequantized after the load (x * kv_scale, rounded to
//     the query's dtype, as the TPU kernel does in VMEM), so device-memory
//     traffic stays at the narrow width;
//   * an empty sequence (l == 0 in every split) yields zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;                     // 4 warps
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, bool QUANT>
__device__ __forceinline__ float load_kv(const void* pool, long long i,
                                         float kv_scale) {
    if (QUANT) {
        const float x = (float)static_cast<const int8_t*>(pool)[i] * kv_scale;
        return round_to(x, static_cast<const T*>(nullptr));
    }
    return to_f(static_cast<const T*>(pool)[i]);
}

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the query's and output's type; the
// pools hold the same type, or int8 when quantized != 0).  window <= 0
// means no window.  part_acc / part_ml: f32 scratch of
// B * Hkv * n_split * G * D and B * Hkv * n_split * G * 2 elements; each
// split covers pages_per_split pages, staged tile_pages at a time.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lens, void* o, void* part_acc, void* part_ml, int B, int Hkv,
    int G, int D, int page, int max_pages, long long table_sb, int window,
    float scale, float kv_scale, int pages_per_split, int n_split,
    int tile_pages, int dtype, int quantized, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* acc = static_cast<float*>(part_acc);
    float* ml = static_cast<float*>(part_ml);
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
