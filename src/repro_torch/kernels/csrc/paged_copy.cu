// Paged copy: write src[b, :lens[b]] into pool frames through the page table,
// one page-bounded burst per block (the paper's C2-burst, one translation per
// burst).  One launcher serves both TPU kernels' counterparts:
//   * starts == null   chunk token t lands at logical position t (prefill);
//   * starts != null   chunk token t lands at logical position starts[b] + t,
//                      which need not be page-aligned (continuation prefill).
// One launch writes one or two (src, pool) tensors of one layout: a layer's
// K and V are gridDim.z = 2 of the same launch, sharing the table and the
// lengths, so the model pays the launch once a layer.
//
// Replaces the TPU kernels `_paged_copy_kernel` / `paged_copy` and
// `_paged_copy_at_kernel` / `paged_copy_at` in
// src/repro/kernels/paged_copy.py.
//
// Bound on the card: bytes, and at the serve path's sizes (1-2 MB a launch)
// latency.  The work is a copy of lens[b] rows of row_bytes each, read once
// and written once; there is no arithmetic.  What sets the time is the
// launch and how many device round trips a block waits for in a row, so:
//   * one launch writes a layer's K and V;
//   * it is a programmatic dependent launch (griddepcontrol.wait first), so
//     it is scheduled while the kernel before it drains;
//   * a block waits for two round trips before its stores: the lengths
//     (`starts` and `lens`, loaded together), then the page-table entry and
//     every src unit of the burst at once.  The src loads are volatile
//     `ld.global`, so the compiler cannot sink them below the
//     unmapped-page exit (nvcc moves plain loads there, behind the entry).
// Two routes, chosen on the host before the launch (`copy_route` in
// paged_copy.py):
//   * burst: rows are adjacent in src and in the frame and every base and
//     stride is 16-byte aligned, as on the serve path in every dtype.  The
//     burst is then one contiguous byte range on both sides; the block moves
//     it in 16-byte units, UNROLL a thread per pass (16 KB a pass: one pass
//     for a page of 16 rows of 1 KB), with no index arithmetic per unit;
//   * rows: any other view (strided rows, misaligned bases or strides).
//     Row by row with the widest unit (16, 4, 2 or 1 bytes) that divides
//     every pointer and stride, a 32-bit divide per unit, the same UNROLL
//     units a thread in flight before their stores.
// Neighbouring threads move neighbouring units, so loads and stores
// coalesce.  The block reads its own page-table entry (the TPU kernel's
// scalar prefetch).  The design was timed on the card against a 1-D bulk
// copy through shared memory, other block shapes and the cold copy loading
// its page before its length (PERF.md, Findings).
//
// Differences from the TPU kernels, by design:
//   * the pool is updated IN PLACE.  The TPU kernels pad a trash frame and
//     return a new pool; here a burst whose logical page is unmapped (entry
//     < 0) or past the table (vpn >= max_pages) is not stored at all, and
//     pool rows that hold no chunk token are not written, which is exactly
//     what the trash frame and the read-modify-write of the edge pages
//     achieved;
//   * the continuation copy does not build the TPU wrapper's shifted copy of
//     src: block (burst, b) owns logical page starts[b] / page + burst (the
//     extra burst covers the page an unaligned window straddles) and maps
//     each of its pool rows u back to chunk token
//     t = burst * page + u - starts[b] % page;
//   * it copies bytes, so one kernel serves f32, bf16 and int8 pools.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;   // a block
constexpr int UNROLL = 4;      // units a thread keeps in flight per pass

// one or two (src, pool) tensors of one shape, dtype and layout
struct Tensors {
    const char* src[2];
    char* pool[2];
};

// One unit, a plain coherent load (src may have been written by the kernel
// this one is a programmatic dependent of).  A volatile asm: the compiler
// may not sink it below the unmapped-page exit, which would make every load
// wait for the page-table entry.
template <typename U>
__device__ __forceinline__ U load_unit(const char* p);

template <>
__device__ __forceinline__ uint4 load_unit<uint4>(const char* p)
{
    uint4 v;
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

template <>
__device__ __forceinline__ uint32_t load_unit<uint32_t>(const char* p)
{
    uint32_t v;
    asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

template <>
__device__ __forceinline__ uint16_t load_unit<uint16_t>(const char* p)
{
    uint16_t v;
    asm volatile("ld.global.u16 %0, [%1];" : "=h"(v) : "l"(p));
    return v;
}

template <>
__device__ __forceinline__ uint8_t load_unit<uint8_t>(const char* p)
{
    uint32_t v;
    asm volatile("ld.global.u8 %0, [%1];" : "=r"(v) : "l"(p));
    return (uint8_t)v;
}

template <typename U, bool BURST>
__global__ void __launch_bounds__(THREADS) paged_copy_kernel(
    Tensors x, const int* __restrict__ table, const int* __restrict__ starts,
    const int* __restrict__ lens, int S, int page_size, int max_pages,
    int units_per_row,
    long long src_sb, long long src_ss,      // bytes
    long long pool_sf, long long pool_st,    // bytes
    long long table_sb)                      // elements
{
    // launched as a programmatic dependent: the launch overlaps the tail
    // of the kernel before it, and nothing is read before that kernel's
    // writes are complete and visible
    griddep_wait();
    const int burst = blockIdx.x;
    const int b = blockIdx.y;
    const char* src = blockIdx.z ? x.src[1] : x.src[0];
    char* pool = blockIdx.z ? x.pool[1] : x.pool[0];
    // round trip 1: the row's start (null: the cold copy) and length
    const int start = starts ? starts[b] : 0;
    const int n_tok = min(lens[b], S);
    const int vpn = start / page_size + burst;
    // pool row u of this page holds chunk token t0 + u
    const int t0 = burst * page_size - start % page_size;
    const int u_lo = max(0, -t0);
    const int u_hi = min(page_size, n_tok - t0);
    if (vpn >= max_pages || u_hi <= u_lo) return;   // nothing to store
    // round trip 2: the frame and the burst's src units, all in flight;
    // only the stores wait for the frame
    const int entry = table[b * table_sb + vpn];
    const char* s = src + b * src_sb + (long long)(t0 + u_lo) * src_ss;
    char* d = pool + (long long)u_lo * pool_st;
    const int total = (u_hi - u_lo) * units_per_row;
    for (int i0 = threadIdx.x; i0 < total; i0 += UNROLL * THREADS) {
        U v[UNROLL];
        long long po[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            const int i = i0 + k * THREADS;
            long long so;
            if (BURST) {
                so = po[k] = (long long)i * (long long)sizeof(U);
            } else {
                const int r = i / units_per_row;
                const int u = i - r * units_per_row;
                so = r * src_ss + (long long)u * (long long)sizeof(U);
                po[k] = r * pool_st + (long long)u * (long long)sizeof(U);
            }
            if (i < total) v[k] = load_unit<U>(s + so);
        }
        if (entry < 0) return;                 // unmapped: nothing is stored
        char* f = d + entry * pool_sf;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
            if (i0 + k * THREADS < total)
                *reinterpret_cast<U*>(f + po[k]) = v[k];
    }
}

template <typename U, bool BURST>
int launch(dim3 grid, cudaStream_t st, const Tensors& x, const void* table,
           const void* starts, const void* lens, int S, int page_size,
           int max_pages, long long row_bytes, long long src_sb,
           long long src_ss, long long pool_sf, long long pool_st,
           long long table_sb)
{
    return launch_dependent(
        paged_copy_kernel<U, BURST>, grid, THREADS, 0, st, x,
        static_cast<const int*>(table),
        static_cast<const int*>(starts), static_cast<const int*>(lens), S,
        page_size, max_pages, (int)(row_bytes / (long long)sizeof(U)),
        src_sb, src_ss, pool_sf, pool_st, table_sb);
}

}  // namespace

// Write src_z[b, :lens[b]] into pool_z (z < n_tensors, 1 or 2; the second
// pair shares the first's shape and strides) at logical positions t, or
// starts[b] + t when starts is not null.  n_bursts = ceil(S / page), one
// more with starts.  burst != 0 takes the burst route; it needs rows
// adjacent on both sides (src_ss == pool_st == row_bytes) and 16-byte
// alignment, and the launch is refused (cudaErrorInvalidValue) without them.
extern "C" int paged_copy_launch(
    const void* src0, const void* src1, void* pool0, void* pool1,
    const void* table, const void* starts, const void* lens,
    int B, int S, int n_bursts, int n_tensors, int page_size, int max_pages,
    long long row_bytes, long long src_sb, long long src_ss,
    long long pool_sf, long long pool_st, long long table_sb, int burst,
    void* stream)
{
    const dim3 grid(n_bursts, B, n_tensors);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Tensors x{{static_cast<const char*>(src0),
                     static_cast<const char*>(n_tensors > 1 ? src1 : src0)},
                    {static_cast<char*>(pool0),
                     static_cast<char*>(n_tensors > 1 ? pool1 : pool0)}};
    const unsigned long long align =
        (unsigned long long)(uintptr_t)x.src[0]
        | (unsigned long long)(uintptr_t)x.src[1]
        | (unsigned long long)(uintptr_t)x.pool[0]
        | (unsigned long long)(uintptr_t)x.pool[1]
        | (unsigned long long)row_bytes | (unsigned long long)src_sb
        | (unsigned long long)src_ss | (unsigned long long)pool_sf
        | (unsigned long long)pool_st;
#define ARGS grid, st, x, table, starts, lens, S, page_size, max_pages, \
    row_bytes, src_sb, src_ss, pool_sf, pool_st, table_sb
    if (burst) {
        if (align % 16 != 0 || src_ss != row_bytes || pool_st != row_bytes)
            return (int)cudaErrorInvalidValue;
        return launch<uint4, true>(ARGS);
    }
    if (align % 16 == 0)
        return launch<uint4, false>(ARGS);
    if (align % 4 == 0)
        return launch<uint32_t, false>(ARGS);
    if (align % 2 == 0)
        return launch<uint16_t, false>(ARGS);
    return launch<uint8_t, false>(ARGS);
#undef ARGS
}
