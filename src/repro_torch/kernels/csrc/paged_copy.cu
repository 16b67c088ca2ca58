// Paged copy: write src[b, :lens[b]] into pool frames through the page table,
// one page-bounded burst per block (the paper's C2-burst, one translation per
// burst).  Two entry points share the device code:
//   * paged_copy_launch     chunk token t lands at logical position t;
//   * paged_copy_at_launch  chunk token t lands at logical position
//                           starts[b] + t, which need not be page-aligned
//                           (continuation prefill).
//
// Replaces the TPU kernels `_paged_copy_kernel` / `paged_copy` and
// `_paged_copy_at_kernel` / `paged_copy_at` in
// src/repro/kernels/paged_copy.py.
//
// Bound on the card: bytes.  The work is a copy of lens[b] rows of
// row_bytes each, read once and written once; there is no arithmetic.  The
// design moves each row with the widest unit (16, 4, 2 or 1 bytes) that
// divides the row, the pointers and every stride, and neighbouring threads
// copy neighbouring units, so loads and stores coalesce.  The block reads
// its own page-table entry (the TPU kernel's scalar prefetch).
//
// Differences from the TPU kernels, by design:
//   * the pool is updated IN PLACE.  The TPU kernels pad a trash frame and
//     return a new pool; here a burst whose logical page is unmapped (entry
//     < 0) or past the table (vpn >= max_pages) is not stored at all, and
//     pool rows that hold no chunk token are not written, which is exactly
//     what the trash frame and the read-modify-write of the edge pages
//     achieved;
//   * `paged_copy_at` does not build the TPU wrapper's shifted copy of src:
//     block (burst, b) owns logical page starts[b] / page + burst (the
//     extra burst covers the page an unaligned window straddles) and maps
//     each of its pool rows u back to chunk token
//     t = burst * page + u - starts[b] % page;
//   * it copies bytes, so one kernel serves f32, bf16 and int8 pools.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename U>
__global__ void paged_copy_kernel(
    const char* __restrict__ src, char* __restrict__ pool,
    const int* __restrict__ table, const int* __restrict__ starts,
    const int* __restrict__ lens, int S, int page_size, int max_pages,
    int units_per_row,
    long long src_sb, long long src_ss,      // bytes
    long long pool_sf, long long pool_st,    // bytes
    long long table_sb)                      // elements
{
    const int burst = blockIdx.x;
    const int b = blockIdx.y;
    const int start = starts ? starts[b] : 0;  // null: paged_copy
    const int vpn = start / page_size + burst;
    if (vpn >= max_pages) return;            // past the table: not stored
    const int entry = table[b * table_sb + vpn];
    if (entry < 0) return;                   // unmapped: nothing is stored
    // pool row u of this page holds chunk token t0 + u
    const int t0 = burst * page_size - start % page_size;
    const int n_tok = min(lens[b], S);
    const int u_lo = max(0, -t0);
    const int u_hi = min(page_size, n_tok - t0);
    if (u_hi <= u_lo) return;                // no chunk token on this page
    const char* s_base = src + b * src_sb + (long long)(t0 + u_lo) * src_ss;
    char* d_base = pool + entry * pool_sf + u_lo * pool_st;
    const long long total = (long long)(u_hi - u_lo) * units_per_row;
    for (long long i = threadIdx.x; i < total; i += blockDim.x) {
        const int t = (int)(i / units_per_row);
        const int u = (int)(i - (long long)t * units_per_row);
        const U* s = reinterpret_cast<const U*>(s_base + t * src_ss) + u;
        U* d = reinterpret_cast<U*>(d_base + t * pool_st) + u;
        *d = *s;
    }
}

template <typename U>
static void launch(dim3 grid, cudaStream_t st, const void* src, void* pool,
                   const void* table, const void* starts, const void* lens,
                   int S, int page_size, int max_pages, long long row_bytes,
                   long long src_sb, long long src_ss, long long pool_sf,
                   long long pool_st, long long table_sb)
{
    paged_copy_kernel<U><<<grid, 256, 0, st>>>(
        static_cast<const char*>(src), static_cast<char*>(pool),
        static_cast<const int*>(table), static_cast<const int*>(starts),
        static_cast<const int*>(lens), S, page_size, max_pages,
        (int)(row_bytes / (long long)sizeof(U)),
        src_sb, src_ss, pool_sf, pool_st, table_sb);
}

static int dispatch(const void* src, void* pool, const void* table,
                    const void* starts, const void* lens, int B, int S,
                    int n_bursts, int page_size, int max_pages,
                    long long row_bytes, long long src_sb, long long src_ss,
                    long long pool_sf, long long pool_st, long long table_sb,
                    void* stream)
{
    const dim3 grid(n_bursts, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned long long align =
        (unsigned long long)(uintptr_t)src | (unsigned long long)(uintptr_t)pool
        | (unsigned long long)row_bytes | (unsigned long long)src_sb
        | (unsigned long long)src_ss | (unsigned long long)pool_sf
        | (unsigned long long)pool_st;
#define ARGS grid, st, src, pool, table, starts, lens, S, page_size, \
    max_pages, row_bytes, src_sb, src_ss, pool_sf, pool_st, table_sb
    if (align % 16 == 0)
        launch<uint4>(ARGS);
    else if (align % 4 == 0)
        launch<uint32_t>(ARGS);
    else if (align % 2 == 0)
        launch<uint16_t>(ARGS);
    else
        launch<uint8_t>(ARGS);
#undef ARGS
    return (int)cudaGetLastError();
}

// Chunk token t of row b at logical position t; n_bursts = ceil(S / page).
extern "C" int paged_copy_launch(
    const void* src, void* pool, const void* table, const void* lens,
    int B, int S, int n_bursts, int page_size, long long row_bytes,
    long long src_sb, long long src_ss, long long pool_sf, long long pool_st,
    long long table_sb, int max_pages, void* stream)
{
    return dispatch(src, pool, table, nullptr, lens, B, S, n_bursts,
                    page_size, max_pages, row_bytes, src_sb, src_ss, pool_sf,
                    pool_st, table_sb, stream);
}

// Chunk token t of row b at logical position starts[b] + t;
// n_bursts = ceil(S / page) + 1.
extern "C" int paged_copy_at_launch(
    const void* src, void* pool, const void* table, const void* starts,
    const void* lens, int B, int S, int n_bursts, int page_size,
    long long row_bytes, long long src_sb, long long src_ss,
    long long pool_sf, long long pool_st, long long table_sb, int max_pages,
    void* stream)
{
    return dispatch(src, pool, table, starts, lens, B, S, n_bursts,
                    page_size, max_pages, row_bytes, src_sb, src_ss, pool_sf,
                    pool_st, table_sb, stream);
}
