// Paged copy: write src[b, :lens[b]] into pool frames through the page table,
// one page-bounded burst per block (the paper's C2-burst, one translation per
// burst).
//
// Replaces the TPU kernel `_paged_copy_kernel` / `paged_copy` in
// src/repro/kernels/paged_copy.py.
//
// Bound on the card: bytes.  The work is a copy of lens[b] rows of
// row_bytes each, read once and written once; there is no arithmetic.  The
// design moves each row with the widest unit (16, 4, 2 or 1 bytes) that
// divides the row, the pointers and every stride, and neighbouring threads
// copy neighbouring units, so loads and stores coalesce.  The block reads
// its own page-table entry (the TPU kernel's scalar prefetch).
//
// Differences from the TPU kernel, by design:
//   * the pool is updated IN PLACE.  The TPU kernel pads a trash frame and
//     returns a new pool; here a burst whose table entry is negative is not
//     stored at all, and tokens at or past lens[b] are not stored, which is
//     exactly what the trash frame and the read-modify-write achieved;
//   * it copies bytes, so one kernel serves f32, bf16 and int8 pools.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename U>
__global__ void paged_copy_kernel(
    const char* __restrict__ src, char* __restrict__ pool,
    const int* __restrict__ table, const int* __restrict__ lens,
    int S, int page_size, int units_per_row,
    long long src_sb, long long src_ss,      // bytes
    long long pool_sf, long long pool_st,    // bytes
    long long table_sb)                      // elements
{
    const int burst = blockIdx.x;            // logical page
    const int b = blockIdx.y;
    const int entry = table[b * table_sb + burst];
    if (entry < 0) return;                   // unmapped: nothing is stored
    const int first = burst * page_size;
    int n = lens[b] - first;
    if (n > page_size) n = page_size;
    if (first + n > S) n = S - first;
    if (n <= 0) return;                      // burst past the sequence's end
    const char* s_base = src + b * src_sb + first * src_ss;
    char* d_base = pool + entry * pool_sf;
    const long long total = (long long)n * units_per_row;
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
                   const void* table, const void* lens, int S, int page_size,
                   long long row_bytes, long long src_sb, long long src_ss,
                   long long pool_sf, long long pool_st, long long table_sb)
{
    paged_copy_kernel<U><<<grid, 256, 0, st>>>(
        static_cast<const char*>(src), static_cast<char*>(pool),
        static_cast<const int*>(table), static_cast<const int*>(lens),
        S, page_size, (int)(row_bytes / (long long)sizeof(U)),
        src_sb, src_ss, pool_sf, pool_st, table_sb);
}

extern "C" int paged_copy_launch(
    const void* src, void* pool, const void* table, const void* lens,
    int B, int S, int n_bursts, int page_size, long long row_bytes,
    long long src_sb, long long src_ss, long long pool_sf, long long pool_st,
    long long table_sb, void* stream)
{
    const dim3 grid(n_bursts, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned long long align =
        (unsigned long long)(uintptr_t)src | (unsigned long long)(uintptr_t)pool
        | (unsigned long long)row_bytes | (unsigned long long)src_sb
        | (unsigned long long)src_ss | (unsigned long long)pool_sf
        | (unsigned long long)pool_st;
    if (align % 16 == 0)
        launch<uint4>(grid, st, src, pool, table, lens, S, page_size,
                      row_bytes, src_sb, src_ss, pool_sf, pool_st, table_sb);
    else if (align % 4 == 0)
        launch<uint32_t>(grid, st, src, pool, table, lens, S, page_size,
                         row_bytes, src_sb, src_ss, pool_sf, pool_st, table_sb);
    else if (align % 2 == 0)
        launch<uint16_t>(grid, st, src, pool, table, lens, S, page_size,
                         row_bytes, src_sb, src_ss, pool_sf, pool_st, table_sb);
    else
        launch<uint8_t>(grid, st, src, pool, table, lens, S, page_size,
                        row_bytes, src_sb, src_ss, pool_sf, pool_st, table_sb);
    return (int)cudaGetLastError();
}
