// Paged gather: rows of the pool at logical positions in any order, one
// page-table translation per ELEMENT (the paper's C2-indexed cost: AraOS
// translates every element of an indexed access to keep exceptions
// precise).  out[i] = pool[frame(positions[i]), positions[i] % page].
//
// Replaces the TPU kernel `_paged_gather_kernel` / `paged_gather` in
// src/repro/kernels/paged_gather.py, whose grid runs one step per element
// with the translation in its index map.
//
// Bound on the card: bytes.  Each element reads its position, its
// page-table entry and one pool row, and writes one output row; there is
// no arithmetic.  The design keeps the per-element contract: a group of
// lanes owns one element (a whole warp for rows of 512 B and more, fewer
// lanes for narrower rows, so a warp serves several elements); the group's
// first lane reads the position and the table entry and broadcasts the
// row's address with __shfl_sync; the group then copies the row with the
// widest unit (16, 4, 2 or 1 bytes) that divides the row, the pointers and
// the strides, neighbouring lanes on neighbouring units.  Positions are
// not sorted or coalesced here: that is `ops.paged_gather_coalesced`.
//
// As the JAX oracle (jnp indexing clamps): a position past the table's
// reach reads the table's last entry, a -1 entry reads frame 0.  A
// negative position reads page 0 and an entry >= n_frames the last frame,
// so the kernel never reads outside the table or the pool.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename U>
__global__ void paged_gather_kernel(
    const char* __restrict__ pool, const int* __restrict__ table,
    const int* __restrict__ positions, char* __restrict__ out, int n,
    int page_size, int max_pages, int n_frames, int units_per_row,
    int group,                                 // lanes per element, 2^k <= 32
    long long pool_sf, long long pool_st,      // bytes
    long long out_s)                           // bytes
{
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long i = warp * (32 / group) + lane / group;
    const int sub = lane & (group - 1);
    long long row = 0;                          // byte offset of the pool row
    if (sub == 0 && i < n) {
        const int p = positions[i];
        const int vpn = p < 0 ? 0 : min(p / page_size, max_pages - 1);
        int off = p % page_size;
        if (off < 0) off += page_size;
        const int frame = min(max(table[vpn], 0), n_frames - 1);
        row = frame * pool_sf + off * pool_st;
    }
    row = __shfl_sync(0xffffffffu, row, 0, group);   // every lane takes part
    if (i >= n) return;
    const U* s = reinterpret_cast<const U*>(pool + row);
    U* d = reinterpret_cast<U*>(out + i * out_s);
    for (int u = sub; u < units_per_row; u += group)
        d[u] = s[u];
}

template <typename U>
static int launch(const void* pool, const void* table, const void* positions,
                  void* out, int n, int page_size, int max_pages,
                  int n_frames, long long row_bytes, long long pool_sf,
                  long long pool_st, long long out_s, cudaStream_t st)
{
    const int units = (int)(row_bytes / (long long)sizeof(U));
    int group = 1;
    while (group < 32 && group < units) group *= 2;
    const int threads = 256;
    const long long per_block = (long long)(threads / 32) * (32 / group);
    const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
    paged_gather_kernel<U><<<blocks, threads, 0, st>>>(
        static_cast<const char*>(pool), static_cast<const int*>(table),
        static_cast<const int*>(positions), static_cast<char*>(out), n,
        page_size, max_pages, n_frames, units, group, pool_sf, pool_st,
        out_s);
    return (int)cudaGetLastError();
}

// out [n, row_bytes] (row stride out_s) <- pool rows through one page-table
// row; n > 0, max_pages > 0, n_frames > 0.
extern "C" int paged_gather_launch(
    const void* pool, const void* table, const void* positions, void* out,
    int n, int page_size, int max_pages, int n_frames, long long row_bytes,
    long long pool_sf, long long pool_st, long long out_s, void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned long long align =
        (unsigned long long)(uintptr_t)pool | (unsigned long long)(uintptr_t)out
        | (unsigned long long)row_bytes | (unsigned long long)pool_sf
        | (unsigned long long)pool_st | (unsigned long long)out_s;
#define ARGS pool, table, positions, out, n, page_size, max_pages, n_frames, \
    row_bytes, pool_sf, pool_st, out_s, st
    if (align % 16 == 0) return launch<uint4>(ARGS);
    if (align % 4 == 0) return launch<uint32_t>(ARGS);
    if (align % 2 == 0) return launch<uint16_t>(ARGS);
    return launch<uint8_t>(ARGS);
#undef ARGS
}
