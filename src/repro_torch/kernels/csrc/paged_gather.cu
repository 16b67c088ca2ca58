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
// no arithmetic.  Every element reads its own position and its own table
// entry: positions are not sorted, deduplicated or translated once per
// page here (that is `ops.paged_gather_coalesced`).  What the time hangs
// on is how many bytes are in flight while each element waits for two
// dependent loads (its position, then its entry) before its row can be
// read.  Two routes, chosen on the host before the launch (`gather_route`
// in paged_gather.py):
//   * bulk: 16-byte aligned bases and strides, a dense output and rows of
//     at most BULK_MAX_ROW bytes (gather_route sends rows of 64 B and
//     more; below that lanes is faster).  A warp takes a batch of E
//     elements, E * row bytes ~ 8 KB (E <= 32): lanes 0..E-1 read the E
//     positions in one coalesced load, then the E table entries together,
//     and each issues its row as one 1-D bulk copy (TMA, no registers)
//     into the warp's stage in shared memory, completing on the stage's
//     mbarrier.  The E output rows are adjacent, so the batch leaves as ONE
//     bulk store.  Each warp keeps a ring of two stages: batch t + 1's
//     translations and row loads are issued before it waits for batch t's
//     rows.  The grid is sized to the SMs (as many 4-warp blocks as fit),
//     each warp striding over the batches;
//   * lanes: every other row (unaligned views, rows under 64 B or over
//     BULK_MAX_ROW).
//     A group of lanes owns one element (a whole warp for rows of 512 B
//     and more, fewer lanes for narrower rows, so a warp serves several
//     elements); the group's first lane translates and broadcasts the
//     row's address with __shfl_sync, and the group copies the row with
//     the widest unit (16, 4, 2 or 1 bytes) that divides the row, the
//     pointers and the strides, neighbouring lanes on neighbouring units.
// Both launch as programmatic dependents of the work before them
// (griddepcontrol.wait first), so their blocks are scheduled while that
// work drains.  The design was timed on the card against the lanes code
// alone (the previous design), batched translation with the rows in
// registers, other stage counts, batch sizes and grids (PERF.md, Findings).
//
// As the JAX oracle (jnp indexing clamps): a position past the table's
// reach reads the table's last entry, a -1 entry reads frame 0.  A
// negative position reads page 0 and an entry >= n_frames the last frame,
// so the kernel never reads outside the table or the pool.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BULK_WARPS = 4;            // warps a block on the bulk route
constexpr int STAGES = 2;                // batches in flight a warp
constexpr int STAGE_BYTES = 8192;        // a batch's rows, at most 32 rows
constexpr int BULK_MAX_ROW = 16384;      // bytes: two stages of 4 warps fit
constexpr int LANES_THREADS = 256;

struct Translation {
    const int* table;
    const int* positions;
    int n, page_size, max_pages, n_frames;
    long long pool_sf, pool_st;          // bytes
};

// Byte offset of element i's pool row: its position, then its own entry.
__device__ __forceinline__ long long row_offset(const Translation& x,
                                                long long i)
{
    const int p = x.positions[i];
    const int vpn = p < 0 ? 0 : min(p / x.page_size, x.max_pages - 1);
    int off = p % x.page_size;
    if (off < 0) off += x.page_size;
    const int frame = min(max(x.table[vpn], 0), x.n_frames - 1);
    return frame * x.pool_sf + off * x.pool_st;
}

template <typename U>
__global__ void __launch_bounds__(LANES_THREADS) gather_lanes_kernel(
    const char* __restrict__ pool, char* __restrict__ out, Translation x,
    int units_per_row,
    int group,                                 // lanes per element, 2^k <= 32
    long long out_s)                           // bytes
{
    griddep_wait();
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long i = warp * (32 / group) + lane / group;
    const int sub = lane & (group - 1);
    long long row = 0;                          // byte offset of the pool row
    if (sub == 0 && i < x.n) row = row_offset(x, i);
    row = __shfl_sync(0xffffffffu, row, 0, group);   // every lane takes part
    if (i >= x.n) return;
    const U* s = reinterpret_cast<const U*>(pool + row);
    U* d = reinterpret_cast<U*>(out + i * out_s);
    for (int u = sub; u < units_per_row; u += group)
        d[u] = s[u];
}

// out is dense [n, row_bytes]; dynamic shared memory holds, for each warp,
// STAGES stages of per_batch rows, then each warp's STAGES mbarriers.
__global__ void __launch_bounds__(BULK_WARPS * 32) gather_bulk_kernel(
    const char* __restrict__ pool, char* __restrict__ out, Translation x,
    int row_bytes, int per_batch)
{
    griddep_wait();
    extern __shared__ __align__(128) unsigned char smem[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int stage_bytes = per_batch * row_bytes;
    unsigned char* ring = smem + (size_t)wib * STAGES * stage_bytes;
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        smem + (size_t)BULK_WARPS * STAGES * stage_bytes) + wib * STAGES;
    if (lane == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
        mbar_fence_init();
    }
    __syncwarp();
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long batches = ((long long)x.n + per_batch - 1) / per_batch;
    // batch t of this warp lives in stage t % STAGES; its mbarrier's phase
    // parity is (t / STAGES) & 1.  The store of batch t - 1 is issued in
    // iteration t, after batch t's loads.
    int t = 0;
    long long prev_first = 0;
    int prev_cnt = 0;
    for (long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
         b < batches; b += warps, ++t) {
        const int s = t % STAGES;
        const long long first = b * per_batch;
        const int cnt = (int)min((long long)per_batch, x.n - first);
        const long long row = lane < cnt ? row_offset(x, first + lane) : 0;
        if (lane == 0) {
            // stage s last held batch t - STAGES, whose store must have
            // read it: at most STAGES - 2 newer stores may still read
            bulk_wait_read<STAGES - 2>();
            mbar_expect_tx(&bars[s], (uint32_t)(cnt * row_bytes));
        }
        __syncwarp();
        if (lane < cnt)
            bulk_load_1d(ring + s * stage_bytes + lane * row_bytes, pool + row,
                         (uint32_t)row_bytes, &bars[s]);
        if (t > 0) {
            const int ps = (t - 1) % STAGES;
            mbar_wait(&bars[ps], ((t - 1) / STAGES) & 1);
            if (lane == 0) {
                bulk_store_1d(out + prev_first * row_bytes,
                              ring + ps * stage_bytes,
                              (uint32_t)(prev_cnt * row_bytes));
                bulk_commit();
            }
        }
        prev_first = first;
        prev_cnt = cnt;
    }
    if (t > 0) {
        const int ps = (t - 1) % STAGES;
        mbar_wait(&bars[ps], ((t - 1) / STAGES) & 1);
        if (lane == 0) {
            bulk_store_1d(out + prev_first * row_bytes, ring + ps * stage_bytes,
                          (uint32_t)(prev_cnt * row_bytes));
            bulk_commit();
        }
    }
    if (lane == 0) bulk_wait_all();      // the block's shared memory is freed
}

template <typename U>
int launch_lanes(const char* pool, char* out, const Translation& x,
                 long long row_bytes, long long out_s, cudaStream_t st)
{
    const int units = (int)(row_bytes / (long long)sizeof(U));
    int group = 1;
    while (group < 32 && group < units) group *= 2;
    const long long per_block = (long long)(LANES_THREADS / 32) * (32 / group);
    const unsigned blocks = (unsigned)(((long long)x.n + per_block - 1) / per_block);
    return launch_dependent(gather_lanes_kernel<U>, blocks, LANES_THREADS, 0,
                            st, pool, out, x, units, group, out_s);
}

int launch_bulk(const char* pool, char* out, const Translation& x,
                int row_bytes, cudaStream_t st)
{
    const int fit = STAGE_BYTES / row_bytes;
    const int per_batch = fit < 1 ? 1 : fit > 32 ? 32 : fit;
    const size_t smem = (size_t)BULK_WARPS * STAGES
                        * ((size_t)per_batch * row_bytes + sizeof(uint64_t));
    cudaError_t e = cudaFuncSetAttribute(
        gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess
        || (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess
        || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, gather_bulk_kernel, BULK_WARPS * 32, smem))
               != cudaSuccess)
        return (int)e;
    const long long batches = ((long long)x.n + per_batch - 1) / per_batch;
    const long long wanted = (batches + BULK_WARPS - 1) / BULK_WARPS;
    const long long cap = (long long)(per_sm > 1 ? per_sm : 1) * sms;
    const unsigned blocks = (unsigned)(wanted < cap ? wanted : cap);
    return launch_dependent(gather_bulk_kernel, blocks, BULK_WARPS * 32, smem,
                            st, pool, out, x, row_bytes, per_batch);
}

}  // namespace

// out [n, row_bytes] (row stride out_s) <- pool rows through one page-table
// row; n > 0, max_pages > 0, n_frames > 0.  route: 0 lanes, 1 bulk (which
// needs a dense out, 16-byte alignment and a row of at most BULK_MAX_ROW
// bytes: cudaErrorInvalidValue otherwise).
extern "C" int paged_gather_launch(
    const void* pool, const void* table, const void* positions, void* out,
    int n, int page_size, int max_pages, int n_frames, long long row_bytes,
    long long pool_sf, long long pool_st, long long out_s, int route,
    void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Translation x{static_cast<const int*>(table),
                        static_cast<const int*>(positions), n, page_size,
                        max_pages, n_frames, pool_sf, pool_st};
    const char* p = static_cast<const char*>(pool);
    char* o = static_cast<char*>(out);
    const unsigned long long align =
        (unsigned long long)(uintptr_t)pool | (unsigned long long)(uintptr_t)out
        | (unsigned long long)row_bytes | (unsigned long long)pool_sf
        | (unsigned long long)pool_st | (unsigned long long)out_s;
    if (route == 1) {
        if (align % 16 != 0 || out_s != row_bytes || row_bytes > BULK_MAX_ROW)
            return (int)cudaErrorInvalidValue;
        return launch_bulk(p, o, x, (int)row_bytes, st);
    }
    if (align % 16 == 0) return launch_lanes<uint4>(p, o, x, row_bytes, out_s, st);
    if (align % 4 == 0) return launch_lanes<uint32_t>(p, o, x, row_bytes, out_s, st);
    if (align % 2 == 0) return launch_lanes<uint16_t>(p, o, x, row_bytes, out_s, st);
    return launch_lanes<uint8_t>(p, o, x, row_bytes, out_s, st);
}
