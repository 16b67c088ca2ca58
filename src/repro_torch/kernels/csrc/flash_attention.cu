// Causal GQA flash attention for the prefill chunk: online softmax over KV
// tiles, running max / normaliser / accumulator in f32.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (and the 128-padding of its wrapper,
// src/repro/kernels/ops.py `flash_attention`).
//
// Bound on the card: operations.  At the serve path's shapes (hundreds of
// tokens, D = 128) attention does ~S/2 multiply-adds per byte of Q/K/V, far
// above the card's balance point.  Tiles strictly above the causal diagonal
// (anchored at the end: offset = Sk - Sq) are never loaded, query head h
// reads KV head h / G, so K/V are never replicated, and the ragged edge is
// masked in the kernel instead of padded.  Inputs may be strided views
// ([B, S, H, D] memory seen as [B, H, S, D]).  Two kernels; the caller
// picks one before the launch (kernels/flash_attention.py `flash_route`):
//
// * wgmma (bf16, D a multiple of 16 up to 128, 16-byte-aligned bases and
//   strides).  A block owns one query head and 128 query rows, 64 for each
//   of two consumer warpgroups.  TMA tensor maps over the caller's strided
//   4-D views bring Q once and stream K and V tiles of 128 keys through a
//   2-stage mbarrier ring (separate full barriers for K and V, so S = Q K^T
//   starts before V lands); D is read as two 64-wide boxes of 128-byte
//   swizzle, zero-filled past D (so any D up to 128), past Sk and past Sq.  S runs on wgmma with Q and K
//   both K-major from shared memory; the online softmax works on the
//   accumulator registers (row max and sum over the lane quad that shares a
//   row, m, l and the rescale in f32, exp2 of log2e-scaled scores); P is
//   rounded to bf16 in registers, as the TPU kernel casts p to V's dtype,
//   and is wgmma's register A operand for O += P V, with V read MN-major
//   through the transpose bit.  l sums the f32 p.  Only the diagonal and
//   ragged tiles are masked.
//
// * simt (f32, odd D, or views TMA cannot address): f32 FMAs from shared
//   memory, one block per (q-tile of 64 rows, query head, batch row), 4
//   threads per query row, the K/V tile staged in shared memory as f32 and
//   shared by the 64 rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int DMAX = 128;  // largest head_dim taken

// ---------------------------------------------------------------------------
// tensor cores: TMA -> mbarrier ring -> wgmma, softmax in registers
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;        // query rows per block, 64 per consumer warpgroup
constexpr int BN = 128;        // keys per KV tile
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int THREADS = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int ROW = 128;       // bytes of one swizzled row: 64 bf16 of D
constexpr int DP = 128;        // D as loaded: two 64-wide boxes, zero past D

struct L {
    static constexpr int NB = DP / 64;
    static constexpr int Q_BOX = BQ * ROW, KV_BOX = BN * ROW;
    static constexpr int Q_BYTES = NB * Q_BOX, KV_BYTES = NB * KV_BOX;
    static constexpr int SMEM =
        Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 3 * STAGES) * 8 + 1024;
};

__global__ void __launch_bounds__(THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq, int Sk, int D,
    float scale_log2, int causal, long long osb, long long osh, long long oss)
{
    extern __shared__ uint8_t smem_raw[];
    uint8_t* qs = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* ks = qs + L::Q_BYTES;                     // [STAGES][KV_BYTES]
    uint8_t* vs = ks + STAGES * L::KV_BYTES;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * L::KV_BYTES);
    uint64_t* k_full = q_full + 1;
    uint64_t* v_full = k_full + STAGES;
    uint64_t* empty = v_full + STAGES;

    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (Hq / Hkv);
    const int offset = Sk - Sq;                        // diagonal at the end
    const int k_end = causal ? min(Sk, q0 + BQ + offset) : Sk;
    const int n_tiles = k_end > 0 ? (k_end + BN - 1) / BN : 0;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&empty[s], 8);                   // one per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {                                     // producer warpgroup
        regs_dec<40>();
        if (threadIdx.x == 256) {
            mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
            for (int j = 0; j < L::NB; ++j)
                tma_load_4d(qs + j * L::Q_BOX, &tq, q_full, 64 * j, q0, h, b);
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % STAGES;
                mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
                uint8_t* kt = ks + s * L::KV_BYTES;
                uint8_t* vt = vs + s * L::KV_BYTES;
                mbar_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
                for (int j = 0; j < L::NB; ++j)
                    tma_load_4d(kt + j * L::KV_BOX, &tk, &k_full[s], 64 * j,
                                t * BN, kvh, b);
                mbar_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
                for (int j = 0; j < L::NB; ++j)
                    tma_load_4d(vt + j * L::KV_BOX, &tv, &v_full[s], 64 * j,
                                t * BN, kvh, b);
            }
        }
        return;
    }

    regs_inc<232>();                                   // consumer warpgroups
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int wg_row = q0 + wg * 64;                   // first row of this warpgroup
    const int r0 = wg_row + warp * 16 + lane / 4;      // rows r0 and r0 + 8
    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t qa = smem_u32(qs) + wg * 64 * ROW;
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, k0 = t * BN;
        const uint32_t parity = (t / STAGES) & 1;
        // S = Q K^T, both K-major (D contiguous)
        float sacc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
        const uint32_t ka = smem_u32(ks + s * L::KV_BYTES);
        mbar_wait(&k_full[s], parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_m64n128k16_ss<0>(
                sacc,
                wgmma_desc(qa + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16, 1024),
                wgmma_desc(ka + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sacc);

        // online softmax on the fragment: scores in log2 units, masked only
        // on the diagonal and ragged tiles
        const bool masked = k0 + BN > Sk
            || (causal && k0 + BN - 1 > wg_row + offset);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            float x = sacc[i] * scale_log2;
            if (masked) {
                const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
                const int row = r0 + 8 * ((i >> 1) & 1);
                if (col >= Sk || (causal && col > row + offset)) x = -INFINITY;
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
            ref[r] = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
            alpha[r] = exp2f(m[r] - ref[r]);
            m[r] = m_new;
        }
        // P in bf16 as wgmma's A fragments: registers 8kk..8kk+7 of S are
        // the 16-key slice kk, pairs in A's order (row r0, row r0 + 8,
        // then the next 8 keys)
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
        const uint32_t va = smem_u32(vs + s * L::KV_BYTES);
        mbar_wait(&v_full[s], parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            const uint64_t dv = wgmma_desc(va + kk * 16 * ROW, L::KV_BOX, 1024);
            wgmma_m64n128k16_rs<1>(oacc, pa[kk], dv);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(oacc);
        if (lane == 0) mbar_arrive(&empty[s]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];       // l == 0 guard
    }
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
        const int r = (i >> 1) & 1, row = r0 + 8 * r;
        const int col = 8 * (i >> 2) + 2 * (lane & 3);
        if (row < Sq && col < D)                        // D % 16 == 0: pairs
            *reinterpret_cast<__nv_bfloat162*>(ob + row * oss + col) =
                __floats2bfloat162_rn(oacc[i] * inv[r], oacc[i + 1] * inv[r]);
    }
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, float scale, int causal,
           const long long* st, cudaStream_t stream)
{
    // 4-D maps over the caller's views: dims (D, S, H, B), innermost first
    CUtensorMap tq, tk, tv;
    const long long qd[4] = {D, Sq, Hq, B}, kd[4] = {D, Sk, Hkv, B};
    const long long qs[3] = {st[2], st[1], st[0]}, ks[3] = {st[5], st[4], st[3]},
                    vs[3] = {st[8], st[7], st[6]};
    const int qb[4] = {64, BQ, 1, 1}, kb[4] = {64, BN, 1, 1};
    int err = make_bf16_map(&tq, q, 4, qd, qs, qb);
    if (!err) err = make_bf16_map(&tk, k, 4, kd, ks, kb);
    if (!err) err = make_bf16_map(&tv, v, 4, kd, vs, kb);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    flash_wgmma_kernel<<<grid, THREADS, L::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk, D,
        scale * 1.4426950408889634f, causal, st[9], st[10], st[11]);
    return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA cores: f32 FMAs from shared memory
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per KV tile
constexpr int NT = 256;    // threads per block: 4 per query row

template <typename T>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    int Hq, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss)
{
    extern __shared__ float smem[];
    const int ld = D + 1;                    // padded rows: no bank conflicts
    float* Qs = smem;                        // [BQ][D+1]
    float* Ks = Qs + BQ * ld;                // [BK][D+1]
    float* Vs = Ks + BK * ld;                // [BK][D]
    float* Ps = Vs + BK * D;                 // [BQ][BK+1]

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (Hq / Hkv);
    const int tid = threadIdx.x;
    const int r = tid >> 2;                  // query row of this thread
    const int c4 = tid & 3;                  // its quarter of the row
    const int offset = Sk - Sq;              // diagonal anchored at the end

    const T* qb = q + b * qsb + h * qsh;
    const T* kb = k + b * ksb + kvh * ksh;
    const T* vb = v + b * vsb + kvh * vsh;

    for (int i = tid; i < BQ * D; i += NT) {
        const int rr = i / D, d = i - rr * D;
        const int qi = q0 + rr;
        Qs[rr * ld + d] = qi < Sq ? to_f(qb[qi * qss + d]) : 0.f;
    }

    float acc[DMAX / 4];
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) acc[i] = 0.f;
    float m = -INFINITY, l = 0.f;
    const bool row_in = (q0 + r) < Sq;
    const int qpos = q0 + r + offset;        // key index this row may reach

    int k_end = Sk;
    if (causal) k_end = min(Sk, q0 + BQ + offset);
    const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                     // Q staged / last tile consumed
        for (int i = tid; i < BK * D; i += NT) {
            const int kk = i / D, d = i - kk * D;
            const int kj = k0 + kk;
            const bool in = kj < Sk;
            Ks[kk * ld + d] = in ? to_f(kb[kj * kss + d]) : 0.f;
            Vs[kk * D + d] = in ? to_f(vb[kj * vss + d]) : 0.f;
        }
        __syncthreads();

        float s[BK / 4];
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) {
            const int kk = c4 + 4 * j;
            const int kpos = k0 + kk;
            float dot = 0.f;
            for (int d = 0; d < D; ++d) dot += Qs[r * ld + d] * Ks[kk * ld + d];
            const bool ok = row_in && kpos < Sk && (!causal || kpos <= qpos);
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
                for (int kk = 0; kk < BK; ++kk)
                    a += Ps[r * (BK + 1) + kk] * Vs[kk * D + d];
                acc[i] = a;
            }
        }
    }

    if (row_in) {
        const float inv = (l == 0.f) ? 1.f : 1.f / l;   // l == 0 guard
        T* ob = o + b * osb + h * osh + (q0 + r) * oss;
#pragma unroll
        for (int i = 0; i < DMAX / 4; ++i) {
            const int d = c4 + 4 * i;
            if (d < D) store(ob + d, acc[i] * inv);
        }
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale,
           int causal, const long long* st, cudaStream_t stream)
{
    const size_t smem = sizeof(float) *
        (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    flash_attention_kernel<T><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        Hq, Hkv, Sq, Sk, D, scale, causal,
        st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11]);
    return (int)cudaGetLastError();
}

}  // namespace simt

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, token) strides of q, k, v and o in that order.  wgmma
// selects the tensor-core kernel (bf16, D % 16 == 0, Sk > 0, bases and
// strides 16-byte aligned), else the CUDA-core kernel.  Returns a
// cudaError_t, or a negative code when a TMA tensor map could not be
// encoded (hopper.cuh).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    int dtype, const long long* strides, int wgmma, void* stream)
{
    if (D > DMAX || D < 1 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wgmma) {
        if (dtype != 1 || D % 16 || Sk < 1) return (int)cudaErrorInvalidValue;
        return tc::launch(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                          strides, st);
    }
    if (dtype == 0)
        return simt::launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale,
                                   causal, strides, st);
    if (dtype == 1)
        return simt::launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                           scale, causal, strides, st);
    return (int)cudaErrorInvalidValue;
}
