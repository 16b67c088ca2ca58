// Causal GQA flash attention for the prefill chunk: online softmax over KV
// tiles, running max / normaliser / accumulator in f32.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (and the 128-padding of its wrapper,
// src/repro/kernels/ops.py `flash_attention`).
//
// Bound on the card: operations.  At the serve path's shapes (hundreds of
// tokens, D = 128) attention does ~S/2 multiply-adds per byte of Q/K/V, far
// above the card's balance point.  This first version is a plain SIMT
// kernel (f32 FMAs from shared memory, no tensor cores): one block per
// (q-tile of 64 rows, query head, batch row), 4 threads per query row, the
// K/V tile staged in shared memory as f32 and shared by the 64 rows.  Tiles
// strictly above the causal diagonal are never loaded.  Query head h reads
// KV head h / G, so K/V are never replicated.  The ragged edge (S not a
// multiple of 64) is masked in the kernel instead of padded.  Tensor-core
// (wgmma) tiles are the next step; PERF.md carries the measured gap.
//
// Inputs may be strided views ([B, S, H, D] memory seen as [B, H, S, D]):
// every tensor is addressed through its (batch, head, token) strides and a
// unit stride along D.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per KV tile
constexpr int NT = 256;    // threads per block: 4 per query row
constexpr int DMAX = 128;  // largest head_dim taken

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, token) strides of q, k, v and o in that order.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    int dtype, const long long* strides, void* stream)
{
    if (D > DMAX || D < 1 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale, causal,
                             strides, st);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, scale,
                                     causal, strides, st);
    return (int)cudaErrorInvalidValue;
}
