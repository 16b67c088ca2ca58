// Blocked matrix product out = x @ y with f32 products and an f32
// accumulator, the paper's central benchmark kernel (section 3.1).
// x [M, K] and y [K, N] are both f32 or both bf16 (widened to f32 on
// load, which is exact); out [M, N] is f32 or bf16 (rounded once, to
// nearest even, at the store).  Any M, N, K: boundary tiles are guarded
// inside the kernel, with no padded copies.
//
// Replaces the TPU kernel `_matmul_kernel` / `matmul` in
// src/repro/kernels/matmul.py, whose (bm, bn, bk) VMEM blocks feed the
// 128x128 MXU with an f32 accumulator carried across the K grid axis.
//
// Bound on the card: operations at the shapes that matter (2 M N K FMAs'
// worth against bytes that grow as M N + N K + M K).  This kernel is the
// simple SIMT form: a 128x128 output tile per block of 256 threads, each
// thread holding an 8x8 register tile of f32 sums; K is staged 16 at a
// time through shared memory (x transposed, rows padded by 4 floats), and
// each step reads 8 + 8 shared words for 64 FMAs.  Thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j, so a half-warp reads 16
// consecutive words of the y tile and one broadcast word of the x tile.
// It runs on the CUDA cores (no TF32: parity with an f32 dot needs true
// f32); tensor cores (wgmma with TMA) are the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8, THREADS = 256;

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS) matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ y, O* __restrict__ out,
    int M, int N, int K, long long ldx, long long ldy, long long ldo)
{
    __shared__ float xs[BK][BM + 4];
    __shared__ float ys[BK][BN];
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int e = tid; e < BM * BK; e += THREADS) {
            const int r = e / BK, c = e % BK;
            const int gr = m0 + r, gc = k0 + c;
            xs[c][r] = (gr < M && gc < K) ? to_f(x[gr * ldx + gc]) : 0.f;
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
            const int r = e / BN, c = e % BN;
            const int gr = k0 + r, gc = n0 + c;
            ys[r][c] = (gr < K && gc < N) ? to_f(y[gr * ldy + gc]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = m0 + ty + 16 * i;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = n0 + tx + 16 * j;
            if (c < N) store(&out[r * ldo + c], acc[i][j]);
        }
    }
}

template <typename T, typename O>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           long long ldx, long long ldy, long long ldo, cudaStream_t st)
{
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    matmul_kernel<T, O><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<O*>(out), M, N, K, ldx, ldy, ldo);
    return (int)cudaGetLastError();
}

}  // namespace

// Row strides ld* in elements; M, N > 0, K >= 0, ceil(M / 128) <= 65535.
// in_bf16 / out_bf16 select bf16 (else f32) operands / output.
extern "C" int matmul_launch(const void* x, const void* y, void* out, int M,
                             int N, int K, long long ldx, long long ldy,
                             long long ldo, int in_bf16, int out_bf16,
                             void* stream)
{
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_bf16)
        return out_bf16
            ? launch<__nv_bfloat16, __nv_bfloat16>(x, y, out, M, N, K, ldx, ldy, ldo, st)
            : launch<__nv_bfloat16, float>(x, y, out, M, N, K, ldx, ldy, ldo, st);
    return out_bf16
        ? launch<float, __nv_bfloat16>(x, y, out, M, N, K, ldx, ldy, ldo, st)
        : launch<float, float>(x, y, out, M, N, K, ldx, ldy, ldo, st);
}
