// RG-LRU linear recurrence: h_t = a_t * h_{t-1} + bx_t over T steps, for
// every (sequence, channel), h_{-1} = h0.  The recurrence of
// recurrentgemma-9b's 26 recurrent layers, once per prefill and per decode
// step.
//
// Replaces no TPU kernel: the JAX package computes it with
// `jax.lax.associative_scan` (`_rglru_scan`, src/repro/models/rglru.py:53-67),
// which XLA lowers itself.  The port's plain version, a Python loop of two
// tensor operations per step, would launch 2 T kernels per layer (about
// 27,000 for a 512-token prefill of 26 layers), so the step loop runs here.
//
// Bound on the card: bytes.  a and bx are read once and h written once, all
// f32, with two operations per element (a 512-token prefill of 8 sequences
// at R 4096 moves 201 MB).  One thread owns one (sequence, channel) and
// walks T in order; neighbouring threads take neighbouring channels, so
// every step's loads and store are coalesced over R.  The loads do not
// depend on h: each thread keeps the next DEPTH steps' a and bx in
// registers, loaded while the current DEPTH steps compute, so ~2 x DEPTH
// loads a thread are in flight against the serial chain of the steps.
// Each step is one rounded product and one rounded sum (no fused
// multiply-add), the plain version's two operations, so the two agree bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads a block: 128 channels of one sequence
constexpr int DEPTH = 8;       // steps of a and bx loaded ahead

// grid (ceil(R / NT), B).  a, bx, h: [B, T, R] f32, h0: [B, R] f32.
__global__ void __launch_bounds__(NT) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ bx,
    const float* __restrict__ h0, float* __restrict__ h, int T, int R)
{
    const int r = blockIdx.x * NT + threadIdx.x;
    if (r >= R) return;
    const long long base = (long long)blockIdx.y * T * R + r;
    const float* ap = a + base;
    const float* bp = bx + base;
    float* hp = h + base;
    float hv = h0[(long long)blockIdx.y * R + r];

    float an[DEPTH], bn[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
        an[j] = j < T ? __ldg(ap + (long long)j * R) : 0.f;
        bn[j] = j < T ? __ldg(bp + (long long)j * R) : 0.f;
    }
    for (int t0 = 0; t0 < T; t0 += DEPTH) {
        float ac[DEPTH], bc[DEPTH];
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            ac[j] = an[j];
            bc[j] = bn[j];
            const int t = t0 + DEPTH + j;          // the next group's loads
            an[j] = t < T ? __ldg(ap + (long long)t * R) : 0.f;
            bn[j] = t < T ? __ldg(bp + (long long)t * R) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < DEPTH; ++j) {
            if (t0 + j < T) {
                hv = __fadd_rn(__fmul_rn(ac[j], hv), bc[j]);
                hp[(long long)(t0 + j) * R] = hv;
            }
        }
    }
}

}  // namespace

// a, bx, h: [B, T, R] f32 contiguous; h0: [B, R] f32 contiguous.
extern "C" int rglru_scan_launch(const void* a, const void* bx, const void* h0,
                                 void* h, int B, int T, int R, void* stream)
{
    if (B < 1 || T < 1 || R < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    rglru_scan_kernel<<<dim3((R + NT - 1) / NT, B), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(bx),
        static_cast<const float*>(h0), static_cast<float*>(h), T, R);
    return (int)cudaGetLastError();
}
