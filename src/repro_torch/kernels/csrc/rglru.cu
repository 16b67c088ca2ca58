// The RG-LRU of one recurrent layer of recurrentgemma-9b, in f32
// (src/repro/models/rglru.py:183-189), x = conv [B, T, R] as f32:
//
//   r = sigmoid(x @ w_r), i = sigmoid(x @ w_i)      w_r, w_i [R, R] ([in, out])
//   a = exp(-8 softplus(lam) r)                     lam [R] f32
//   bx = sqrt(max(1 - a^2, 1e-12)) (i x)
//   h_t = a_t h_{t-1} + bx_t,  h_{-1} = h0          h [B, T, R], h0 [B, R] f32
//
// 26 calls a prefill (T = the prompt) and a decode step (T = 1).
//
// Replaces no TPU kernel: the JAX package leaves the gate products and the
// elementwise gate math to XLA and computes the recurrence with
// `jax.lax.associative_scan` (`_rglru_scan`, src/repro/models/rglru.py:53-67).
// The plain version (ref.rglru_ref) is that chain in PyTorch: two upcasts of
// the weights, two f32 products, twelve elementwise launches and a step loop.
//
// The gate math is PyTorch's CUDA arithmetic, operation for operation:
// sigmoid 1 / (1 + expf(-v)), softplus log1pf(expf(v)) under its threshold
// 20, every other product, sum and difference rounded alone (__fmul_rn,
// __fadd_rn, __fsub_rn: nvcc would contract a * b + c into one FMA), sqrtf
// and the division correctly rounded (nvcc's defaults, no fast math).
//
// Two kernels; the wrapper picks one before the launch (kernels/rglru.py
// `rglru_route`):
//
// * step (T = 1, bf16, B <= 16: decode and a one-token prefill).  One launch
//   does the layer's whole decode step.  Bound on the card: bytes, the two
//   bf16 weights (2 R^2 x 2 B: 67.1 MB, 0.020 ms at 3.35 TB/s at R 4096),
//   read once.  Each block owns CH channels of BOTH gates (128 blocks at R
//   4096, one a SM), so its epilogue has r and i of a channel together.  Its
//   256 threads stream the two [R, CH] weight strips with 16-byte
//   no-allocate loads, each thread U = 8 rows ahead in registers (32 KB in
//   flight a block; 4, 6, 10, 12, 16 and 32 rows timed slower), and sum x w
//   in f32 on the CUDA cores: a product of two bf16 values is exact in f32,
//   so each FMA adds the exact product and only the order of the sums
//   differs from the plain version's f32 product (as cuBLAS's order already
//   does).  K is split over the block's 32 k lanes and reduced in a fixed
//   order (lanes by shuffles, then the warps 0..7 in turn through shared
//   memory): two launches agree bit for bit.  The conv rows are staged in
//   shared memory (bf16, rows padded to a power of two up to 16, zero past
//   B) by asynchronous copies, in one round trip.  It is a programmatic
//   dependent launch: the weights and lam do not depend on the work before
//   it, so the first U rows of weights are loaded before griddep_wait();
//   the conv rows and h0 are read after it.  At B 8 the CUDA cores issue
//   ~1.4 instructions an FMA, ~11 us of the 20 us the weights take.  The
//   same products on mma.sync (a per-warp cp.async ring of weight chunks
//   read by ldmatrix.trans) timed a little faster with a read-filled L2 at
//   B 8 and 1 and clearly slower with a written one, so the card picked the
//   CUDA cores.  A TMA ring of the weight strips in shared memory
//   (scripts/rglru_step_ring: 2-D tiles on mbarriers, filled before
//   griddep_wait by thread 0 or by a producer warp) timed slower at B 8
//   and 16 under both L2 fills, and at B 1 faster read-filled but slower
//   written, so the weights stream into registers (PERF.md).
// * scan (T > 1 or f32 weights: prefill and the reduced f32 configs).  The
//   wrapper computes the two products with torch.matmul (f32, TF32 off, as
//   the plain version does, so the pre-activations agree bit for bit); the
//   kernel reads them with conv and lam, forms a and bx, and walks T.
//   Bound: bytes (the two pre-activations, conv and h: 235 MB at [8, 512,
//   4096] with bf16 conv); a and bx never reach device memory.  The gate
//   math costs ~3 expf, 2 divisions and a square root an element in IEEE
//   f32, more work than a thread a channel can issue alone: a first
//   design (one thread a (sequence, channel) walking T with the gate math
//   inline, 8 warps a SM) ran at 23 % of the bound.  So a block takes 32
//   channels of one sequence and T in chunks of 32 steps: its 4 warps form
//   a and bx of a chunk in parallel into shared memory, 8 steps each, then
//   load the next chunk's inputs, while warp 0 walks the chunk before, one
//   lane a channel, one rounded product and sum a step.  1,024 blocks of
//   128 threads at [8, 512, 4096], 8 resident a SM: one wave, 32 warps a
//   SM.  8 and 16 gate warps a block timed slower there and faster at the
//   window run's B 1 (128 blocks); chunks of 16 steps timed alike, of 64
//   slower, and the next chunk's loads into a second set of registers
//   slower (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float sigmoid_pt(float v)
{
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// -8 softplus(lam), as the plain version forms it: (-8 * softplus) * r.
__device__ __forceinline__ float neg_c_softplus(float lam)
{
    return __fmul_rn(-8.0f, lam > 20.0f ? lam : log1pf(expf(lam)));
}

// The decay a and the input bx of one step, from the pre-activations.
__device__ __forceinline__ float a_of(float pre_r, float nsp)
{
    return expf(__fmul_rn(nsp, sigmoid_pt(pre_r)));
}

__device__ __forceinline__ float bx_of(float a, float pre_i, float x)
{
    const float s = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)),
                                     1e-12f));
    return __fmul_rn(s, __fmul_rn(sigmoid_pt(pre_i), x));
}

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t w)
{
    return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w)
{
    return __uint_as_float(w & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// step: the whole decode step of a layer in one launch
// ---------------------------------------------------------------------------

namespace step {

constexpr int CH = 32;                    // channels of each gate a block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;                    // bf16 a 16-byte load
constexpr int GROUPS = 2 * CH / VEC;      // loads across a k row of both gates
constexpr int KL = THREADS / GROUPS;      // k lanes: K is split KL ways

constexpr int U = 8;                      // weight rows a thread loads ahead

// k rows staged a conv row: R rounded up to the k lanes
__host__ __device__ inline int kpad(int R) { return (R + KL - 1) / KL * KL; }

__host__ __device__ inline size_t smem_bytes(int nb, int R)
{
    return (size_t)nb * kpad(R) * 2 + (size_t)WARPS * nb * 2 * CH * 4;
}

// Weight row k of the 8 channels from c: one 16-byte load when the rows are
// 16-byte aligned (VEC_LOADS), else element by element; zero past R.
template <bool VEC_LOADS>
__device__ __forceinline__ uint4 load_w(const __nv_bfloat16* p, int k, int c,
                                        int R)
{
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k >= R || c >= R) return v;
    const __nv_bfloat16* q = p + (long long)k * R;
    if (VEC_LOADS) {
        asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, "
                     "[%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(q));
        return v;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const unsigned short* s = reinterpret_cast<const unsigned short*>(q);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
        if (c + e < R) w[e / 2] |= (uint32_t)__ldg(s + e) << (16 * (e % 2));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid ceil(R / CH), THREADS threads, smem_bytes(NB, R) of dynamic shared
// memory.  conv [B, R] bf16, w_r / w_i [R, R] bf16, lam [R] f32, h0 and h
// [B, R] f32, all contiguous; B <= NB.
template <int NB, bool VEC_LOADS>
__global__ void __launch_bounds__(THREADS, 1) rglru_step_kernel(
    const __nv_bfloat16* __restrict__ conv,
    const __nv_bfloat16* __restrict__ w_r,
    const __nv_bfloat16* __restrict__ w_i, const float* __restrict__ lam,
    const float* __restrict__ h0, float* __restrict__ h, int B, int R)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const int ldx = kpad(R);
    unsigned short* xs = reinterpret_cast<unsigned short*>(smem);   // [NB][ldx]
    float* part = reinterpret_cast<float*>(smem + (size_t)NB * ldx * 2);
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int grp = t % GROUPS, kl = t / GROUPS;
    const int gate = grp / (CH / VEC), v = grp % (CH / VEC);
    const int c0 = blockIdx.x * CH, cv = c0 + v * VEC;
    const __nv_bfloat16* wp = (gate ? w_i : w_r) + cv;

    // the weights do not depend on the work before this launch
    uint4 buf[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
        buf[j] = load_w<VEC_LOADS>(wp, kl + j * KL, cv, R);
    griddep_wait();

    // the conv rows, row-major [NB][ldx], zero past B and R: 16-byte
    // asynchronous copies (one round trip for all of them), or element by
    // element when the rows are not 16-byte aligned
    for (int idx = t; idx < NB * ldx / VEC; idx += THREADS) {
        const int b = idx / (ldx / VEC), k = (idx % (ldx / VEC)) * VEC;
        unsigned short* dst = xs + (size_t)b * ldx + k;
        const unsigned short* s = reinterpret_cast<const unsigned short*>(
            conv) + (long long)b * R + k;
        if (VEC_LOADS && b < B && k < R) {
            cp_async16(dst, s);
            continue;
        }
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (b < B) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                if (k + e < R) w[e / 2] |= (uint32_t)s[e] << (16 * (e % 2));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    // the epilogue's lam and h0, loaded while the sums run
    constexpr int EPI = (NB * CH + THREADS - 1) / THREADS;
    float nsp[EPI], hz[EPI];
#pragma unroll
    for (int e = 0; e < EPI; ++e) {
        const int idx = t + e * THREADS, b = idx / CH, c = c0 + idx % CH;
        const bool in = idx < NB * CH && b < B && c < R;
        nsp[e] = in ? neg_c_softplus(lam[c]) : 0.f;
        hz[e] = in ? h0[(long long)b * R + c] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    float acc[NB][VEC];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[b][e] = 0.f;
    const int n_rows = ldx / KL;                 // rows a thread sums
    for (int j0 = 0; j0 < n_rows; j0 += U) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
            const uint4 cur = buf[j];
            buf[j] = load_w<VEC_LOADS>(wp, kl + (j0 + U + j) * KL, cv, R);
            if (j0 + j < n_rows) {
                const int k = kl + (j0 + j) * KL;
                const float wf[VEC] = {bf16_lo(cur.x), bf16_hi(cur.x),
                                       bf16_lo(cur.y), bf16_hi(cur.y),
                                       bf16_lo(cur.z), bf16_hi(cur.z),
                                       bf16_lo(cur.w), bf16_hi(cur.w)};
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    const float x = __uint_as_float(
                        (uint32_t)xs[(size_t)b * ldx + k] << 16);
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        acc[b][e] = fmaf(x, wf[e], acc[b][e]);
                }
            }
        }
    }

    // split-K in a fixed order: the warp's k lanes of each (gate, vector)
    // by a butterfly (every lane ends with the same sum), then the warps
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            float s = acc[b][e];
#pragma unroll
            for (int d = GROUPS; d < 32; d *= 2)
                s += __shfl_xor_sync(0xffffffffu, s, d);
            acc[b][e] = s;
        }
    if (lane < GROUPS) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                part[(warp * NB + b) * 2 * CH + gate * CH + v * VEC + e] =
                    acc[b][e];
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < EPI; ++e) {
        const int idx = t + e * THREADS, b = idx / CH, cl = idx % CH;
        const int c = c0 + cl;
        if (idx >= NB * CH || b >= B || c >= R) continue;
        float pr = part[b * 2 * CH + cl], pi = part[b * 2 * CH + CH + cl];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) {
            pr += part[(w * NB + b) * 2 * CH + cl];
            pi += part[(w * NB + b) * 2 * CH + CH + cl];
        }
        const float x = __uint_as_float((uint32_t)xs[(size_t)b * ldx + c]
                                        << 16);
        const float a = a_of(pr, nsp[e]);
        h[(long long)b * R + c] = __fadd_rn(__fmul_rn(a, hz[e]),
                                            bx_of(a, pi, x));
    }
}

template <int NB, bool VEC_LOADS>
int launch(const void* conv, const void* w_r, const void* w_i,
           const void* lam, const void* h0, void* h, int B, int R,
           cudaStream_t st)
{
    auto kernel = rglru_step_kernel<NB, VEC_LOADS>;
    const size_t smem = smem_bytes(NB, R);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return launch_dependent(
        kernel, dim3((R + CH - 1) / CH), THREADS, smem, st,
        static_cast<const __nv_bfloat16*>(conv),
        static_cast<const __nv_bfloat16*>(w_r),
        static_cast<const __nv_bfloat16*>(w_i),
        static_cast<const float*>(lam), static_cast<const float*>(h0),
        static_cast<float*>(h), B, R);
}

template <bool VEC_LOADS>
int launch_rows(const void* conv, const void* w_r, const void* w_i,
                const void* lam, const void* h0, void* h, int B, int R,
                cudaStream_t st)
{
    if (B <= 1)
        return launch<1, VEC_LOADS>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 2)
        return launch<2, VEC_LOADS>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 4)
        return launch<4, VEC_LOADS>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 8)
        return launch<8, VEC_LOADS>(conv, w_r, w_i, lam, h0, h, B, R, st);
    return launch<16, VEC_LOADS>(conv, w_r, w_i, lam, h0, h, B, R, st);
}

}  // namespace step

// ---------------------------------------------------------------------------
// scan: the gate math fused into the walk over T
// ---------------------------------------------------------------------------

namespace scan {

constexpr int CHN = 32;        // channels a block: one warp wide
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
constexpr int TC = 32;         // steps a chunk
constexpr int ROWS = TC / WARPS;   // steps of a chunk each thread's gates

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}

// grid (ceil(R / CHN), B).  pre_r, pre_i, h: [B, T, R] f32; conv [B, T, R]
// (bf16 or f32); lam [R] f32; h0 [B, R] f32.  Chunk by chunk of TC steps,
// every warp forms a and bx of ROWS steps of the block's 32 channels into
// shared memory (the gate math has no dependence along T), then warp 0
// walks the chunk one step after another, one lane a channel; the chunks
// alternate between two buffers, so warp 0 walks chunk k - 1 while the
// others form chunk k.
template <typename X>
__global__ void __launch_bounds__(NT, 8) rglru_scan_kernel(
    const float* __restrict__ pre_r, const float* __restrict__ pre_i,
    const X* __restrict__ conv, const float* __restrict__ lam,
    const float* __restrict__ h0, float* __restrict__ h, int T, int R)
{
    __shared__ float sa[2][TC][CHN], sb[2][TC][CHN];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int r = blockIdx.x * CHN + lane;
    const bool in = r < R;
    const long long base = (long long)blockIdx.y * T * R + r;
    const float nsp = in ? neg_c_softplus(lam[r]) : 0.f;
    float hv = warp == 0 && in ? h0[(long long)blockIdx.y * R + r] : 0.f;
    const int chunks = (T + TC - 1) / TC;
    // this thread's inputs of chunk k: rows k TC + warp + WARPS i; the next
    // chunk's are loaded once this one's gates are formed, and arrive while
    // warp 0 walks
    float p[ROWS], q[ROWS], x[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int t = warp + WARPS * i;
        const bool ok = in && t < T;
        const long long o = base + (long long)t * R;
        p[i] = ok ? __ldg(pre_r + o) : 0.f;
        q[i] = ok ? __ldg(pre_i + o) : 0.f;
        x[i] = ok ? to_f32(conv[o]) : 0.f;
    }
    for (int k = 0; k <= chunks; ++k) {
        if (k < chunks) {
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
                const float a = a_of(p[i], nsp);
                sa[k & 1][warp + WARPS * i][lane] = a;
                sb[k & 1][warp + WARPS * i][lane] = bx_of(a, q[i], x[i]);
            }
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
                const int t = (k + 1) * TC + warp + WARPS * i;
                const bool ok = in && t < T;
                const long long o = base + (long long)t * R;
                p[i] = ok ? __ldg(pre_r + o) : 0.f;
                q[i] = ok ? __ldg(pre_i + o) : 0.f;
                x[i] = ok ? to_f32(conv[o]) : 0.f;
            }
        }
        if (warp == 0 && k > 0) {
            const int c = (k - 1) & 1, t0 = (k - 1) * TC;
            const int n = min(TC, T - t0);
            for (int j = 0; j < n; ++j) {
                hv = __fadd_rn(__fmul_rn(sa[c][j][lane], hv), sb[c][j][lane]);
                if (in) h[base + (long long)(t0 + j) * R] = hv;
            }
        }
        __syncthreads();
    }
}

}  // namespace scan

}  // namespace

// The step route.  conv [B, 1, R] bf16, w_r / w_i [R, R] bf16, lam [R] f32,
// h0 [B, R] f32, h [B, 1, R] f32, all contiguous; 1 <= B <= 16; vec_loads:
// R % 8 == 0 and conv, w_r, w_i 16-byte aligned.  Returns a cudaError_t.
extern "C" int rglru_step_launch(const void* conv, const void* w_r,
                                 const void* w_i, const void* lam,
                                 const void* h0, void* h, int B, int R,
                                 int vec_loads, void* stream)
{
    if (B < 1 || B > 16 || R < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return vec_loads
        ? step::launch_rows<true>(conv, w_r, w_i, lam, h0, h, B, R, st)
        : step::launch_rows<false>(conv, w_r, w_i, lam, h0, h, B, R, st);
}

// The scan route.  pre_r, pre_i, h [B, T, R] f32; conv [B, T, R] bf16
// (conv_bf16 = 1) or f32; lam [R] f32; h0 [B, R] f32; all contiguous.
extern "C" int rglru_scan_launch(const void* pre_r, const void* pre_i,
                                 const void* conv, int conv_bf16,
                                 const void* lam, const void* h0, void* h,
                                 int B, int T, int R, void* stream)
{
    if (B < 1 || T < 1 || R < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((R + scan::CHN - 1) / scan::CHN, B);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* pr = static_cast<const float*>(pre_r);
    const float* pi = static_cast<const float*>(pre_i);
    const float* lm = static_cast<const float*>(lam);
    const float* hz = static_cast<const float*>(h0);
    float* out = static_cast<float*>(h);
    if (conv_bf16)
        scan::rglru_scan_kernel<__nv_bfloat16><<<grid, scan::NT, 0, st>>>(
            pr, pi, static_cast<const __nv_bfloat16*>(conv), lm, hz, out, T, R);
    else
        scan::rglru_scan_kernel<float><<<grid, scan::NT, 0, st>>>(
            pr, pi, static_cast<const float*>(conv), lm, hz, out, T, R);
    return (int)cudaGetLastError();
}
