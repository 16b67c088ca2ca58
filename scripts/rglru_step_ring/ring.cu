// A variant of csrc/rglru.cu's step route, timed against it by
// time_ring.py and not used by the port: the two weight strips stream
// through a TMA ring in shared memory (2-D tiles [KT rows, 32 channels] of
// w_r and w_i a stage, completing on mbarriers; thread 0 fills the first
// stages before griddep_wait and refills a stage once the 8 warps have
// released it), and the conv rows arrive by 1-D bulk loads.  Compiled
// after a copy of csrc/rglru.cu (its helpers in scope), with TMA_KT rows a
// stage and at most TMA_S stages (fewer when shared memory is short).
// R % 8 == 0 and 16-byte-aligned operands only (the tensor map's stride).

namespace tmav {

constexpr int CH = 32, THREADS = 256, WARPS = 8, VEC = 8;
constexpr int KT = TMA_KT;
constexpr int SMAX = TMA_S;
constexpr int TILE = KT * CH * 2;            // bytes of one gate's tile
constexpr int STAGE = 2 * TILE;

__host__ __device__ inline int ldx_of(int R) { return (R + KT - 1) / KT * KT; }

// ring (also the partial sums afterwards), conv rows, barriers
__host__ inline size_t smem_bytes(int nb, int R, int stages)
{
    size_t ring = (size_t)stages * STAGE;
    const size_t part = (size_t)WARPS * nb * 2 * CH * 4;
    if (ring < part) ring = part;
    return ring + (size_t)nb * ldx_of(R) * 2 + 8 * (2 * SMAX + 1);
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1) step_tma_kernel(
    const __grid_constant__ CUtensorMap mr,
    const __grid_constant__ CUtensorMap mi,
    const __nv_bfloat16* __restrict__ conv, const float* __restrict__ lam,
    const float* __restrict__ h0, float* __restrict__ h, int B, int R,
    int stages, int ring_bytes)
{
    extern __shared__ __align__(1024) uint8_t smem[];
    const int ldx = ldx_of(R);
    uint8_t* ring = smem;
    float* part = reinterpret_cast<float*>(smem);
    unsigned short* xs = reinterpret_cast<unsigned short*>(smem + ring_bytes);
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        smem + ring_bytes + (size_t)NB * ldx * 2);
    uint64_t* full = bars;
    uint64_t* empty = bars + SMAX;
    uint64_t* xbar = bars + 2 * SMAX;
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int v = lane % 4, sub = (lane / 4) % 2, gate = (lane / 8) % 2;
    const int kq = lane / 16;
    const int kl = warp * 4 + kq * 2 + sub;      // 0..31
    const int c0 = blockIdx.x * CH;
    const int tiles = (R + KT - 1) / KT;

    if (t == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], WARPS);
        }
        mbar_init(xbar, 1);
        mbar_fence_init();
        // the weights do not depend on the work before this launch
        for (int j = 0; j < stages && j < tiles; ++j) {
            mbar_expect_tx(&full[j], STAGE);
            tma_load_2d(ring + j * STAGE, &mr, &full[j], c0, j * KT);
            tma_load_2d(ring + j * STAGE + TILE, &mi, &full[j], c0, j * KT);
        }
    }
    __syncthreads();
    griddep_wait();
    if (t == 0) {
        mbar_expect_tx(xbar, (uint32_t)B * R * 2);
        for (int b = 0; b < B; ++b)
            bulk_load_1d(xs + (size_t)b * ldx, conv + (long long)b * R,
                         (uint32_t)R * 2, xbar);
    }
    // zero past R and past B
    for (int idx = t; idx < NB * ldx; idx += THREADS) {
        const int b = idx / ldx, k = idx % ldx;
        if (b >= B || k >= R) xs[idx] = 0;
    }
    constexpr int EPI = (NB * CH + THREADS - 1) / THREADS;
    float nsp[EPI], hz[EPI];
#pragma unroll
    for (int e = 0; e < EPI; ++e) {
        const int idx = t + e * THREADS, b = idx / CH, c = c0 + idx % CH;
        const bool in = idx < NB * CH && b < B && c < R;
        nsp[e] = in ? neg_c_softplus(lam[c]) : 0.f;
        hz[e] = in ? h0[(long long)b * R + c] : 0.f;
    }
    __syncthreads();
    mbar_wait(xbar, 0);

    float acc[NB][VEC];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[b][e] = 0.f;
    for (int j = 0; j < tiles; ++j) {
        const int s = j % stages;
        const uint32_t par = (j / stages) & 1;
        mbar_wait(&full[s], par);
        const uint8_t* tile = ring + s * STAGE + gate * TILE;
#pragma unroll
        for (int m = 0; m < KT / 32; ++m) {
            const int row = kl + 32 * m, k = j * KT + row;
            const uint4 cur = *reinterpret_cast<const uint4*>(
                tile + row * (CH * 2) + v * 16);
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
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (t == 0 && j + stages < tiles) {
            mbar_wait(&empty[s], par);
            mbar_expect_tx(&full[s], STAGE);
            tma_load_2d(ring + s * STAGE, &mr, &full[s], c0,
                        (j + stages) * KT);
            tma_load_2d(ring + s * STAGE + TILE, &mi, &full[s], c0,
                        (j + stages) * KT);
        }
    }

    // split-K in a fixed order: lanes of one (gate, v) by a butterfly over
    // sub and kq, then the warps through shared memory (over the ring)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            float s = acc[b][e];
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            acc[b][e] = s;
        }
    __syncthreads();
    if (sub == 0 && kq == 0) {
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

template <int NB>
int launch(const void* conv, const void* w_r, const void* w_i,
           const void* lam, const void* h0, void* h, int B, int R,
           cudaStream_t st)
{
    int stages = SMAX;
    while (stages > 2 && smem_bytes(NB, R, stages) > 232448) --stages;
    const size_t smem = smem_bytes(NB, R, stages);
    size_t ring = (size_t)stages * STAGE;
    const size_t part = (size_t)WARPS * NB * 2 * CH * 4;
    if (ring < part) ring = part;
    CUtensorMap mr, mi;
    const long long dims[2] = {R, R}, strides[1] = {R};
    const int box[2] = {CH, KT};
    int err = make_map(&mr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_r, 2, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!err)
        err = make_map(&mi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_i, 2, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    auto kernel = step_tma_kernel<NB>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return launch_dependent(
        kernel, dim3((R + CH - 1) / CH), THREADS, smem, st, mr, mi,
        static_cast<const __nv_bfloat16*>(conv),
        static_cast<const float*>(lam), static_cast<const float*>(h0),
        static_cast<float*>(h), B, R, stages, (int)ring);
}

}  // namespace tmav

extern "C" int rglru_step_tma_launch(const void* conv, const void* w_r,
                                     const void* w_i, const void* lam,
                                     const void* h0, void* h, int B, int R,
                                     int vec_loads, void* stream)
{
    if (B < 1 || B > 16 || R < 8 || R % 8) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 1) return tmav::launch<1>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 2) return tmav::launch<2>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 4) return tmav::launch<4>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 8) return tmav::launch<8>(conv, w_r, w_i, lam, h0, h, B, R, st);
    return tmav::launch<16>(conv, w_r, w_i, lam, h0, h, B, R, st);
}
