// ring.cu with a producer warp: a ninth warp's lane 0 fills the whole
// ring (waiting on each stage's release), so the 8 warps that sum never
// stop to refill; the tensor maps' L2 promotion is TMA_PROMO.  Timed by
// time_ring.py, not used by the port.

namespace tmaw {

constexpr int CH = 32, THREADS = 256, WARPS = 8, VEC = 8;
constexpr int LAUNCH = THREADS + 32;   // + one producer warp
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
__global__ void __launch_bounds__(LAUNCH, 1) step_tmaw_kernel(
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
    }
    __syncthreads();
    if (warp == WARPS) {
        // the weights do not depend on the work before this launch
        if (lane == 0) {
            for (int j = 0; j < tiles; ++j) {
                const int s = j % stages;
                if (j >= stages) mbar_wait(&empty[s], ((j / stages) - 1) & 1);
                mbar_expect_tx(&full[s], STAGE);
                tma_load_2d(ring + s * STAGE, &mr, &full[s], c0, j * KT);
                tma_load_2d(ring + s * STAGE + TILE, &mi, &full[s], c0,
                            j * KT);
            }
        }
        griddep_wait();
        return;
    }
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
    named_bar_sync(1, THREADS);
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
    named_bar_sync(1, THREADS);
    if (sub == 0 && kq == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                part[(warp * NB + b) * 2 * CH + gate * CH + v * VEC + e] =
                    acc[b][e];
    }
    named_bar_sync(1, THREADS);

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

static inline int map2(CUtensorMap* map, const void* ptr,
                       const long long* dims, const long long* strides,
                       const int* box)
{
    EncodeTiledFn fn = encode_tiled_fn();
    if (!fn) return TMA_NO_DRIVER;
    cuuint64_t gdim[2] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1]};
    cuuint64_t gstride[1] = {(cuuint64_t)strides[0] * 2};
    cuuint32_t bdim[2] = {(cuuint32_t)box[0], (cuuint32_t)box[1]};
    cuuint32_t es[2] = {1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          const_cast<void*>(ptr), gdim, gstride, bdim, es,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE, TMA_PROMO,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : TMA_ENCODE_BASE - (int)r;
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
    int err = map2(&mr, w_r, dims, strides, box);
    if (!err) err = map2(&mi, w_i, dims, strides, box);
    if (err) return err;
    auto kernel = step_tmaw_kernel<NB>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    return launch_dependent(
        kernel, dim3((R + CH - 1) / CH), LAUNCH, smem, st, mr, mi,
        static_cast<const __nv_bfloat16*>(conv),
        static_cast<const float*>(lam), static_cast<const float*>(h0),
        static_cast<float*>(h), B, R, stages, (int)ring);
}

}  // namespace tmaw

extern "C" int rglru_step_tmaw_launch(const void* conv, const void* w_r,
                                     const void* w_i, const void* lam,
                                     const void* h0, void* h, int B, int R,
                                     int vec_loads, void* stream)
{
    if (B < 1 || B > 16 || R < 8 || R % 8) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B <= 1) return tmaw::launch<1>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 2) return tmaw::launch<2>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 4) return tmaw::launch<4>(conv, w_r, w_i, lam, h0, h, B, R, st);
    if (B <= 8) return tmaw::launch<8>(conv, w_r, w_i, lam, h0, h, B, R, st);
    return tmaw::launch<16>(conv, w_r, w_i, lam, h0, h, B, R, st);
}
