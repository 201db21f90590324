// Fused MLLA block front and tail: K2 and K3 of the port.
//
// Replace the Pallas kernels mlagg_unet_tpu/ops/mlla_fused.py `_front_kernel`
// (mlla_block_front_fused) and `_tail_kernel` (mlla_block_tail_fused).
// Token-pointwise, fp32 arithmetic whatever the I/O type:
//   front: y = LN(x); a = silu(y Wa^T + ba); h = y Wi^T + bi
//   tail:  x2 = s + (h * a) Wo^T + bo; out = x2 + gelu(LN(x2) W1^T + b1) W2^T + b2
// LN is the flax LayerNorm (fast variance E[x^2] - E[x]^2, eps passed in),
// GELU the exact erf form. Weights are in torch's (out, in) layout.
//
// What bounds it on the H100: per token the tail does 2 * 5 C^2 FLOPs against
// 8 C bytes of bf16 I/O (the front 2 * 2 C^2 against 6 C bytes), i.e. 60-480
// FLOP/byte at C = 96..768. In fp32 FMA (67 TFLOP/s, 20 FLOP/byte at
// 3.35 TB/s) both kernels are bound by arithmetic; with bf16 tensor cores
// they would be bound by bytes.
//
// What the design does about it: one CTA of 256 threads per tile of T tokens
// keeps every intermediate (LN output, x2, the MLP hidden z) in fp32 shared
// memory, so device memory sees the inputs once and the outputs once, as in
// the Pallas kernel. T is picked from C so that the tail's x2, LN output and z
// (4 C floats per token) fit ~100 KB (T = 64 at C = 96, 8 at C = 768). The
// products stream K-slices of the weight through shared memory and run as
// fp32 FMA, each warp owning T/8 tokens and each lane two output columns
// 32 apart, so that activations are warp broadcasts and weight reads are
// conflict-free. Ragged token counts are masked, not padded. bf16 mma.sync
// tiles are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BO = 64;        // output columns per pass: 2 per lane
constexpr int BKS = 32;       // K slice of the weight staged per step
constexpr int WLD = BKS + 1;  // padded weight row: conflict-free lanes
constexpr int SMEM_BUDGET = 112 * 1024;

__device__ __forceinline__ float silu_f(float a) { return a / (1.f + __expf(-a)); }

__device__ __forceinline__ float gelu_f(float z) {
    return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// out[t][o] = sum_k sA[t * lda + k] * W[o * K + k] for t < 8 * TM, o < Nout,
// handed to epi(t, o, value). sA lives in shared memory; W is global.
template <typename T, int TM, typename Epi>
__device__ __forceinline__ void gemm_tile(const float* sA, int lda,
                                          const T* __restrict__ W, int K,
                                          int Nout, float* sW, Epi epi) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int o0 = 0; o0 < Nout; o0 += BO) {
        float acc[TM][2];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = 0.f;
        for (int k0 = 0; k0 < K; k0 += BKS) {
            for (int i = threadIdx.x; i < BO * BKS; i += THREADS) {
                const int oo = i / BKS, kk = i % BKS;
                const int o = o0 + oo, kx = k0 + kk;
                sW[oo * WLD + kk] = (o < Nout && kx < K) ? to_f32(W[(size_t)o * K + kx]) : 0.f;
            }
            __syncthreads();
            const int kn = min(BKS, K - k0);
            const float* w0 = sW + lane * WLD;
            const float* w1 = sW + (lane + 32) * WLD;
            const float* a0 = sA + (warp * TM) * lda + k0;
            for (int kk = 0; kk < kn; ++kk) {
                const float wa = w0[kk], wb = w1[kk];
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float a = a0[i * lda + kk];
                    acc[i][0] = fmaf(a, wa, acc[i][0]);
                    acc[i][1] = fmaf(a, wb, acc[i][1]);
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int t = warp * TM + i;
            if (o0 + lane < Nout) epi(t, o0 + lane, acc[i][0]);
            if (o0 + lane + 32 < Nout) epi(t, o0 + lane + 32, acc[i][1]);
        }
    }
}

// flax LayerNorm of rows [0, rows) of a (rows, C) fp32 buffer into dst (may
// alias src: each lane reads its columns before writing them), a warp per row.
template <typename T>
__device__ __forceinline__ void layer_norm_rows(const float* src, float* dst,
                                                int rows, int C, const T* g,
                                                const T* b, float eps) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int r = warp; r < rows; r += WARPS) {
        const float* x = src + (size_t)r * C;
        float s = 0.f, ss = 0.f;
        for (int c = lane; c < C; c += 32) {
            const float v = x[c];
            s += v;
            ss = fmaf(v, v, ss);
        }
        s = warp_sum(s);
        ss = warp_sum(ss);
        const float mu = s / C;
        const float var = fmaxf(ss / C - mu * mu, 0.f);  // flax clips at 0
        const float rs = rsqrtf(var + eps);
        float* yr = dst + (size_t)r * C;
        for (int c = lane; c < C; c += 32)
            yr[c] = (x[c] - mu) * rs * to_f32(g[c]) + to_f32(b[c]);
    }
}

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
front_kernel(const T* __restrict__ x, const T* __restrict__ lw,
             const T* __restrict__ lb, const T* __restrict__ wa,
             const T* __restrict__ ba, const T* __restrict__ wi,
             const T* __restrict__ bi, T* __restrict__ a_out,
             T* __restrict__ h_out, long long M, int C, float eps) {
    constexpr int TT = WARPS * TM;
    extern __shared__ float smem[];
    float* sY = smem;             // TT x C
    float* sW = sY + TT * C;      // BO x WLD
    const long long m0 = (long long)blockIdx.x * TT;
    const int rows = (int)min((long long)TT, M - m0);

    for (int i = threadIdx.x; i < TT * C; i += THREADS) {
        const int t = i / C;
        sY[i] = t < rows ? to_f32(x[m0 * C + i]) : 0.f;
    }
    __syncthreads();
    layer_norm_rows(sY, sY, TT, C, lw, lb, eps);
    __syncthreads();

    gemm_tile<T, TM>(sY, C, wa, C, C, sW, [&](int t, int o, float v) {
        if (t < rows) a_out[(m0 + t) * C + o] = from_f32<T>(silu_f(v + to_f32(ba[o])));
    });
    gemm_tile<T, TM>(sY, C, wi, C, C, sW, [&](int t, int o, float v) {
        if (t < rows) h_out[(m0 + t) * C + o] = from_f32<T>(v + to_f32(bi[o]));
    });
}

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const T* __restrict__ h, const T* __restrict__ a,
            const T* __restrict__ s, const T* __restrict__ wo,
            const T* __restrict__ bo, const T* __restrict__ lw,
            const T* __restrict__ lb, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, T* __restrict__ out, long long M, int C,
            int Hd, float eps) {
    constexpr int TT = WARPS * TM;
    extern __shared__ float smem[];
    float* sX2 = smem;            // TT x C: shortcut, then x2
    float* sY = sX2 + TT * C;     // TT x C: LN(x2)
    float* sZ = sY + TT * C;      // TT x Hd: first h * a (TT x C), then the MLP hidden
    float* sW = sZ + TT * Hd;     // BO x WLD
    const long long m0 = (long long)blockIdx.x * TT;
    const int rows = (int)min((long long)TT, M - m0);

    for (int i = threadIdx.x; i < TT * C; i += THREADS) {
        const int t = i / C;
        const bool ok = t < rows;
        const long long gi = m0 * C + i;
        sZ[i] = ok ? to_f32(h[gi]) * to_f32(a[gi]) : 0.f;
        sX2[i] = ok ? to_f32(s[gi]) : 0.f;
    }
    __syncthreads();

    gemm_tile<T, TM>(sZ, C, wo, C, C, sW, [&](int t, int o, float v) {
        sX2[t * C + o] += v + to_f32(bo[o]);
    });
    __syncthreads();
    layer_norm_rows(sX2, sY, TT, C, lw, lb, eps);
    __syncthreads();
    gemm_tile<T, TM>(sY, C, w1, C, Hd, sW, [&](int t, int o, float v) {
        sZ[t * Hd + o] = gelu_f(v + to_f32(b1[o]));
    });
    __syncthreads();
    gemm_tile<T, TM>(sZ, Hd, w2, Hd, C, sW, [&](int t, int o, float v) {
        if (t < rows) out[(m0 + t) * C + o] = from_f32<T>(sX2[t * C + o] + v + to_f32(b2[o]));
    });
}

// Tokens per warp: the largest of 16, 8, 4, 2, 1 whose buffers fit the
// budget; 0 when even one token per warp does not fit.
int pick_tm(int floats_per_token) {
    for (int tm = 16; tm >= 1; tm /= 2) {
        const size_t bytes = ((size_t)WARPS * tm * floats_per_token + BO * WLD) * sizeof(float);
        if (bytes <= SMEM_BUDGET) return tm;
    }
    return 0;
}

template <typename Kern>
int launch_cfg(Kern kern, long long M, int tm, int floats_per_token,
               cudaStream_t stream, dim3& grid, size_t& bytes) {
    const int tt = WARPS * tm;
    bytes = ((size_t)tt * floats_per_token + BO * WLD) * sizeof(float);
    grid = dim3((unsigned)((M + tt - 1) / tt));
    if (bytes > 48 * 1024)
        return (int)cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return 0;
}

template <typename T, int TM>
int front_launch(const void* x, const void* lw, const void* lb, const void* wa,
                 const void* ba, const void* wi, const void* bi, void* a_out,
                 void* h_out, long long M, int C, float eps, cudaStream_t st) {
    dim3 grid;
    size_t bytes;
    auto kern = front_kernel<T, TM>;
    const int e = launch_cfg(kern, M, TM, C, st, grid, bytes);
    if (e) return e;
    kern<<<grid, THREADS, bytes, st>>>(
        (const T*)x, (const T*)lw, (const T*)lb, (const T*)wa, (const T*)ba,
        (const T*)wi, (const T*)bi, (T*)a_out, (T*)h_out, M, C, eps);
    return (int)cudaGetLastError();
}

template <typename T, int TM>
int tail_launch(const void* h, const void* a, const void* s, const void* wo,
                const void* bo, const void* lw, const void* lb, const void* w1,
                const void* b1, const void* w2, const void* b2, void* out,
                long long M, int C, int Hd, float eps, cudaStream_t st) {
    dim3 grid;
    size_t bytes;
    auto kern = tail_kernel<T, TM>;
    const int e = launch_cfg(kern, M, TM, 2 * C + Hd, st, grid, bytes);
    if (e) return e;
    kern<<<grid, THREADS, bytes, st>>>(
        (const T*)h, (const T*)a, (const T*)s, (const T*)wo, (const T*)bo,
        (const T*)lw, (const T*)lb, (const T*)w1, (const T*)b1, (const T*)w2,
        (const T*)b2, (T*)out, M, C, Hd, eps);
    return (int)cudaGetLastError();
}

#define MLAGG_DISPATCH_TM(tm, CALL) \
    switch (tm) {                   \
        case 16: return CALL(16);   \
        case 8: return CALL(8);     \
        case 4: return CALL(4);     \
        case 2: return CALL(2);     \
        case 1: return CALL(1);     \
        default: return (int)cudaErrorInvalidValue; \
    }

}  // namespace

// x: (M, C); ln weight/bias (C,); wa, wi: (C, C) as (out, in); ba, bi: (C,);
// a_out, h_out: (M, C). All contiguous, all of one dtype.
extern "C" int mlagg_mlla_front(const void* x, const void* lw, const void* lb,
                                const void* wa, const void* ba, const void* wi,
                                const void* bi, void* a_out, void* h_out,
                                long long M, int C, float eps, int dtype,
                                void* stream) {
    const int tm = pick_tm(C);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == MLAGG_BF16) {
#define CALL(TM) front_launch<__nv_bfloat16, TM>(x, lw, lb, wa, ba, wi, bi, a_out, h_out, M, C, eps, st)
        MLAGG_DISPATCH_TM(tm, CALL)
#undef CALL
    }
#define CALL(TM) front_launch<float, TM>(x, lw, lb, wa, ba, wi, bi, a_out, h_out, M, C, eps, st)
    MLAGG_DISPATCH_TM(tm, CALL)
#undef CALL
}

// h, a, s, out: (M, C); wo: (C, C); w1: (Hd, C); w2: (C, Hd), all (out, in);
// biases and ln weight/bias 1-D. All contiguous, all of one dtype.
extern "C" int mlagg_mlla_tail(const void* h, const void* a, const void* s,
                               const void* wo, const void* bo, const void* lw,
                               const void* lb, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               long long M, int C, int Hd, float eps,
                               int dtype, void* stream) {
    const int tm = pick_tm(2 * C + Hd);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == MLAGG_BF16) {
#define CALL(TM) tail_launch<__nv_bfloat16, TM>(h, a, s, wo, bo, lw, lb, w1, b1, w2, b2, out, M, C, Hd, eps, st)
        MLAGG_DISPATCH_TM(tm, CALL)
#undef CALL
    }
#define CALL(TM) tail_launch<float, TM>(h, a, s, wo, bo, lw, lb, w1, b1, w2, b2, out, M, C, Hd, eps, st)
    MLAGG_DISPATCH_TM(tm, CALL)
#undef CALL
}
