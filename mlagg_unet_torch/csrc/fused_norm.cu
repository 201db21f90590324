// Fused instance norm: K7 (stats) and K8 (apply) of the port.
//
// Replace the Pallas kernels mlagg_unet_tpu/ops/fused_norm.py `_stats_kernel`
// and `_apply_kernel` (fused_instance_norm). x is (N, S, C) contiguous: the
// NHWC activation of any spatial rank with S = prod(spatial).
//   K7: stats[n][0][c] = sum_s x[n][s][c], stats[n][1][c] = sum_s x^2, fp32;
//   K8: y = (x - mean) * rsqrt(var + eps) * scale + bias, var = E[x^2] - E[x]^2
//       (not clamped, as the JAX kernel), plus nothing (mode 0), the raw
//       residual in fp32 (mode 1) or the residual normalised with its own
//       stats, scale and bias (mode 2); then LeakyReLU(0.01) when act; one
//       cast to x's type.
// Scale, bias and the residual's scale and bias come as fp32 (the wrapper
// casts the C-long vectors); x, the residual and the output share one type.
//
// What bounds it on the H100: bytes. At the flagship's UNETR head (N = 16,
// S = 256 * 224, C = 48, bf16) K7 reads 88 MB (26 us at 3.35 TB/s) and K8
// moves 176 MB (mode 0) or 264 MB (mode 2); the arithmetic is a few FLOPs a
// byte.
//
// What the design does about it: every pass loads and stores 16 bytes a
// thread along C (8 bf16 or 4 fp32 channels; a scalar path when C or a
// pointer does not allow it). On the TPU one grid walked S in order and
// carried the sums in VMEM; here K7 splits S into P chunks per sample, one
// CTA each, whose threads hold fp32 sums in registers, reduce them through
// shared memory in a fixed order and write one partial per CTA; a second
// small kernel sums the P partials of each (n, c) in a fixed order. No float
// atomics: two runs give the same bits. K8 is one grid-stride pass that reads
// the (n, c) stats it needs (tiny, L1/L2-resident) beside each vector.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int V>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* f) {
    if constexpr (V == 1) {
        f[0] = to_f32(p[0]);
    } else if constexpr (std::is_same<T, float>::value) {
        static_assert(V == 4, "fp32 vectors are 4 wide");
        const float4 v = *reinterpret_cast<const float4*>(p);
        f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else {
        static_assert(V == 8, "bf16 vectors are 8 wide");
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 t = __bfloat1622float2(h[i]);
            f[2 * i] = t.x;
            f[2 * i + 1] = t.y;
        }
    }
}

template <typename T, int V>
__device__ __forceinline__ void store_f(T* __restrict__ p, const float* f) {
    if constexpr (V == 1) {
        p[0] = from_f32<T>(f[0]);
    } else if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
        uint4 v;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        *reinterpret_cast<uint4*>(p) = v;
    }
}

// K7, first pass. Grid (P, N); block CG * R threads, CG = C / V channel
// groups and R rows in flight. CTA (p, n) sums rows [p * chunk, (p+1) * chunk)
// of sample n into part[n][p][2][C].
template <typename T, int V>
__global__ void __launch_bounds__(1024)
stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                     long long S, int C, long long chunk) {
    extern __shared__ float red[];   // [2][R][C]
    const int CG = C / V;
    const int R = blockDim.x / CG;
    const int cg = threadIdx.x % CG, r = threadIdx.x / CG;
    const int p = blockIdx.x, n = blockIdx.y, P = gridDim.x;
    const long long s0 = (long long)p * chunk;
    const long long s1 = min(S, s0 + chunk);
    float sum[V], sq[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sum[i] = sq[i] = 0.f;
    {
        const T* xn = x + (long long)n * S * C + cg * V;
        for (long long s = s0 + r; s < s1; s += R) {
            float f[V];
            load_f<T, V>(xn + s * C, f);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                sum[i] += f[i];
                sq[i] = fmaf(f[i], f[i], sq[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
            red[r * C + cg * V + i] = sum[i];
            red[(R + r) * C + cg * V + i] = sq[i];
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float a = 0.f, b = 0.f;
        for (int rr = 0; rr < R; ++rr) {  // fixed order: deterministic
            a += red[rr * C + c];
            b += red[(R + rr) * C + c];
        }
        float* out = part + ((long long)n * P + p) * 2 * C;
        out[c] = a;
        out[C + c] = b;
    }
}

// K7, second pass: stats[n][k][c] = sum_p part[n][p][k][c], p in order.
__global__ void stats_finalize_kernel(const float* __restrict__ part,
                                      float* __restrict__ stats, int P, int C) {
    const int n = blockIdx.x;
    for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
        float a = 0.f;
        for (int p = 0; p < P; ++p) a += part[((long long)n * P + p) * 2 * C + i];
        stats[(long long)n * 2 * C + i] = a;
    }
}

__device__ __forceinline__ float norm1(float v, const float* __restrict__ st,
                                       float inv_s, int C, int c, float g,
                                       float b, float eps) {
    const float mean = st[c] * inv_s;
    const float var = st[C + c] * inv_s - mean * mean;
    return (v - mean) * rsqrtf(var + eps) * g + b;
}

// K8: one pass over (N, S, C) in V-wide vectors (grid-stride). The mode
// and the activation are uniform over the grid: their branches cost no
// divergence, and one instantiation per type and width keeps the build short.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const T* __restrict__ x, const float* __restrict__ st,
             const float* __restrict__ sc, const float* __restrict__ bi,
             const T* __restrict__ res, const float* __restrict__ rst,
             const float* __restrict__ rsc, const float* __restrict__ rbi,
             T* __restrict__ out, long long n_vec, long long S, int C,
             float eps, int mode, bool act) {
    const float inv_s = 1.f / (float)S;
    const long long per_sample = S * C;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_vec;
         i += (long long)gridDim.x * blockDim.x) {
        const long long e = i * V;
        const int n = (int)(e / per_sample);
        const int c0 = (int)(e % C);
        float y[V];
        load_f<T, V>(x + e, y);
        const float* stn = st + (long long)n * 2 * C;
#pragma unroll
        for (int j = 0; j < V; ++j)
            y[j] = norm1(y[j], stn, inv_s, C, c0 + j, sc[c0 + j], bi[c0 + j], eps);
        if (mode != 0) {
            float r[V];
            load_f<T, V>(res + e, r);
            const float* rstn = rst + (long long)n * 2 * C;
#pragma unroll
            for (int j = 0; j < V; ++j)
                y[j] += mode == 2 ? norm1(r[j], rstn, inv_s, C, c0 + j, rsc[c0 + j], rbi[c0 + j], eps)
                                  : r[j];
        }
        if (act) {
#pragma unroll
            for (int j = 0; j < V; ++j) y[j] = y[j] >= 0.f ? y[j] : 0.01f * y[j];
        }
        store_f<T, V>(out + e, y);
    }
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int V>
int stats_launch(const void* x, void* part, void* stats, int N, long long S,
                 int C, int P, cudaStream_t st) {
    const int CG = C / V;
    if (CG > 1024) return (int)cudaErrorInvalidValue;
    const int R = CG >= THREADS ? 1 : THREADS / CG;
    const size_t smem = 2 * (size_t)R * C * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const long long chunk = (S + P - 1) / P;
    stats_partial_kernel<T, V><<<dim3(P, N), CG * R, smem, st>>>(
        (const T*)x, (float*)part, S, C, chunk);
    cudaError_t e = cudaGetLastError();
    if (e) return (int)e;
    stats_finalize_kernel<<<N, THREADS, 0, st>>>((const float*)part, (float*)stats, P, C);
    return (int)cudaGetLastError();
}

template <typename T, int V>
int apply_launch(int mode, int act, const void* x, const void* stt, const void* sc,
                 const void* bi, const void* r, const void* rst, const void* rsc,
                 const void* rbi, void* out, long long n_el, long long S, int C,
                 float eps, cudaStream_t st) {
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    const long long n_vec = n_el / V;
    const long long blocks = std::min((n_vec + THREADS - 1) / THREADS, 1LL << 20);
    apply_kernel<T, V><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)x, (const float*)stt, (const float*)sc, (const float*)bi,
        (const T*)r, (const float*)rst, (const float*)rsc, (const float*)rbi,
        (T*)out, n_vec, S, C, eps, mode, act != 0);
    return (int)cudaGetLastError();
}

template <typename T>
constexpr int VEC = 16 / sizeof(T);

}  // namespace

// K7. x: (N, S, C) contiguous; part: (N, P, 2, C) fp32 scratch; stats:
// (N, 2, C) fp32 out.
extern "C" int mlagg_in_stats(const void* x, void* part, void* stats, int N,
                              long long S, int C, int P, int dtype,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = aligned16(x);
    if (dtype == MLAGG_BF16) {
        using T = __nv_bfloat16;
        return (vec && C % VEC<T> == 0) ? stats_launch<T, VEC<T>>(x, part, stats, N, S, C, P, st)
                                        : stats_launch<T, 1>(x, part, stats, N, S, C, P, st);
    }
    return (vec && C % VEC<float> == 0) ? stats_launch<float, VEC<float>>(x, part, stats, N, S, C, P, st)
                                        : stats_launch<float, 1>(x, part, stats, N, S, C, P, st);
}

// K8. x, r (mode 1, 2), out: (N, S, C) contiguous, one type; stats, rstats:
// (N, 2, C) fp32; scale, bias, rscale, rbias: (C,) fp32. mode 0, 1 or 2.
extern "C" int mlagg_in_apply(const void* x, const void* stats, const void* scale,
                              const void* bias, const void* r, const void* rstats,
                              const void* rscale, const void* rbias, void* out,
                              int N, long long S, int C, float eps, int mode,
                              int act, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long n_el = (long long)N * S * C;
    const bool vec = aligned16(x) && aligned16(r) && aligned16(out);
    if (dtype == MLAGG_BF16) {
        using T = __nv_bfloat16;
        return (vec && C % VEC<T> == 0)
                   ? apply_launch<T, VEC<T>>(mode, act, x, stats, scale, bias, r, rstats, rscale, rbias, out, n_el, S, C, eps, st)
                   : apply_launch<T, 1>(mode, act, x, stats, scale, bias, r, rstats, rscale, rbias, out, n_el, S, C, eps, st);
    }
    return (vec && C % VEC<float> == 0)
               ? apply_launch<float, VEC<float>>(mode, act, x, stats, scale, bias, r, rstats, rscale, rbias, out, n_el, S, C, eps, st)
               : apply_launch<float, 1>(mode, act, x, stats, scale, bias, r, rstats, rscale, rbias, out, n_el, S, C, eps, st);
}
