// Non-causal attention forward with online softmax: K4 of the port.
//
// Replaces the Pallas kernel mlagg_unet_tpu/ops/flash_attention.py
// `_flash_kernel` (launched by `_flash_forward`). out = softmax(q k^T * scale)
// v over (batch, heads, len, dim), fp32 accumulators, dk != dv allowed.
//
// What bounds it on the H100: on the flagship's pooled branch lk = 56, so the
// work per query is tiny (56 * (24 + 48) MACs) and the kernel is bound by
// the bytes of q and out (Bm * N * (24 + 48) elements per call).
//
// What the design does about it: one CTA per (b * h, block of 64 queries)
// reads its q block once and walks the keys in blocks of 64 held in shared
// memory (at lk = 56 all keys fit in one block, ~16 KB), so k and v are read
// once per CTA from L2 and q and out cross device memory exactly once.
// Scores, the running max and sum, and the output accumulator stay in fp32
// shared memory; the key tail is masked with -1e30 as in the Pallas kernel.
// q, k and v may be strided views with a unit stride on the last axis, so
// the caller's head split needs no copy.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

struct Strides {
    long long b, h, l;
};

__host__ __device__ inline size_t smem_floats(int dk, int dv) {
    const int dkp = dk + 1;  // odd row stride: key rows hit distinct banks
    return (size_t)BQ * dkp + (size_t)BK * dkp + (size_t)BK * dv +
           (size_t)BQ * (BK + 1) + (size_t)BQ * dv + 3 * BQ;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Lq,
                 int Lk, int dk, int dv, Strides qs, Strides ks, Strides vs,
                 float scale) {
    extern __shared__ float smem[];
    const int dkp = dk + 1;
    float* sQ = smem;
    float* sK = sQ + BQ * dkp;
    float* sV = sK + BK * dkp;
    float* sS = sV + BK * dv;
    float* sAcc = sS + BQ * (BK + 1);
    float* sM = sAcc + BQ * dv;
    float* sL = sM + BQ;
    float* sAlpha = sL + BQ;

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int q0 = blockIdx.x * BQ;
    const T* qp = q + b * qs.b + h * qs.h;
    const T* kp = k + b * ks.b + h * ks.h;
    const T* vp = v + b * vs.b + h * vs.h;

    for (int i = tid; i < BQ * dk; i += THREADS) {
        const int r = i / dk, c = i % dk;
        sQ[r * dkp + c] = q0 + r < Lq ? to_f32(qp[(q0 + r) * qs.l + c]) : 0.f;
    }
    for (int i = tid; i < BQ * dv; i += THREADS) sAcc[i] = 0.f;
    for (int i = tid; i < BQ; i += THREADS) {
        sM[i] = NEG_INF;
        sL[i] = 0.f;
    }

    for (int k0 = 0; k0 < Lk; k0 += BK) {
        __syncthreads();  // previous block's P and V are consumed
        for (int i = tid; i < BK * dk; i += THREADS) {
            const int r = i / dk, c = i % dk;
            sK[r * dkp + c] = k0 + r < Lk ? to_f32(kp[(k0 + r) * ks.l + c]) : 0.f;
        }
        for (int i = tid; i < BK * dv; i += THREADS) {
            const int r = i / dv, c = i % dv;
            sV[i] = k0 + r < Lk ? to_f32(vp[(k0 + r) * vs.l + c]) : 0.f;
        }
        __syncthreads();

        for (int i = tid; i < BQ * BK; i += THREADS) {
            const int r = i / BK, c = i % BK;
            const float* qr = sQ + r * dkp;
            const float* kr = sK + c * dkp;
            float s = 0.f;
            for (int e = 0; e < dk; ++e) s = fmaf(qr[e], kr[e], s);
            sS[r * (BK + 1) + c] = k0 + c < Lk ? s * scale : NEG_INF;
        }
        __syncthreads();

        for (int r = warp; r < BQ; r += WARPS) {
            float* sr = sS + r * (BK + 1);
            const float m_old = sM[r];
            float mx = m_old;
            for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, sr[c]);
            mx = warp_max(mx);
            float sum = 0.f;
            for (int c = lane; c < BK; c += 32) {
                const float p = __expf(sr[c] - mx);
                sr[c] = p;
                sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = __expf(m_old - mx);
                sAlpha[r] = alpha;
                sL[r] = sL[r] * alpha + sum;
                sM[r] = mx;
            }
        }
        __syncthreads();

        for (int i = tid; i < BQ * dv; i += THREADS) {
            const int r = i / dv, c = i % dv;
            const float* pr = sS + r * (BK + 1);
            float acc = sAcc[i] * sAlpha[r];
            for (int j = 0; j < BK; ++j) acc = fmaf(pr[j], sV[j * dv + c], acc);
            sAcc[i] = acc;
        }
    }
    __syncthreads();

    T* op = o + (long long)bh * Lq * dv;
    for (int i = tid; i < BQ * dv; i += THREADS) {
        const int r = i / dv, c = i % dv;
        if (q0 + r < Lq) op[(long long)(q0 + r) * dv + c] = from_f32<T>(sAcc[i] / sL[r]);
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Lq, int Lk, int dk, int dv, Strides qs, Strides ks, Strides vs,
           float scale, cudaStream_t stream) {
    const size_t bytes = smem_floats(dk, dv) * sizeof(float);
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((Lq + BQ - 1) / BQ, B * H);
    flash_fwd_kernel<T><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk, dk, dv, qs,
        ks, vs, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, Lq, dk), k: (B, H, Lk, dk), v: (B, H, Lk, dv), each with unit
// stride on its last axis and the given (b, h, l) strides in elements;
// o: (B, H, Lq, dv) contiguous. dk, dv <= 128.
extern "C" int mlagg_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Lq, int Lk, int dk, int dv, long long q_sb, long long q_sh,
    long long q_sl, long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl, float scale, int dtype,
    void* stream) {
    if (dk < 1 || dk > 128 || dv < 1 || dv > 128 || Lk < 1)
        return (int)cudaErrorInvalidValue;
    if ((long long)B * H > 65535) return (int)cudaErrorInvalidConfiguration;
    const Strides qs{q_sb, q_sh, q_sl}, ks{k_sb, k_sh, k_sl}, vs{v_sb, v_sh, v_sl};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == MLAGG_BF16)
        return launch<__nv_bfloat16>(q, k, v, o, B, H, Lq, Lk, dk, dv, qs, ks,
                                     vs, scale, s);
    return launch<float>(q, k, v, o, B, H, Lq, Lk, dk, dv, qs, ks, vs, scale, s);
}
