// Fused local aggregated attention: K6 of the port.
//
// Replaces the Pallas kernel mlagg_unet_tpu/ops/mlla_attn_fused.py
// `_local_attn_kernel` (local_aggregated_attention_fused): the local half of
// the flagship's AggregatedAttention, for a (B, H, W, ch) map with nh
// differential heads of head_dim HD (ch = 2 nh HD). Per token, in fp32:
//   q = (x Wq^T + bq) HD^-0.5;  k, v = x Wkv^T + bkv rounded to x's type
//   logits over the 3x3 window per q-group (-1e30 at taps outside the image)
//   w = softmax(branch 0) - lambda softmax(branch 1);  o = sum_taps w v
//   o = o rsqrt(mean(o^2) + 1e-5) * subln * (1 - lambda_init)   (per v-head)
//   out = o + bias + sum_taps lepe_w v                            (LePE)
// Weights in torch's layouts: wq (ch, ch), wkv (2 ch, ch), lepe_w (ch, 1, 3, 3).
//
// What bounds it on the H100: the three projections, 3 ch^2 MACs a token
// (~25 GFLOP per flagship forward at model batch 16), against one read of x
// and one write of the output (~170 MB): bytes at the bf16 tensor-core rate,
// operations at the fp32 FMA rate this first version runs at.
//
// What the design does about it: on the TPU the kernel swept the image in
// order and kept k and v of the whole image in VMEM scratch. Here blocks run
// in no order, so a CTA owns its data: `rows` image rows of one image and one
// head (all of a head's math, up to its RMSNorm, reads only that head's 2 HD
// q, k and v channels). It projects q for its rows and k, v for its rows plus
// one halo row above and below into shared memory (q fp32, k and v in x's
// type, as the JAX scratch), streaming the head's 6 HD weight rows through
// shared memory in 32-wide K-slices, 64 tokens per pass (each warp 8 tokens,
// each lane 5 columns 32 apart: activations are broadcasts, weight reads are
// conflict-free). Then one thread per token runs the 9-tap two-branch softmax,
// the combine, the RMSNorm and the LePE in registers. Rows of q, k and v are
// padded to an odd number of 32-bit words, so neighbouring tokens fall in
// different banks. `rows` is picked by the wrapper from the device's
// shared-memory opt-in limit (mlagg_local_attn_smem_bytes) and a minimum grid
// size. fp32 FMA projections; bf16 mma tiles are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 8;                 // tokens per warp in a projection pass
constexpr int TG = WARPS * TM;        // tokens per projection pass
constexpr int BK = 32;                // K slice
constexpr int WLD = BK + 1;           // padded slice row
constexpr float NEG_INF = -1e30f;
// the flagship's head_dim at every stage (96 * 2^s channels, 2 * 2^s heads,
// halved for the local branch); one instantiation per type keeps the build short
constexpr int HEAD_DIM = 24;

template <int HD>
struct Geo {
    static constexpr int HW2 = 2 * HD;              // channels of one head
    static constexpr int NCOL = 3 * HW2;            // q, k, v columns of one head
    static constexpr int NJ = (NCOL + 31) / 32;     // columns per lane
    static constexpr int LDQ = HW2 + 1;             // fp32 words: odd
};

template <typename T>
__host__ __device__ constexpr int ldk(int hw2) { return hw2 + 4 / (int)sizeof(T); }  // odd words

template <typename T, int HD>
size_t smem_bytes_t(int W, int rows) {
    using G = Geo<HD>;
    const size_t floats = (size_t)G::NJ * 32 * WLD + (size_t)TG * WLD + G::NCOL
                          + (size_t)G::HW2 * 11 + (size_t)rows * W * G::LDQ;
    return floats * sizeof(float) + 2 * (size_t)(rows + 2) * W * ldk<T>(G::HW2) * sizeof(T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
local_attn_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                  const T* __restrict__ bq, const T* __restrict__ wkv,
                  const T* __restrict__ bkv, const T* __restrict__ sub,
                  const T* __restrict__ lw, const T* __restrict__ lb,
                  const float* __restrict__ lam_p, T* __restrict__ out,
                  int H, int W, int nh, int rows, long long ld, float lam_init) {
    using G = Geo<HD>;
    constexpr int HW2 = G::HW2, NCOL = G::NCOL, NJ = G::NJ, LDQ = G::LDQ;
    constexpr int LDK = ldk<T>(HW2);
    const int ch = nh * HW2;
    const int h = blockIdx.y, b = blockIdx.z;
    const int r0 = blockIdx.x * rows;
    const int nrow = min(rows, H - r0);      // this CTA's image rows
    const int ntok = (nrow + 2) * W;         // with one halo row each side
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

    extern __shared__ float smem[];
    float* sW = smem;                        // NJ * 32 x WLD
    float* sX = sW + NJ * 32 * WLD;          // TG x WLD
    float* sBias = sX + TG * WLD;            // NCOL
    float* sLW = sBias + NCOL;               // HW2 x 9
    float* sLB = sLW + HW2 * 9;              // HW2
    float* sSub = sLB + HW2;                 // HW2
    float* sQ = sSub + HW2;                  // rows * W x LDQ
    T* sK = reinterpret_cast<T*>(sQ + rows * W * LDQ);   // (rows + 2) * W x LDK
    T* sV = sK + (rows + 2) * W * LDK;

    // column o of this head: q rows of wq, then k and v rows of wkv
    auto wrow = [&](int o) -> const T* {
        if (o < HW2) return wq + (size_t)(h * HW2 + o) * ch;
        if (o < 2 * HW2) return wkv + (size_t)(h * HW2 + o - HW2) * ch;
        return wkv + (size_t)(ch + h * HW2 + o - 2 * HW2) * ch;
    };
    for (int o = tid; o < NCOL; o += THREADS)
        sBias[o] = o < HW2 ? to_f32(bq[h * HW2 + o])
                 : o < 2 * HW2 ? to_f32(bkv[h * HW2 + o - HW2])
                               : to_f32(bkv[ch + h * HW2 + o - 2 * HW2]);
    for (int i = tid; i < HW2 * 9; i += THREADS) sLW[i] = to_f32(lw[(size_t)h * HW2 * 9 + i]);
    for (int i = tid; i < HW2; i += THREADS) {
        sLB[i] = to_f32(lb[h * HW2 + i]);
        sSub[i] = to_f32(sub[i]);
    }

    // ---- phase A: q for the CTA's rows, k and v for them and the halo rows
    const T* xb = x + (long long)b * H * W * ld;
    const float scale = 1.f / sqrtf((float)HD);
    for (int t0 = 0; t0 < ntok; t0 += TG) {
        float acc[TM][NJ];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
        for (int k0 = 0; k0 < ch; k0 += BK) {
            for (int i = tid; i < NJ * 32 * BK; i += THREADS) {
                const int o = i / BK, kk = i % BK, kx = k0 + kk;
                sW[o * WLD + kk] = (o < NCOL && kx < ch) ? to_f32(wrow(o)[kx]) : 0.f;
            }
            for (int i = tid; i < TG * BK; i += THREADS) {
                const int tt = i / BK, kk = i % BK, kx = k0 + kk;
                const int t = t0 + tt, row = r0 - 1 + t / W, col = t % W;
                const bool ok = t < ntok && row >= 0 && row < H && kx < ch;
                sX[tt * WLD + kk] = ok ? to_f32(xb[((long long)row * W + col) * ld + kx]) : 0.f;
            }
            __syncthreads();
            const int kn = min(BK, ch - k0);
            const float* a0 = sX + warp * TM * WLD;
            for (int kk = 0; kk < kn; ++kk) {
                float wv[NJ];
#pragma unroll
                for (int j = 0; j < NJ; ++j) wv[j] = sW[(lane + 32 * j) * WLD + kk];
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float a = a0[i * WLD + kk];
#pragma unroll
                    for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int t = t0 + warp * TM + i;
            if (t >= ntok) continue;
            const int trow = t / W, col = t % W, row = r0 - 1 + trow;
            const bool in_img = row >= 0 && row < H;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int o = lane + 32 * j;
                if (o >= NCOL) continue;
                const float v = acc[i][j] + sBias[o];
                if (o < HW2) {
                    if (trow >= 1 && trow <= nrow)
                        sQ[((trow - 1) * W + col) * LDQ + o] = v * scale;
                } else if (o < 2 * HW2) {
                    sK[t * LDK + o - HW2] = from_f32<T>(in_img ? v : 0.f);
                } else {
                    sV[t * LDK + o - 2 * HW2] = from_f32<T>(in_img ? v : 0.f);
                }
            }
        }
    }
    __syncthreads();

    // ---- phase B: one thread per token of the CTA's rows
    const float lam = *lam_p;
    const float post = 1.f - lam_init;
    for (int p = tid; p < nrow * W; p += THREADS) {
        const int pr = p / W, col = p % W, row = r0 + pr;
        const float* q = sQ + p * LDQ;
        float s0[9], s1[9];
        float m0 = NEG_INF, m1 = NEG_INF;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3 - 1, dx = tap % 3 - 1;
            const int rr = row + dy, cc = col + dx;
            float a = NEG_INF, c1 = NEG_INF;
            if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
                const T* kt = sK + ((pr + 1 + dy) * W + cc) * LDK;
                a = 0.f;
                c1 = 0.f;
#pragma unroll
                for (int c = 0; c < HD; ++c) {
                    a = fmaf(q[c], to_f32(kt[c]), a);
                    c1 = fmaf(q[HD + c], to_f32(kt[HD + c]), c1);
                }
            }
            s0[tap] = a;
            s1[tap] = c1;
            m0 = fmaxf(m0, a);
            m1 = fmaxf(m1, c1);
        }
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            s0[tap] = expf(s0[tap] - m0);
            s1[tap] = expf(s1[tap] - m1);
            d0 += s0[tap];
            d1 += s1[tap];
        }
        const float i0 = 1.f / d0, i1 = lam / d1;
        float o[HW2], l[HW2];
#pragma unroll
        for (int c = 0; c < HW2; ++c) {
            o[c] = 0.f;
            l[c] = sLB[c];
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3 - 1, dx = tap % 3 - 1;
            const int rr = row + dy, cc = col + dx;
            if (rr < 0 || rr >= H || cc < 0 || cc >= W) continue;  // v is 0 there
            const float w = s0[tap] * i0 - s1[tap] * i1;
            const T* vt = sV + ((pr + 1 + dy) * W + cc) * LDK;
#pragma unroll
            for (int c = 0; c < HW2; ++c) {
                const float v = to_f32(vt[c]);
                o[c] = fmaf(w, v, o[c]);
                l[c] = fmaf(sLW[c * 9 + tap], v, l[c]);
            }
        }
        float ss = 0.f;
#pragma unroll
        for (int c = 0; c < HW2; ++c) ss = fmaf(o[c], o[c], ss);
        const float rn = rsqrtf(ss / HW2 + 1e-5f);
        T* dst = out + (((long long)b * H + row) * W + col) * ch + h * HW2;
#pragma unroll
        for (int c = 0; c < HW2; ++c)
            dst[c] = from_f32<T>(o[c] * rn * sSub[c] * post + l[c]);
    }
}

template <typename T, int HD>
int launch(const void* x, const void* wq, const void* bq, const void* wkv,
           const void* bkv, const void* sub, const void* lw, const void* lb,
           const void* lam, void* out, int B, int H, int W, int nh, int rows,
           long long ld, float lam_init, cudaStream_t st) {
    auto kern = local_attn_kernel<T, HD>;
    const size_t bytes = smem_bytes_t<T, HD>(W, rows);
    if (bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e) return (int)e;
    }
    const dim3 grid((unsigned)((H + rows - 1) / rows), (unsigned)nh, (unsigned)B);
    kern<<<grid, THREADS, bytes, st>>>(
        (const T*)x, (const T*)wq, (const T*)bq, (const T*)wkv, (const T*)bkv,
        (const T*)sub, (const T*)lw, (const T*)lb, (const float*)lam, (T*)out,
        H, W, nh, rows, ld, lam_init);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* x, const void* wq, const void* bq,
              const void* wkv, const void* bkv, const void* sub, const void* lw,
              const void* lb, const void* lam, void* out, int B, int H, int W,
              int nh, int rows, long long ld, float lam_init, cudaStream_t st) {
    if (hd != HEAD_DIM) return (int)cudaErrorInvalidValue;
    return launch<T, HEAD_DIM>(x, wq, bq, wkv, bkv, sub, lw, lb, lam, out, B, H, W, nh,
                               rows, ld, lam_init, st);
}

template <typename T>
size_t smem_hd(int W, int hd, int rows) {
    return hd == HEAD_DIM ? smem_bytes_t<T, HEAD_DIM>(W, rows) : 0;
}

}  // namespace

// Dynamic shared memory of one CTA holding `rows` image rows of width W.
extern "C" int mlagg_local_attn_smem_bytes(int W, int hd, int rows, int dtype) {
    return (int)(dtype == MLAGG_BF16 ? smem_hd<__nv_bfloat16>(W, hd, rows)
                                     : smem_hd<float>(W, hd, rows));
}

// x: (B, H, W, >= ch) with tokens ld elements apart and unit channel stride;
// wq (ch, ch), bq (ch), wkv (2 ch, ch), bkv (2 ch), sub (2 hd),
// lw (ch, 1, 3, 3), lb (ch), all x's type and contiguous; lam: one fp32
// value on the device; out: (B, H, W, ch) contiguous.
extern "C" int mlagg_local_attn(const void* x, const void* wq, const void* bq,
                                const void* wkv, const void* bkv, const void* sub,
                                const void* lw, const void* lb, const void* lam,
                                void* out, int B, int H, int W, int nh, int hd,
                                int rows, long long ld, float lam_init, int dtype,
                                void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (rows < 1 || B < 1 || H < 1 || W < 1 || nh < 1) return (int)cudaErrorInvalidValue;
    if (dtype == MLAGG_BF16)
        return launch_hd<__nv_bfloat16>(hd, x, wq, bq, wkv, bkv, sub, lw, lb, lam, out,
                                         B, H, W, nh, rows, ld, lam_init, st);
    return launch_hd<float>(hd, x, wq, bq, wkv, bkv, sub, lw, lb, lam, out, B, H, W,
                            nh, rows, ld, lam_init, st);
}
