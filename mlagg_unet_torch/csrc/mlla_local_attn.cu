// Fused local aggregated attention: K6 of the port.
//
// Replaces the Pallas kernel mlagg_unet_tpu/ops/mlla_attn_fused.py
// `_local_attn_kernel` (local_aggregated_attention_fused): the local half of
// the flagship's AggregatedAttention, for a (B, H, W, ch) map with nh
// differential heads of head_dim HD = 24 (ch = 2 nh HD). Per token, in fp32:
//   q = (x Wq^T + bq) HD^-0.5;  k, v = x Wkv^T + bkv rounded to x's type
//   logits over the 3x3 window per q-group (-1e30 at taps outside the image)
//   w = softmax(branch 0) - lambda softmax(branch 1);  o = sum_taps w v
//   o = o rsqrt(mean(o^2) + 1e-5) * subln * (1 - lambda_init)   (per v-head)
//   out = o + bias + sum_taps lepe_w v                            (LePE)
// Weights in torch's layouts: wq (ch, ch), wkv (2 ch, ch), lepe_w (ch, 1, 3, 3).
// Two kernels: bf16 I/O launches local_attn_mma_kernel, fp32 I/O the scalar
// local_attn_kernel. The launch (kernel, tile, shared memory, grid) is planned
// by mlagg_unet_torch/ops/mlla_attn_fused.py::local_launch_plan and checked by
// mlagg_local_attn below.
//
// What bounds it on the H100: the three projections, 3 ch^2 MACs a token
// (~25 GFLOP per flagship forward at model batch 16), against one read of x
// and one write of the output (~170 MB): at the bf16 tensor-core rate the
// bytes bound it (~0.05 ms per forward), at the fp32 FMA rate the operations
// (>= 0.4 ms). Between the two sit the latencies of each phase: loading a
// head's weights, the window's 9 taps per token, the RMSNorm.
//
// local_attn_mma_kernel (bf16). What the design does about it:
// - Tensor cores: q, k and v come from mma.sync m16n8k16 with bf16 operands
//   and fp32 accumulators. A bf16 x bf16 product is exact in fp32, so only
//   the order of the sums differs from the Pallas kernel; k and v are
//   rounded to bf16 once (as its scratch is), q stays fp32. The kernel
//   rounds nowhere else: local_attention_fused_plain is its twin.
// - Operands by 16-byte loads, no x staging: inside each 32-wide K chunk the
//   k order is permuted (the same for A and B, so the product is unchanged)
//   so that a thread's A fragment of a token row is one 16-byte __ldg from
//   global memory (a quad reads 64 contiguous bytes of the row) and its B
//   fragment one 16-byte shared load. x needs no shared memory and no
//   barrier; the next chunk's A is loaded while this one multiplies.
// - Weight reuse: a CTA owns one head of one image's tile of up to 16 x 28
//   tokens (the whole 16 x 14 map at the last stage), with the head's 144
//   weight rows (q, k, v) resident in shared memory (16-byte cp.async, rows
//   whose 16-byte units alternate halves so that the B loads are
//   conflict-free): 110 KB at ch = 384 serve 224 tokens, where the scalar
//   kernel streamed them for 98. Of the tiles timed on the card (8-32 rows,
//   14-56 columns, 8 or 16 warps), 16 x 28 was the fastest at every stage.
// - Halo: k and v are projected for the tile plus one ring of neighbours,
//   clipped to the map (1.21x the tile's tokens at the first two stages,
//   1.13x at the third, none at the last), into shared memory in bf16. q is
//   not stored: each warp projects 16 tokens' q into registers and consumes
//   it in place.
// - The window in quads: the accumulator fragment gives each quad (4 lanes)
//   one token's 48 q channels, 12 a lane, so the 24-wide dot products of the
//   9 taps, the two softmaxes, the combine, LePE and the RMSNorm run on 4
//   lanes per token with quad shuffles. k, v and the LePE weights are kept
//   in the lanes' channel order (lane_order_channel), so a lane reads its 12
//   channels of a tap with three 8-byte loads of k or v (rows of 48 bf16:
//   conflict-free for 4 neighbouring tokens) and three 16-byte loads of
//   weights. exp is __expf (ex2.approx).
// - Stores: the output is staged per warp in shared memory and written with
//   16-byte stores, 6 per token row of the head.
// - Occupancy: one CTA of 16 warps per SM (at most 128 registers a thread),
//   153-185 KB of shared memory at the four stages.
// - Ragged tiles are masked (no padding). No atomics: two runs give the same
//   bits. lambda is read from a device scalar: the call makes no host sync.
//
// local_attn_kernel (fp32), the first design: a CTA owns `rows` image rows
// of one image and one head, projects q for its rows and k, v for them plus
// one halo row above and below into shared memory with fp32 FMA over 32-wide
// K-slices (64 tokens per pass), then one thread per token runs the window.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 8;                 // tokens per warp in a projection pass
constexpr int TG = WARPS * TM;        // tokens per projection pass
constexpr int BK = 32;                // K slice
constexpr int WLD = BK + 1;           // padded slice row
constexpr float NEG_INF = -1e30f;
// the flagship's head_dim at every stage (96 * 2^s channels, 2 * 2^s heads,
// halved for the local branch): the only one built
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


// ------------------------------------------------------------------ bf16 tensor-core kernel

using bf16 = __nv_bfloat16;

constexpr int HW2 = 2 * HEAD_DIM;        // channels of one head (one v-head, two q-groups)
constexpr int NCOL = 3 * HW2;            // a head's weight rows: q, k, v
constexpr int KV_LD = HW2;               // bf16 per row of sK, sV: 24 words, so the 8-byte
                                         // loads of 4 consecutive rows by 4 lanes each hit
                                         // distinct banks
constexpr int OUT_LD = HW2 + 8;          // bf16 per row of the output stage: 28 words
constexpr int MMA_WARPS = 16;            // one CTA per SM, at most 128 registers a thread

// A head's channels are held in "lane order" wherever the window reads them
// (sK, sV, the LePE weights and bias, subln): position 12 t4 + 2 n + e holds
// channel 8 n + 2 t4 + e, the channel that lane t4 of a quad holds in column
// e of the accumulator's n8 tile n. A lane's 12 channels are then contiguous
// (three 8-byte loads of k or v, three 16-byte loads of weights), positions 0-5
// of a lane are q-group 0 (channels 0-23) and 6-11 q-group 1.
__host__ __device__ inline int lane_order_channel(int p) {
    const int t4 = p / 12, r = p % 12;
    return 8 * (r / 2) + 2 * t4 + r % 2;
}

__device__ __forceinline__ void unpack_bf16x4(uint2 u, float* f) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

// Weight row length in the resident block: ch rounded up to the 32-wide K
// chunk (zero-filled past ch).
__host__ __device__ inline int mma_wld(int ch) { return (ch + 31) / 32 * 32; }

// sW (NCOL x wld bf16) | output stage (per warp 16 x OUT_LD bf16) | q, k, v
// biases, LePE weights (9 x HW2), LePE bias, subln (fp32) | sK, sV (halo x
// KV_LD bf16 each), where the largest tile has `halo` k/v tokens. Each
// region starts 16-byte aligned. (mirrored by local_launch_plan)
__host__ __device__ inline size_t local_mma_smem_bytes(int ch, int halo) {
    return (size_t)NCOL * mma_wld(ch) * 2 + (size_t)MMA_WARPS * 16 * OUT_LD * 2 +
           (size_t)(NCOL + HW2 * 11) * 4 + (size_t)2 * halo * KV_LD * 2;
}

// acc[n] = x rows (g, g + 8) . W rows (wrow0 + 8 n + g) over all ch, n < NT:
// one warp's m16 x 8 NT product on mma.sync m16n8k16 (ch a multiple of 16).
// Inside each 32-wide K chunk thread (g, t4) holds elements 8 t4 .. 8 t4 + 7
// of its rows, and step s of the chunk takes 8 t4 + 4 s .. + 3 of them as
// its k = 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9: a permutation of k, the same
// for A and B, so A and B are one 16-byte load each (a last 16-wide step
// takes 4 t4 .. 4 t4 + 3, 8-byte loads). xa, xb: the rows in global memory
// (nullptr: a row of zeros). sW's rows are wunits 16-byte units long; in an
// odd row the unit index is XORed with swz (4 where wunits is a multiple of
// 8), so the B loads of rows g and g + 1 fall in different banks.
template <int NT>
__device__ __forceinline__ void project(float (&acc)[NT][4], const bf16* xa, const bf16* xb,
                                        const bf16* sW, int wrow0, int ch, int wunits, int swz) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const auto load = [&](const bf16* row, int kk) {
        return row ? __ldg(reinterpret_cast<const uint4*>(row) + 4 * kk + t4) : make_uint4(0, 0, 0, 0);
    };
    const uint4* wrow = reinterpret_cast<const uint4*>(sW) + (size_t)(wrow0 + g) * wunits;
    const int sw = (g & 1) ? swz : 0;
    const int nk = ch / 32;  // whole chunks; where ch % 32 == 16, one k16 step after them
    uint4 na = load(xa, 0), nb = load(xb, 0);
    for (int kk = 0; kk < nk; ++kk) {
        const uint4 ca = na, cb = nb;
        if (kk + 1 < nk) {
            na = load(xa, kk + 1);
            nb = load(xb, kk + 1);
        }
        const uint32_t a0[4] = {ca.x, cb.x, ca.y, cb.y};
        const uint32_t a1[4] = {ca.z, cb.z, ca.w, cb.w};
        const int u = (4 * kk + t4) ^ sw;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const uint4 w = wrow[n * 8 * wunits + u];
            mma16816(acc[n], a0, w.x, w.y);
            mma16816(acc[n], a1, w.z, w.w);
        }
    }
    if (ch % 32) {  // the last 16 columns: thread (g, t4) holds 4 t4 .. 4 t4 + 3 of them
        const int k0 = 32 * nk + 4 * t4;
        const uint2 ta = xa ? __ldg(reinterpret_cast<const uint2*>(xa + k0)) : make_uint2(0, 0);
        const uint2 tb = xb ? __ldg(reinterpret_cast<const uint2*>(xb + k0)) : make_uint2(0, 0);
        const uint32_t a[4] = {ta.x, tb.x, ta.y, tb.y};
        const int u = (4 * nk + (t4 >> 1)) ^ sw;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const uint2 w = reinterpret_cast<const uint2*>(wrow + n * 8 * wunits + u)[t4 & 1];
            mma16816(acc[n], a, w.x, w.y);
        }
    }
}

__global__ void __launch_bounds__(MMA_WARPS * 32, 1)
local_attn_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                      const bf16* __restrict__ bq, const bf16* __restrict__ wkv,
                      const bf16* __restrict__ bkv, const bf16* __restrict__ sub,
                      const bf16* __restrict__ lw, const bf16* __restrict__ lb,
                      const float* __restrict__ lam_p, bf16* __restrict__ out, int H, int W,
                      int nh, int tr, int tc, long long ld, float lam_init) {
    const int ch = nh * HW2, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
    // the tile: nr x nc tokens from (r0, c0); its k/v halo: the tile and one
    // ring of neighbours, clipped to the map, hw tokens a row from (hr0, hc0)
    const int tcols = (W + tc - 1) / tc;
    const int r0 = (int)(blockIdx.x / tcols) * tr, c0 = (int)(blockIdx.x % tcols) * tc;
    const int nr = min(tr, H - r0), nc = min(tc, W - c0), nint = nr * nc;
    const int hr0 = max(r0 - 1, 0), hc0 = max(c0 - 1, 0);
    const int hw = min(c0 + nc + 1, W) - hc0;
    const int nhalo = (min(r0 + nr + 1, H) - hr0) * hw;
    const int wunits = mma_wld(ch) / 8, swz = (wunits & 7) ? 0 : 4;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sW = reinterpret_cast<bf16*>(smem_raw);
    bf16* sOut = sW + NCOL * wunits * 8;
    float* sBias = reinterpret_cast<float*>(sOut + MMA_WARPS * 16 * OUT_LD);  // q | k | v
    float* sLW = sBias + NCOL;    // 9 taps x HW2, lane order
    float* sLB = sLW + HW2 * 9;   // lane order
    float* sSub = sLB + HW2;      // lane order
    bf16* sK = reinterpret_cast<bf16*>(sSub + HW2);  // nhalo x KV_LD, lane order
    bf16* sV = sK + nhalo * KV_LD;

    // ---- the head's weight rows (q of wq, then k and v of wkv), resident
    for (int i = tid; i < NCOL * wunits; i += MMA_WARPS * 32) {
        const int o = i / wunits, c = i - o * wunits;
        const bf16* src = o < HW2 ? wq + (size_t)(h * HW2 + o) * ch
                                  : wkv + (size_t)((o < 2 * HW2 ? 0 : ch) + h * HW2 + o % HW2) * ch;
        const bool ok = c * 8 < ch;
        cp_async16(smem_u32(sW + (o * wunits + (c ^ ((o & 1) ? swz : 0))) * 8),
                   ok ? src + c * 8 : src, ok);
    }
    cp_async_commit();
    for (int o = tid; o < NCOL; o += MMA_WARPS * 32)
        sBias[o] = to_f32(o < HW2 ? bq[h * HW2 + o]
                                  : bkv[(o < 2 * HW2 ? 0 : ch) + h * HW2 + o % HW2]);
    for (int i = tid; i < HW2 * 9; i += MMA_WARPS * 32) {
        const int tap = i / HW2, c = lane_order_channel(i - tap * HW2);
        sLW[i] = to_f32(lw[(size_t)(h * HW2 + c) * 9 + tap]);
    }
    for (int i = tid; i < HW2; i += MMA_WARPS * 32) {
        const int c = lane_order_channel(i);
        sLB[i] = to_f32(lb[h * HW2 + c]);
        sSub[i] = to_f32(sub[c]);
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- phase A: k and v of the halo tokens, rounded to bf16 once
    const bf16* xb = x + (long long)b * H * W * ld;
    const auto halo_row = [&](int i) -> const bf16* {
        return i < nhalo ? xb + ((long long)(hr0 + i / hw) * W + hc0 + i % hw) * ld : nullptr;
    };
    for (int mt = warp; mt * 16 < nhalo; mt += MMA_WARPS) {
        const int i0 = mt * 16 + g, i1 = i0 + 8;
        float acc[12][4];
        project<12>(acc, halo_row(i0), halo_row(i1), sW, HW2, ch, wunits, swz);
#pragma unroll
        for (int n = 0; n < 12; n += 2) {  // tiles n and n + 1: lane-order positions 2 n .. + 3
            const float* bias = sBias + HW2 + 8 * n + 2 * t4;  // k's 48 columns, then v's
            bf16* dst = (n < 6 ? sK : sV) + 12 * t4 + 2 * (n % 6);
            if (i0 < nhalo)
                *reinterpret_cast<uint2*>(dst + i0 * KV_LD) =
                    make_uint2(pack_bf16(acc[n][0] + bias[0], acc[n][1] + bias[1]),
                               pack_bf16(acc[n + 1][0] + bias[8], acc[n + 1][1] + bias[9]));
            if (i1 < nhalo)
                *reinterpret_cast<uint2*>(dst + i1 * KV_LD) =
                    make_uint2(pack_bf16(acc[n][2] + bias[0], acc[n][3] + bias[1]),
                               pack_bf16(acc[n + 1][2] + bias[8], acc[n + 1][3] + bias[9]));
        }
    }
    __syncthreads();

    // ---- phase B: per warp 16 tokens of the tile; q in registers, then
    // each quad (g) runs the window of its token rows g and g + 8, lane t4
    // on its 12 lane-order channels
    const float lam = *lam_p, post = 1.f - lam_init, scale = 1.f / sqrtf((float)HEAD_DIM);
    bf16* stage = sOut + warp * 16 * OUT_LD;
    for (int mt = warp; mt * 16 < nint; mt += MMA_WARPS) {
        int pr[2], pc[2];
        const bf16* xr[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int j = mt * 16 + g + 8 * hf;
            const int jj = j < nint ? j : 0;  // a quad past the tile runs token 0, unstored
            pr[hf] = r0 + jj / nc;
            pc[hf] = c0 + jj % nc;
            xr[hf] = j < nint ? xb + ((long long)pr[hf] * W + pc[hf]) * ld : nullptr;
        }
        float q[6][4];
        project<6>(q, xr[0], xr[1], sW, 0, ch, wunits, swz);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int row = pr[hf], col = pc[hf];
            const int cidx = (row - hr0) * hw + col - hc0;  // the token in the halo
            const bool up = row > 0, down = row + 1 < H, left = col > 0, right = col + 1 < W;
            const auto tap_ok = [&](int tap) {
                const int dy = tap / 3 - 1, dx = tap % 3 - 1;
                return (dy < 0 ? up : dy > 0 ? down : true) && (dx < 0 ? left : dx > 0 ? right : true);
            };
            float qv[12];
#pragma unroll
            for (int n = 0; n < 6; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    qv[2 * n + e] = (q[n][2 * hf + e] + sBias[8 * n + 2 * t4 + e]) * scale;
            float s0[9], s1[9];
            float m0 = NEG_INF, m1 = NEG_INF;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                const bool ok = tap_ok(tap);
                const uint2* kt = reinterpret_cast<const uint2*>(
                    sK + (ok ? cidx + (tap / 3 - 1) * hw + tap % 3 - 1 : cidx) * KV_LD + 12 * t4);
                float kf[12];
#pragma unroll
                for (int m = 0; m < 3; ++m) unpack_bf16x4(kt[m], kf + 4 * m);
                float p0 = 0.f, p1 = 0.f;
#pragma unroll
                for (int c = 0; c < 6; ++c) {
                    p0 = fmaf(qv[c], kf[c], p0);
                    p1 = fmaf(qv[6 + c], kf[6 + c], p1);
                }
                p0 = quad_sum(p0);
                p1 = quad_sum(p1);
                s0[tap] = ok ? p0 : NEG_INF;
                s1[tap] = ok ? p1 : NEG_INF;
                m0 = fmaxf(m0, s0[tap]);
                m1 = fmaxf(m1, s1[tap]);
            }
            float d0 = 0.f, d1 = 0.f;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                s0[tap] = __expf(s0[tap] - m0);
                s1[tap] = __expf(s1[tap] - m1);
                d0 += s0[tap];
                d1 += s1[tap];
            }
            const float i0 = 1.f / d0, i1 = lam / d1;
            float o[12], l[12];
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                const float4 lb4 = reinterpret_cast<const float4*>(sLB + 12 * t4)[m];
                o[4 * m] = o[4 * m + 1] = o[4 * m + 2] = o[4 * m + 3] = 0.f;
                l[4 * m] = lb4.x, l[4 * m + 1] = lb4.y, l[4 * m + 2] = lb4.z, l[4 * m + 3] = lb4.w;
            }
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                if (!tap_ok(tap)) continue;  // v is 0 there
                const float w = s0[tap] * i0 - s1[tap] * i1;
                const uint2* vt = reinterpret_cast<const uint2*>(
                    sV + (cidx + (tap / 3 - 1) * hw + tap % 3 - 1) * KV_LD + 12 * t4);
                const float4* lwt = reinterpret_cast<const float4*>(sLW + tap * HW2 + 12 * t4);
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                    float vf[4];
                    unpack_bf16x4(vt[m], vf);
                    const float4 w4 = lwt[m];
                    const float lwv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        o[4 * m + e] = fmaf(w, vf[e], o[4 * m + e]);
                        l[4 * m + e] = fmaf(lwv[e], vf[e], l[4 * m + e]);
                    }
                }
            }
            float ss = 0.f;
#pragma unroll
            for (int c = 0; c < 12; ++c) ss = fmaf(o[c], o[c], ss);
            const float rn = rsqrtf(quad_sum(ss) / HW2 + 1e-5f);
            const float* sb = sSub + 12 * t4;
#pragma unroll
            for (int n = 0; n < 6; ++n)  // lane-order 2 n, 2 n + 1: channels 8 n + 2 t4, + 1
                *reinterpret_cast<uint32_t*>(stage + (g + 8 * hf) * OUT_LD + 8 * n + 2 * t4) =
                    pack_bf16(o[2 * n] * rn * sb[2 * n] * post + l[2 * n],
                              o[2 * n + 1] * rn * sb[2 * n + 1] * post + l[2 * n + 1]);
        }
        __syncwarp();
        for (int i = lane; i < 16 * 6; i += 32) {  // 6 16-byte units per token row
            const int rrow = i / 6, u = i - rrow * 6, j = mt * 16 + rrow;
            if (j < nint)
                *reinterpret_cast<uint4*>(
                    out + (((long long)b * H + r0 + j / nc) * W + c0 + j % nc) * ch + h * HW2 + u * 8) =
                    *reinterpret_cast<const uint4*>(stage + rrow * OUT_LD + u * 8);
        }
        __syncwarp();
    }
}

int launch_scalar(const void* x, const void* wq, const void* bq, const void* wkv,
                  const void* bkv, const void* sub, const void* lw, const void* lb,
                  const void* lam, void* out, int B, int H, int W, int nh, int rows,
                  size_t bytes, long long ld, float lam_init, cudaStream_t st) {
    auto kern = local_attn_kernel<float, HEAD_DIM>;
    if (const int e = set_smem(kern, bytes)) return e;
    const dim3 grid((unsigned)((H + rows - 1) / rows), (unsigned)nh, (unsigned)B);
    kern<<<grid, THREADS, bytes, st>>>(
        (const float*)x, (const float*)wq, (const float*)bq, (const float*)wkv,
        (const float*)bkv, (const float*)sub, (const float*)lw, (const float*)lb,
        (const float*)lam, (float*)out, H, W, nh, rows, ld, lam_init);
    return (int)cudaGetLastError();
}

int launch_mma(const void* x, const void* wq, const void* bq, const void* wkv,
               const void* bkv, const void* sub, const void* lw, const void* lb,
               const void* lam, void* out, int B, int H, int W, int nh, int tr, int tc,
               size_t bytes, long long ld, float lam_init, cudaStream_t st) {
    auto kern = local_attn_mma_kernel;
    if (const int e = set_smem(kern, bytes)) return e;
    const long long tiles = (long long)((H + tr - 1) / tr) * ((W + tc - 1) / tc);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, (unsigned)nh, (unsigned)B);
    kern<<<grid, MMA_WARPS * 32, bytes, st>>>(
        (const bf16*)x, (const bf16*)wq, (const bf16*)bq, (const bf16*)wkv, (const bf16*)bkv,
        (const bf16*)sub, (const bf16*)lw, (const bf16*)lb, (const float*)lam, (bf16*)out, H, W,
        nh, tr, tc, ld, lam_init);
    return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, >= ch) with tokens ld elements apart and unit channel stride;
// wq (ch, ch), bq (ch), wkv (2 ch, ch), bkv (2 ch), sub (2 hd),
// lw (ch, 1, 3, 3), lb (ch), all x's type and contiguous; lam: one fp32
// value on the device; out: (B, H, W, ch) contiguous. The launch (tile of
// tile_rows x tile_cols tokens, shared-memory bytes) comes from
// mlagg_unet_torch/ops/mlla_attn_fused.py::local_launch_plan and is checked
// here: head_dim 24; bf16 launches local_attn_mma_kernel (a tile within the
// map, the shared memory of its largest halo, 16-byte aligned x, token
// stride, weights and output), fp32 local_attn_kernel (tile_cols = W, the
// shared memory of tile_rows rows).
extern "C" int mlagg_local_attn(const void* x, const void* wq, const void* bq,
                                const void* wkv, const void* bkv, const void* sub,
                                const void* lw, const void* lb, const void* lam,
                                void* out, int B, int H, int W, int nh, int hd,
                                int tile_rows, int tile_cols, long long smem_bytes,
                                long long ld, float lam_init, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B < 1 || B > 65535 || H < 1 || W < 1 || nh < 1 || nh > 65535 || hd != HEAD_DIM ||
        ld < (long long)nh * HW2 || tile_rows < 1 || tile_rows > H || tile_cols < 1 ||
        tile_cols > W)
        return (int)cudaErrorInvalidValue;
    if (dtype == MLAGG_BF16) {
        const int halo = min(tile_rows + 2, H) * min(tile_cols + 2, W);
        if (smem_bytes != (long long)local_mma_smem_bytes(nh * HW2, halo))
            return (int)cudaErrorInvalidValue;
        const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
        if (!aligned(x) || !aligned(wq) || !aligned(wkv) || !aligned(out) || ld % 8)
            return (int)cudaErrorMisalignedAddress;
        return launch_mma(x, wq, bq, wkv, bkv, sub, lw, lb, lam, out, B, H, W, nh, tile_rows,
                          tile_cols, (size_t)smem_bytes, ld, lam_init, st);
    }
    if (dtype != MLAGG_F32 || tile_cols != W ||
        smem_bytes != (long long)smem_bytes_t<float, HEAD_DIM>(W, tile_rows))
        return (int)cudaErrorInvalidValue;
    return launch_scalar(x, wq, bq, wkv, bkv, sub, lw, lb, lam, out, B, H, W, nh, tile_rows,
                         (size_t)smem_bytes, ld, lam_init, st);
}
