// Fused MLLA block front and tail: K2 and K3 of the port.
//
// Replace the Pallas kernels mlagg_unet_tpu/ops/mlla_fused.py `_front_kernel`
// (mlla_block_front_fused) and `_tail_kernel` (mlla_block_tail_fused).
// Token-pointwise:
//   front: y = LN(x); a = silu(y Wa^T + ba); h = y Wi^T + bi
//   tail:  x2 = s + (h * a) Wo^T + bo; out = x2 + gelu(LN(x2) W1^T + b1) W2^T + b2
// LN is the flax LayerNorm (fast variance E[x^2] - E[x]^2, eps passed in),
// GELU the exact erf form. Weights are in torch's (out, in) layout.
//
// What bounds it on the H100: per token the tail does 2 * 5 C^2 FLOPs against
// 8 C bytes of bf16 I/O (the front 2 * 2 C^2 against 6 C bytes), i.e. 60-480
// FLOP/byte at C = 96..768. In fp32 FMA (67 TFLOP/s, 20 FLOP/byte at
// 3.35 TB/s) both are bound by arithmetic; on bf16 tensor cores (295
// FLOP/byte) by bytes at C <= 384 and by arithmetic at C = 768.
//
// Four kernels:
//
// front_kernel and tail_kernel (K2 and K3 for fp32 I/O, fp32 arithmetic): one
// CTA of 256 threads per tile of T tokens keeps every intermediate (LN
// output, x2, the MLP hidden z) in fp32 shared memory, so device memory sees
// the inputs once and the outputs once, as in the Pallas kernel. T is picked
// from C so that the tail's x2, LN output and z (4 C floats per token) fit
// ~100 KB (T = 64 at C = 96, 8 at C = 768). The products stream K-slices of
// the weight through shared memory and run as fp32 FMA, each warp owning T/8
// tokens and each lane two output columns 32 apart, so that activations are
// warp broadcasts and weight reads are conflict-free. fp32 I/O keeps these
// kernels: bf16 tensor cores would break their 1e-4 agreement with the fp32
// twins.
//
// front_mma_kernel (K2 for bf16 I/O). Its bytes, 6 C per token, bound it at
// every flagship width but C = 768 (4 C^2 FLOPs a token: 8.5 GFLOP a launch
// at every stage, 8.6 us at 989 TFLOP/s). As fp32 FMA it took 16x that
// bound, staging each weight element as fp32 with a division per element
// and two barriers per 64 x 32 slice. What the design does about the bound:
// - Tensor cores: [Wa; Wi] is one product of width 2 C, on Hopper's wgmma
//   (m64nNk16, bf16 operands read by the tensor cores straight from shared
//   memory, fp32 accumulators), 64 tokens a tile. An mma.sync form with
//   ldmatrix fragments, tried first, was bound by the fragment loads of its
//   16 x 16 to 32 x 48 warp tiles; wgmma reads each operand once per step.
//   Operands are in the core-matrix layout without swizzle (8 rows x 16
//   bytes contiguous), which 16-byte cp.async fills directly. The two
//   warpgroups take every other 8-column group of a pass, so that both share
//   a's SiLU where a pass spans a and h.
// - Rounding: x is read with 16-byte cp.async; the LN statistics and LN stay
//   fp32 (each row's sums over 4 threads in a fixed order) and y is rounded
//   to bf16 once, in place over x in shared memory, as the one A operand of
//   both products. ops/mlla_fused.py::mlla_front_bf16_operands_plain rounds
//   exactly there (y and the weights).
// - Weights without a barrier in the K loop, in one of two modes. Up to
//   C = 384 a CTA keeps a chunk of [Wa; Wi] resident (all 2 C rows up to
//   C = 192: 37 KB at 96, 147 KB at 192; 128 rows up to 384) and, persistent,
//   walks token tiles with the next tile's x in flight while the current one
//   multiplies; the grid is (CTAs per chunk) x (chunks) filling the SMs, 2
//   CTAs per SM up to C = 96. Where a chunk is not all of [Wa; Wi], the
//   chunks of one tile run at about the same time and re-read x from L2. At
//   C = 768 (3584 tokens, 2.4 MB of weights) that re-read and the LN redone
//   per chunk cost more than the product, so there a CTA keeps one tile of x,
//   LN'd once, and walks its share of 32-row weight chunks through two slots,
//   the next chunk in flight; the grid is (tiles) x (groups of chunks). Both
//   modes stream from L2 with 16-byte cp.async; development builds timed with
//   phases cut out found those streams, not the products, setting the time
//   at C >= 384 (TMA bulk copies are the lever left).
// - Epilogue: bias, SiLU on a's columns, bf16 into a shared stage, then
//   16-byte stores into a or h (an 8-column group lies wholly in one: C % 8
//   == 0).
// - Ragged token counts are masked (rows past M are zero-filled, not read,
//   and not written), not padded. No atomics: two runs give the same bits.
// The launch (mode, tokens per CTA, weight rows per chunk, shared memory,
// grid) is planned by mlagg_unet_torch/ops/mlla_fused.py::front_launch_plan
// and checked here against front_mma_shape / front_mma_smem_bytes.
//
// tail_mma_kernel (K3 for bf16 I/O). What the design does about the bound:
// - Tensor cores: the three products run as mma.sync m16n8k16 with bf16
//   operands on ldmatrix fragments and fp32 accumulators. The kernel rounds
//   to bf16 only the three A operands, h * a, LN(x2) and GELU(z), each
//   computed in fp32 (the weights arrive in bf16). x2, the LN statistics and
//   every epilogue (biases, residuals, GELU) stay in fp32. The bf16 plain
//   twin rounds there too and also rounds x2 and every product's output, so
//   the kernel is no further than the twin from the all-fp32 Pallas kernel;
//   ops/mlla_fused.py::mlla_tail_bf16_operands_plain rounds exactly where the
//   kernel does.
// - Weights amortised over 64 tokens per CTA (32 at C = 768), where the fp32
//   kernel had 8 at C = 768: the hidden dimension is chunked (128 wide, 256
//   at C = 768), so z is never whole: acc += GELU(y W1[c]^T + b1[c]) W2[:, c]^T
//   chunk by chunk, and acc, the (tokens x C) output tile, lives in registers
//   from its start, x2 + b2, to its end. Shared memory holds per token only C
//   bf16 values (h * a, then LN(x2), then the output) and one chunk of z in
//   bf16. 8 warps: 2 along tokens x 4 along the C columns; the LN statistics
//   of a row are summed from the 4 column warps' partials in a fixed order.
//   At C = 768 and 3584 tokens (model batch 16, the last stage) the grid is
//   112 CTAs of 32 tokens, one per SM (190 KB of shared memory each): one
//   wave on 112 of the 132 SMs. Fewer tokens per CTA would fill the card but
//   read the weights from L2 more often (5 C^2 bf16 = 5.9 MB per CTA); more
//   do not fit the registers (the 32 x 768 fp32 tile is 96 a thread).
// - Streamed weights: every product's weight goes through one ring in shared
//   memory as K-slices of 32 columns (Wo, then per chunk the W1 rows and the
//   W2 columns), with 16-byte cp.async, across product boundaries too. The
//   ring has 4 slots up to C = 192 (2 CTAs per SM), 3 up to 384 and 2 at 768,
//   as many as shared memory leaves room for, so 1 to 3 slices load while one
//   multiplies; one barrier per slice both publishes the slice and frees the
//   slot of the one before. Slot rows are 5 16-byte chunks apart (odd), so
//   ldmatrix is conflict-free; the copy loops index with shifts, no division.
// - Ragged token counts are masked (rows past M read as zero and are not
//   written), not padded. No atomics: two runs give the same bits.
// The launch (tokens per CTA, hidden chunk, shared memory, grid) is planned by
// mlagg_unet_torch/ops/mlla_fused.py::tail_launch_plan and checked here
// against tail_mma_shape / tail_mma_smem_bytes.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BO = 64;        // output columns per pass: 2 per lane
constexpr int BKS = 32;       // K slice of the weight staged per step
constexpr int WLD = BKS + 1;  // padded weight row: conflict-free lanes
constexpr int SMEM_BUDGET = 112 * 1024;

// __fdividef: 2 ulp, where an IEEE division cost K2's bf16 epilogue more than
// its products; 0 for a < -88 (exp overflows), as silu tends to there.
__device__ __forceinline__ float silu_f(float a) { return __fdividef(a, 1.f + __expf(-a)); }

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

// ------------------------------------------------------------------ bf16 mma tail

using bf16 = __nv_bfloat16;

constexpr int MMA_THREADS = 256;  // 8 warps: 2 along tokens x 4 along columns
constexpr int BK = 32;            // K columns of a weight slice
constexpr int SLD = BK + 8;       // slot row stride: 5 16-byte chunks (odd), so the 8
                                  // rows of an ldmatrix matrix hit distinct banks

// The instantiations: for C up to W, MT m16 tiles of tokens per warp (tokens
// per CTA = 32 MT), W / 32 n8 tiles of C per warp at most, NZ n8 tiles of a
// hidden chunk per warp (chunk = 32 NZ), RING slots of the weight ring (as
// many as the shared memory of the CTAs an SM holds leaves room for).
// (mirrored by ops/mlla_fused.py::tail_launch_plan)
#define MLAGG_TAIL_SHAPES(X) \
    X(96, 2, 4, 4)           \
    X(192, 2, 4, 4)          \
    X(384, 2, 4, 3)          \
    X(768, 1, 8, 2)

struct TailShape {
    int mt, nt, nz, ring;
};

// 0 where C is not taken: not a multiple of 32, or wider than the table.
__host__ __device__ inline TailShape tail_mma_shape(int C) {
    if (C < 32 || C % 32) return TailShape{0, 0, 0, 0};
#define X(W, MT, NZ, RING) \
    if (C <= W) return TailShape{MT, W / 32, NZ, RING};
    MLAGG_TAIL_SHAPES(X)
#undef X
    return TailShape{0, 0, 0, 0};
}

// sA (tm x (C + 8) bf16) | sZ (tm x (hc + 8) bf16) | ring slots of
// max(C, hc) x SLD bf16 | LN partial sums (tm x 4 x 2 fp32). Each region
// starts 16-byte aligned. (mirrored by tail_launch_plan)
__host__ __device__ inline size_t tail_mma_smem_bytes(int tm, int C, int hc, int ring) {
    const int wrows = C > hc ? C : hc;
    return ((size_t)tm * (C + 8) + (size_t)tm * (hc + 8) + (size_t)ring * wrows * SLD) * 2 +
           (size_t)tm * 8 * sizeof(float);
}

// acc[m][n] += A[arow0 + 16 m .., acol0 .. acol0 + 32] * B[brow0 + 8 n .., 0 .. 32]^T for
// n < nt: A row-major bf16 in shared memory (row stride lda), B one weight
// slice (rows are output features, SLD apart). Two k16 steps; B's ldmatrix.x4
// gives both steps' fragments of one n8 tile.
template <int MT, int NTILES>
__device__ __forceinline__ void mma_slice(float (&acc)[MT][NTILES][4], const bf16* sA, int lda,
                                          int arow0, int acol0, const bf16* slot, int brow0,
                                          int nt) {
    const int lane = threadIdx.x & 31;
    uint32_t af[2][MT][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int m = 0; m < MT; ++m)
            ldsm_x4(af[ks][m], smem_u32(sA + (arow0 + m * 16 + (lane & 15)) * lda + acol0 +
                                        ks * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
        if (n >= nt) continue;
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(slot + (brow0 + n * 8 + (lane & 7)) * SLD + (lane >> 3) * 8));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            mma16816(acc[m][n], af[0][m], bf[0], bf[1]);
            mma16816(acc[m][n], af[1][m], bf[2], bf[3]);
        }
    }
}

template <int MT, int NT, int NZ, int RING>
__global__ void __launch_bounds__(MMA_THREADS, MT * (NT + NZ) <= 20 ? 2 : 1)
tail_mma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ a,
                const bf16* __restrict__ s, const bf16* __restrict__ wo,
                const bf16* __restrict__ bo, const bf16* __restrict__ lw,
                const bf16* __restrict__ lb, const bf16* __restrict__ w1,
                const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ b2, bf16* __restrict__ out, long long M, int C,
                int Hd, float eps) {
    constexpr int TM = 32 * MT, HC = 32 * NZ;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lda = C + 8, ldz = HC + 8, wrows = max(C, HC);
    bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // h * a, then LN(x2), then the output
    bf16* sZ = sA + TM * lda;                       // GELU(z) of one hidden chunk
    bf16* sW = sZ + TM * ldz;                       // the weight ring
    float* sStat = reinterpret_cast<float*>(sW + RING * wrows * SLD);  // [row][warp col][2]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wn = warp & 3, g = lane >> 2, t4 = lane & 3;
    const int row0 = (warp >> 2) * (TM / 2);  // this warp's first token of the tile
    const int nt = C / 32, ccol0 = wn * (C / 4);
    const long long m0 = (long long)blockIdx.x * TM;
    const int rows = (int)min((long long)TM, M - m0);
    const int ks_c = C / BK, nchunks = (Hd + HC - 1) / HC;

    // ---- the weight ring: slices in the order the products use them
    int phase = 0, chunk = 0, kk = 0;  // next slice to issue: phase 0 Wo, 1 W1, 2 W2
    auto issue = [&](int slot) {
        if (phase == 1 && chunk == nchunks) {  // nothing left: an empty group
            cp_async_commit();
            return;
        }
        const bf16* src;
        int ld, nr;
        const int c0 = chunk * HC, cw = min(HC, Hd - c0);
        if (phase == 0) {
            src = wo + kk * BK, ld = C, nr = C;
        } else if (phase == 1) {
            src = w1 + (size_t)c0 * C + kk * BK, ld = C, nr = cw;
        } else {
            src = w2 + c0 + kk * BK, ld = Hd, nr = C;
        }
        bf16* dst = sW + slot * wrows * SLD;
        for (int i = tid; i < nr * 4; i += MMA_THREADS) {
            const int r = i >> 2, c = (i & 3) * 8;
            cp_async16(smem_u32(dst + r * SLD + c), src + (size_t)r * ld + c, true);
        }
        cp_async_commit();
        ++kk;
        if (phase == 0 && kk == ks_c) {
            phase = 1, kk = 0;
        } else if (phase == 1 && kk == ks_c) {
            phase = 2, kk = 0;
        } else if (phase == 2 && kk == cw / BK) {
            phase = 1, kk = 0, ++chunk;
        }
    };
    int used = 0;  // slices consumed
    // Slice `used`, once this thread's copies of it have landed (wait) and
    // every thread's have (barrier). Past the barrier every thread is done
    // with the slice before it, so that slice's slot takes the slice RING - 1
    // ahead: one barrier per slice, RING - 1 slices in flight. The barrier
    // also publishes what the threads wrote into sA or sZ before it.
    auto acquire = [&]() -> const bf16* {
        cp_async_wait<RING - 2>();
        __syncthreads();
        issue((used + RING - 1) % RING);
        return sW + (used++ % RING) * wrows * SLD;
    };
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) issue(i);

    // ---- h * a in fp32, rounded to bf16 once: the first A operand. The
    // tile's 16-byte chunks (r, c) are walked from each thread's first one,
    // all of a thread's loads issued before any is used.
    const int cchunks = C / 8;
    const int wr0 = tid / cchunks, wc0 = tid - wr0 * cchunks;
    const int dr = MMA_THREADS / cchunks, dc = MMA_THREADS - dr * cchunks;
    {
        constexpr int LOADS = (TM * NT * 4 + MMA_THREADS - 1) / MMA_THREADS;  // >= a thread's chunks
        uint4 hv[LOADS], av[LOADS];
#pragma unroll
        for (int j = 0, r = wr0, c = wc0; j < LOADS; ++j) {
            hv[j] = av[j] = make_uint4(0, 0, 0, 0);
            if (r < rows) {
                hv[j] = *reinterpret_cast<const uint4*>(h + (m0 + r) * C + c * 8);
                av[j] = *reinterpret_cast<const uint4*>(a + (m0 + r) * C + c * 8);
            }
            r += dr, c += dc;
            if (c >= cchunks) c -= cchunks, ++r;
        }
#pragma unroll
        for (int j = 0, r = wr0, c = wc0; j < LOADS; ++j) {
            if (r < TM) {
                const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&hv[j]);
                const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av[j]);
                uint4 pv;
                uint32_t* pp = reinterpret_cast<uint32_t*>(&pv);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 hf = __bfloat1622float2(hp[e]), af = __bfloat1622float2(ap[e]);
                    pp[e] = pack_bf16(hf.x * af.x, hf.y * af.y);
                }
                *reinterpret_cast<uint4*>(sA + r * lda + c * 8) = pv;
            }
            r += dr, c += dc;
            if (c >= cchunks) c -= cchunks, ++r;
        }
    }

    // ---- x2 = s + (h * a) Wo^T + bo, in the accumulator tile
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
    for (int k = 0; k < ks_c; ++k)
        mma_slice<MT, NT>(acc, sA, lda, row0, k * BK, acquire(), ccol0, nt);
    float ps[MT][2], pq[MT][2];  // per row (m, half): partial sum and sum of squares
#pragma unroll
    for (int m = 0; m < MT; ++m) ps[m][0] = ps[m][1] = pq[m][0] = pq[m][1] = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            if (n >= nt) continue;
            const int col = ccol0 + n * 8 + 2 * t4;
            const float bo0 = to_f32(bo[col]), bo1 = to_f32(bo[col + 1]);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int r = row0 + m * 16 + hf * 8 + g;
                float2 sv = make_float2(0.f, 0.f);
                if (r < rows)
                    sv = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(s + (m0 + r) * C + col));
                const float x0 = acc[m][n][2 * hf] + bo0 + sv.x;
                const float x1 = acc[m][n][2 * hf + 1] + bo1 + sv.y;
                acc[m][n][2 * hf] = x0;
                acc[m][n][2 * hf + 1] = x1;
                ps[m][hf] += x0 + x1;
                pq[m][hf] = fmaf(x0, x0, fmaf(x1, x1, pq[m][hf]));
            }
        }
    // ---- LN statistics: the quad's sum, then the 4 column warps' in order
    // (the barrier also ends every read of h * a in sA)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const float sm = quad_sum(ps[m][hf]), sq = quad_sum(pq[m][hf]);
            if (t4 == 0) {
                float* st = sStat + ((row0 + m * 16 + hf * 8 + g) * 4 + wn) * 2;
                st[0] = sm;
                st[1] = sq;
            }
        }
    __syncthreads();
    const float inv_c = 1.f / C;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = row0 + m * 16 + hf * 8 + g;
            const float* st = sStat + r * 8;
            const float mu = (((st[0] + st[2]) + st[4]) + st[6]) * inv_c;
            const float var = fmaxf((((st[1] + st[3]) + st[5]) + st[7]) * inv_c - mu * mu, 0.f);
            const float rs = rsqrtf(var + eps);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                if (n >= nt) continue;
                const int col = ccol0 + n * 8 + 2 * t4;
                const float y0 = (acc[m][n][2 * hf] - mu) * rs * to_f32(lw[col]) + to_f32(lb[col]);
                const float y1 =
                    (acc[m][n][2 * hf + 1] - mu) * rs * to_f32(lw[col + 1]) + to_f32(lb[col + 1]);
                // LN(x2) rounded to bf16 once: the second A operand
                *reinterpret_cast<uint32_t*>(sA + r * lda + col) = pack_bf16(y0, y1);
                // the output's accumulator starts at x2 + b2
                acc[m][n][2 * hf] += to_f32(b2[col]);
                acc[m][n][2 * hf + 1] += to_f32(b2[col + 1]);
            }
        }

    // ---- the MLP, one hidden chunk at a time
    for (int c = 0; c < nchunks; ++c) {
        const int c0 = c * HC, cw = min(HC, Hd - c0), nz = cw / 32, zcol0 = wn * (cw / 4);
        float zacc[MT][NZ][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NZ; ++n)
                zacc[m][n][0] = zacc[m][n][1] = zacc[m][n][2] = zacc[m][n][3] = 0.f;
        for (int k = 0; k < ks_c; ++k)
            mma_slice<MT, NZ>(zacc, sA, lda, row0, k * BK, acquire(), zcol0, nz);
        // GELU(z + b1) rounded to bf16 once: the third A operand (sZ is free:
        // this chunk's acquire barriers came after every read of the last)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NZ; ++n) {
                if (n >= nz) continue;
                const int col = zcol0 + n * 8 + 2 * t4;
                const float bb0 = to_f32(b1[c0 + col]), bb1 = to_f32(b1[c0 + col + 1]);
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int r = row0 + m * 16 + hf * 8 + g;
                    *reinterpret_cast<uint32_t*>(sZ + r * ldz + col) =
                        pack_bf16(gelu_f(zacc[m][n][2 * hf] + bb0),
                                  gelu_f(zacc[m][n][2 * hf + 1] + bb1));
                }
            }
        for (int k = 0; k < nz; ++k)
            mma_slice<MT, NT>(acc, sZ, ldz, row0, k * BK, acquire(), ccol0, nt);
    }
    cp_async_wait<0>();

    // ---- the output: staged in sA as bf16 (free: the last chunk's W2
    // barriers came after every read of LN(x2)), then 16-byte stores
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            if (n >= nt) continue;
            const int col = ccol0 + n * 8 + 2 * t4;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
                *reinterpret_cast<uint32_t*>(sA + (row0 + m * 16 + hf * 8 + g) * lda + col) =
                    pack_bf16(acc[m][n][2 * hf], acc[m][n][2 * hf + 1]);
        }
    __syncthreads();
    for (int r = wr0, c = wc0; r < rows;) {
        *reinterpret_cast<uint4*>(out + (m0 + r) * C + c * 8) =
            *reinterpret_cast<const uint4*>(sA + r * lda + c * 8);
        r += dr, c += dc;
        if (c >= cchunks) c -= cchunks, ++r;
    }
}

// ------------------------------------------------------------------ bf16 wgmma front

constexpr int FRONT_TM = 64;  // tokens per tile: the M of a wgmma

// The instantiations: for C up to W, a pass over output columns is 32 NW
// wide (16 NW per warpgroup), weight rows come in chunks of R (0: all 2 C of
// [Wa; Wi]), XRES picks the mode, PER_SM CTAs per SM.
// - XRES 0, weights resident: a CTA holds its chunk of weight rows and walks
//   token tiles, two x tiles in flight.
// - XRES 1, x resident: a CTA holds one token tile, LN'd once, and walks its
//   share of the weight chunks through two slots.
// (mirrored by ops/mlla_fused.py::front_launch_plan)
#define MLAGG_FRONT_SHAPES(X) \
    X(96, 6, 0, 0, 2)         \
    X(192, 6, 0, 0, 1)        \
    X(384, 4, 128, 0, 1)      \
    X(768, 1, 32, 1, 1)

struct FrontShape {
    int nw, rows, xres, per_sm;
};

// 0 where C is not taken: not a multiple of 32, or wider than the table.
__host__ __device__ inline FrontShape front_mma_shape(int C) {
    if (C < 32 || C % 32) return FrontShape{0, 0, 0, 0};
#define X(W, NW, R, XRES, PER_SM) \
    if (C <= W) return FrontShape{NW, R ? R : 2 * C, XRES, PER_SM};
    MLAGG_FRONT_SHAPES(X)
#undef X
    return FrontShape{0, 0, 0, 0};
}

// Weight rows (one chunk of `rows`, two slots of it with xres) and x tiles
// (two, one with xres) of 64 x C, both bf16 in wgmma's core-matrix layout |
// the output stage (64 x (pass + 8) bf16, row-major), pass = min(32 nw, rows)
// | LN scale and bias (2 C fp32). (mirrored by front_launch_plan)
__host__ __device__ inline size_t front_mma_smem_bytes(int C, int rows, int nw, int xres) {
    const int pass = 32 * nw < rows ? 32 * nw : rows;
    return ((size_t)(1 + xres) * rows * C + (size_t)(2 - xres) * FRONT_TM * C +
            (size_t)FRONT_TM * (pass + 8)) * 2 +
           (size_t)2 * C * sizeof(float);
}

// Walks the 16-byte chunks (r, c) of a row-major tile with `cols` chunks per
// row from this thread's first one, MMA_THREADS chunks a step, without
// division in the loop.
struct ChunkWalk {
    int r, c, dr, dc, cols;
    __device__ ChunkWalk(int cols_) : cols(cols_) {
        r = threadIdx.x / cols, c = threadIdx.x - r * cols;
        dr = MMA_THREADS / cols, dc = MMA_THREADS - dr * cols;
    }
    __device__ void next() {
        r += dr, c += dc;
        if (c >= cols) c -= cols, ++r;
    }
};

// Copies rows [0, nrows) of a row-major bf16 matrix of `cchunks` 16-byte
// chunks a row into the core-matrix layout: chunk c of row r goes to chunk
// ((r / 8) cchunks + c) 8 + r % 8 of dst, so that 8 neighbouring threads fill
// 128 contiguous bytes from 8 rows' 64-byte runs. row(r) gives row r's source
// (nullptr: zero-fill, not read; `safe` stands in as the unread address).
template <typename RowPtr>
__device__ __forceinline__ void load_core_rows(bf16* dst, int nrows, int cchunks, RowPtr row,
                                               const bf16* safe) {
    const int ri = threadIdx.x & 7;
    int g = (threadIdx.x >> 3) / cchunks, c = (threadIdx.x >> 3) - g * cchunks;
    while (g * 8 < nrows) {
        const bf16* src = row(g * 8 + ri);
        cp_async16(smem_u32(dst + ((g * cchunks + c) * 8 + ri) * 8), src ? src + c * 8 : safe,
                   src != nullptr);
        for (c += MMA_THREADS / 8; c >= cchunks;) c -= cchunks, ++g;
    }
}

// y = LN(x) over a 64-row tile in the core-matrix layout, in fp32, rounded
// to bf16 once, in place. Warp w holds rows 8 w .. 8 w + 7 (lane & 7); lanes
// 8 apart share a row and sum it in a fixed order. A thread's chunks stay in
// registers between the two passes. Ends with the proxy fence that orders
// the writes (and this thread's earlier cp.async copies) before wgmma.
template <int W>
__device__ __forceinline__ void front_ln(bf16* sA, const float* sG, int C, float eps) {
    constexpr int XCH = (W / 8 + 3) / 4;  // a thread's chunks of its row, at most
    static_assert(MMA_THREADS == 4 * FRONT_TM, "LN: 4 threads per token row");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cchunks = C / 8;
    const int lr = warp * 8 + (lane & 7), q = lane >> 3;
    bf16* xr = sA + (lr >> 3) * cchunks * 64 + (lr & 7) * 8;  // chunk c at xr + 64 c
    uint4 xv[XCH];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
        const int c = q + 4 * j;
        if (c >= cchunks) break;
        xv[j] = *reinterpret_cast<const uint4*>(xr + c * 64);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&xv[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            s += f.x + f.y;
            ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
        }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    ss += __shfl_xor_sync(0xffffffffu, ss, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    ss += __shfl_xor_sync(0xffffffffu, ss, 16);
    const float mu = s / C;
    const float rs = rsqrtf(fmaxf(ss / C - mu * mu, 0.f) + eps);  // flax clips at 0
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
        const int c = q + 4 * j;
        if (c >= cchunks) break;
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&xv[j]);
        const float4* gv = reinterpret_cast<const float4*>(sG + c * 8);
        const float4* bv = reinterpret_cast<const float4*>(sG + C + c * 8);
        const float4 g0 = gv[0], g1 = gv[1], b0 = bv[0], b1 = bv[1];
        const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        uint4 y;
        uint32_t* py = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            py[e] = pack_bf16((f.x - mu) * rs * gg[2 * e] + bb[2 * e],
                              (f.y - mu) * rs * gg[2 * e + 1] + bb[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(xr + c * 64) = y;
    }
    fence_proxy_async_smem();
}

// One pass: columns [o0, o0 + w) of [a | h] for the tile's 64 tokens (rows
// past `rows` not written). Warpgroup wg takes every other 8-column group
// (wg, wg + 2, ...), so that both share a's SiLU where a pass spans a and h:
// one m64n(16 NW) wgmma chain of C / 16 steps over y (sA) and the pass's
// weight rows (sB, every other 8-row group: twice the stride), or n16 chains
// for a narrower pass; then bias, SiLU on a's columns, bf16 into sO, and
// 16-byte stores. The caller has published y and the weight rows (proxy
// fence, barrier); sO is free.
template <int W, int NW>
__device__ __forceinline__ void front_pass(const bf16* sA, const bf16* sB, bf16* sO, int w, int o0,
                                           long long m0, int rows, int C,
                                           const bf16* __restrict__ ba,
                                           const bf16* __restrict__ bi, bf16* __restrict__ a_out,
                                           bf16* __restrict__ h_out) {
    constexpr int NT = 2 * NW;  // a warp's n8 tiles in a full pass
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3, row0 = (warp & 3) * 16;
    const int nw = w / 32, wg = warp >> 2, ldo = w + 8;
    const uint32_t sbo = C * 16;  // bytes between 8-row groups
    float acc[8 * NW];
#pragma unroll
    for (int e = 0; e < 8 * NW; ++e) acc[e] = 0.f;
    wgmma_fence();
    const uint64_t da = wgmma_desc(smem_u32(sA), sbo);
    if (nw == NW) {  // one chain: A read once a k16 step
        const uint64_t db = wgmma_desc(smem_u32(sB + 8 * wg * C), 2 * sbo);
#pragma unroll
        for (int k = 0; k < W / 16; ++k) {
            if (16 * k >= C) break;
            wgmma_64xn<16 * NW>(acc, da + 16 * k, db + 16 * k);  // +256 bytes a k16 step
        }
    } else {  // a narrower pass (C under the instantiation's widest)
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            if (j >= nw) continue;
            const uint64_t db = wgmma_desc(smem_u32(sB + (32 * j + 8 * wg) * C), 2 * sbo);
            float(&aj)[8] = *reinterpret_cast<float(*)[8]>(acc + 8 * j);
#pragma unroll
            for (int k = 0; k < W / 16; ++k) {
                if (16 * k >= C) break;
                wgmma_64xn<16>(aj, da + 16 * k, db + 16 * k);
            }
        }
    }
    wgmma_commit();
    // the biases load while the products run
    float2 bias[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        bias[n] = make_float2(0.f, 0.f);
        if (n < 2 * nw) {
            const int o = o0 + 16 * n + 8 * wg + 2 * t4;
            const bf16* b = o < C ? ba + o : bi + (o - C);
            bias[n] = make_float2(to_f32(b[0]), to_f32(b[1]));
        }
    }
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        if (n >= 2 * nw) continue;
        const int lc = 16 * n + 8 * wg + 2 * t4;
        const bool is_a = o0 + lc < C;  // an n8 tile lies in a or in h: C % 8 == 0
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            float v0 = acc[4 * n + 2 * hf] + bias[n].x;
            float v1 = acc[4 * n + 2 * hf + 1] + bias[n].y;
            if (is_a) v0 = silu_f(v0), v1 = silu_f(v1);
            *reinterpret_cast<uint32_t*>(sO + (row0 + hf * 8 + g) * ldo + lc) = pack_bf16(v0, v1);
        }
    }
    __syncthreads();
    for (ChunkWalk st(w / 8); st.r < rows; st.next()) {
        const int o = o0 + st.c * 8;
        bf16* dst = (o < C ? a_out + o : h_out + (o - C)) + (m0 + st.r) * C;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(sO + st.r * ldo + st.c * 8);
    }
}

template <int W, int NW, int XRES, int PER_SM>
__global__ void __launch_bounds__(MMA_THREADS, PER_SM)
front_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lw,
                 const bf16* __restrict__ lb, const bf16* __restrict__ wa,
                 const bf16* __restrict__ ba, const bf16* __restrict__ wi,
                 const bf16* __restrict__ bi, bf16* __restrict__ a_out,
                 bf16* __restrict__ h_out, long long M, int C, int R, float eps) {
    constexpr int TM = FRONT_TM;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int pass = min(32 * NW, R);
    bf16* sW = reinterpret_cast<bf16*>(smem_raw);  // weight rows: a chunk (XRES: two slots)
    bf16* sX = sW + (1 + XRES) * R * C;            // x tiles (XRES: one), LN'd in place
    bf16* sO = sX + (2 - XRES) * TM * C;           // one pass of the output, bf16
    float* sG = reinterpret_cast<float*>(sO + TM * (pass + 8));  // LN scale, then bias
    const int tid = threadIdx.x, cchunks = C / 8;
    const int nch = (2 * C + R - 1) / R;  // weight chunks
    const long long ntiles = (M + TM - 1) / TM;

    // rows [r0, r0 + n) of [Wa; Wi] (row o is Wa[o] or Wi[o - C]) into dst
    auto load_w = [&](int r0, int n, bf16* dst) {
        load_core_rows(dst, n, cchunks, [&](int r) {
            const int o = r0 + r;
            return o < C ? wa + (size_t)o * C : wi + (size_t)(o - C) * C;
        }, wa);
        cp_async_commit();
    };
    // a tile of x; rows past M are zero-filled, not read
    auto load_x = [&](long long t, bf16* dst) {
        const long long m0 = t * TM;
        const int rows = (int)min((long long)TM, M - m0);
        load_core_rows(dst, TM, cchunks,
                       [&](int r) { return r < rows ? x + (m0 + r) * C : (const bf16*)nullptr; },
                       x);
        cp_async_commit();
    };
    for (int c = tid; c < C; c += MMA_THREADS) sG[c] = to_f32(lw[c]), sG[C + c] = to_f32(lb[c]);

    if (XRES) {
        // ---- one token tile, the CTA's share [j0, j1) of the weight chunks
        const int groups = (int)(gridDim.x / ntiles), span = (nch + groups - 1) / groups;
        const long long t = blockIdx.x / groups;
        const int j0 = (int)(blockIdx.x % groups) * span, j1 = min(j0 + span, nch);
        const long long m0 = t * TM;
        const int rows = (int)min((long long)TM, M - m0);
        load_x(t, sX);
        load_w(j0 * R, min(R, 2 * C - j0 * R), sW);
        cp_async_wait<1>();
        __syncthreads();
        front_ln<W>(sX, sG, C, eps);
        for (int j = j0; j < j1; ++j) {
            // the next chunk lands while this one multiplies (its slot's
            // wgmma reads ended before the last chunk's epilogue barrier)
            if (j + 1 < j1)
                load_w((j + 1) * R, min(R, 2 * C - (j + 1) * R), sW + ((j + 1 - j0) & 1) * R * C);
            else
                cp_async_commit();
            cp_async_wait<1>();
            fence_proxy_async_smem();
            __syncthreads();  // also: the last pass's stores have read sO
            front_pass<W, NW>(sX, sW + ((j - j0) & 1) * R * C, sO, min(R, 2 * C - j * R), j * R,
                              m0, rows, C, ba, bi, a_out, h_out);
        }
    } else {
        // ---- one chunk of weight rows, resident; the CTA walks token tiles
        const int groups = gridDim.x / nch;
        const int c0 = (blockIdx.x % nch) * R, cw = min(R, 2 * C - c0);  // columns [c0, c0 + cw)
        load_w(c0, cw, sW);
        long long t = blockIdx.x / nch;
        if (t < ntiles) load_x(t, sX);
        for (int buf = 0; t < ntiles; t += groups, buf ^= 1) {
            bf16* sA = sX + buf * TM * C;
            // the next tile's x lands while this one multiplies (the wgmma
            // reads of its buffer ended before the last tile's epilogue)
            if (t + groups < ntiles)
                load_x(t + groups, sX + (buf ^ 1) * TM * C);
            else
                cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();
            front_ln<W>(sA, sG, C, eps);
            __syncthreads();
            const long long m0 = t * TM;
            const int rows = (int)min((long long)TM, M - m0);
            for (int p0 = 0; p0 < cw; p0 += pass) {
                if (p0) __syncthreads();  // the last pass's stores have read sO
                front_pass<W, NW>(sA, sW + p0 * C, sO, min(pass, cw - p0), c0 + p0, m0, rows, C,
                                  ba, bi, a_out, h_out);
            }
        }
    }
    cp_async_wait<0>();
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

template <int TM>
int front_launch(const void* x, const void* lw, const void* lb, const void* wa,
                 const void* ba, const void* wi, const void* bi, void* a_out,
                 void* h_out, long long M, int C, float eps, cudaStream_t st) {
    dim3 grid;
    size_t bytes;
    auto kern = front_kernel<float, TM>;
    const int e = launch_cfg(kern, M, TM, C, st, grid, bytes);
    if (e) return e;
    kern<<<grid, THREADS, bytes, st>>>(
        (const float*)x, (const float*)lw, (const float*)lb, (const float*)wa, (const float*)ba,
        (const float*)wi, (const float*)bi, (float*)a_out, (float*)h_out, M, C, eps);
    return (int)cudaGetLastError();
}

template <int W, int NW, int XRES, int PER_SM>
int front_mma_launch(const void* x, const void* lw, const void* lb, const void* wa,
                     const void* ba, const void* wi, const void* bi, void* a_out, void* h_out,
                     long long M, int C, int R, float eps, size_t bytes, long long grid,
                     cudaStream_t st) {
    auto kern = front_mma_kernel<W, NW, XRES, PER_SM>;
    const int e = set_smem(kern, bytes);
    if (e) return e;
    kern<<<(unsigned)grid, MMA_THREADS, bytes, st>>>(
        (const bf16*)x, (const bf16*)lw, (const bf16*)lb, (const bf16*)wa, (const bf16*)ba,
        (const bf16*)wi, (const bf16*)bi, (bf16*)a_out, (bf16*)h_out, M, C, R, eps);
    return (int)cudaGetLastError();
}

template <int TM>
int tail_launch(const void* h, const void* a, const void* s, const void* wo, const void* bo,
                const void* lw, const void* lb, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, long long M, int C, int Hd, float eps,
                cudaStream_t st) {
    dim3 grid;
    size_t bytes;
    auto kern = tail_kernel<float, TM>;
    const int e = launch_cfg(kern, M, TM, 2 * C + Hd, st, grid, bytes);
    if (e) return e;
    kern<<<grid, THREADS, bytes, st>>>(
        (const float*)h, (const float*)a, (const float*)s, (const float*)wo, (const float*)bo,
        (const float*)lw, (const float*)lb, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (float*)out, M, C, Hd, eps);
    return (int)cudaGetLastError();
}

template <int MT, int NT, int NZ, int RING>
int tail_mma_launch(const void* h, const void* a, const void* s, const void* wo, const void* bo,
                    const void* lw, const void* lb, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, long long M, int C, int Hd,
                    float eps, size_t bytes, long long grid, cudaStream_t st) {
    auto kern = tail_mma_kernel<MT, NT, NZ, RING>;
    const int e = set_smem(kern, bytes);
    if (e) return e;
    kern<<<(unsigned)grid, MMA_THREADS, bytes, st>>>(
        (const bf16*)h, (const bf16*)a, (const bf16*)s, (const bf16*)wo, (const bf16*)bo,
        (const bf16*)lw, (const bf16*)lb, (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
        (const bf16*)b2, (bf16*)out, M, C, Hd, eps);
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
// a_out, h_out: (M, C). All contiguous, all of one dtype. The launch (tokens
// per CTA, output columns per CTA, shared-memory bytes, grid) comes from
// mlagg_unet_torch/ops/mlla_fused.py::front_launch_plan and is checked here:
// bf16 launches front_mma_kernel (C a multiple of 32 up to 768, 16-byte
// aligned token rows and weights; weights resident: a whole number of CTAs
// per weight chunk, no more per chunk than token tiles; x resident: a whole
// number of groups of chunks per tile, none empty), fp32 front_kernel
// (col_chunk all 2 C columns, one CTA per token tile).
extern "C" int mlagg_mlla_front(const void* x, const void* lw, const void* lb,
                                const void* wa, const void* ba, const void* wi,
                                const void* bi, void* a_out, void* h_out,
                                long long M, int C, float eps, int dtype,
                                int tokens_per_cta, int col_chunk, long long smem_bytes,
                                long long grid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (M < 1 || C < 1 || tokens_per_cta < 1 || col_chunk < 1 || grid < 1 || grid > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const long long tiles = (M + tokens_per_cta - 1) / tokens_per_cta;
    if (dtype == MLAGG_BF16) {
        const FrontShape sh = front_mma_shape(C);
        if (!sh.nw || tokens_per_cta != FRONT_TM || col_chunk != sh.rows ||
            smem_bytes != (long long)front_mma_smem_bytes(C, sh.rows, sh.nw, sh.xres))
            return (int)cudaErrorInvalidValue;
        const int nch = (2 * C + sh.rows - 1) / sh.rows;
        if (sh.xres) {  // tiles x groups, every group a non-empty share of the chunks
            const long long groups = grid / tiles, span = (nch + groups - 1) / groups;
            if (grid % tiles || groups > nch || (groups - 1) * span >= nch)
                return (int)cudaErrorInvalidValue;
        } else if (grid % nch || grid / nch > tiles) {  // chunks x CTAs walking tiles
            return (int)cudaErrorInvalidValue;
        }
        const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
        if (!aligned(x) || !aligned(wa) || !aligned(wi) || !aligned(a_out) || !aligned(h_out))
            return (int)cudaErrorMisalignedAddress;
#define X(W, NW, R, XRES, PER_SM)                                                               \
    if (C <= W)                                                                                 \
        return front_mma_launch<W, NW, XRES, PER_SM>(x, lw, lb, wa, ba, wi, bi, a_out, h_out, M, \
                                                     C, sh.rows, eps, (size_t)smem_bytes, grid, \
                                                     st);
        MLAGG_FRONT_SHAPES(X)
#undef X
        return (int)cudaErrorInvalidValue;
    }
    const int tm = pick_tm(C);
    const size_t bytes = ((size_t)WARPS * tm * C + BO * WLD) * sizeof(float);
    if (dtype != MLAGG_F32 || tokens_per_cta != WARPS * tm || col_chunk != 2 * C ||
        smem_bytes != (long long)bytes || grid != tiles)
        return (int)cudaErrorInvalidValue;
#define CALL(TM) front_launch<TM>(x, lw, lb, wa, ba, wi, bi, a_out, h_out, M, C, eps, st)
    MLAGG_DISPATCH_TM(tm, CALL)
#undef CALL
}

// h, a, s, out: (M, C); wo: (C, C); w1: (Hd, C); w2: (C, Hd), all (out, in);
// biases and ln weight/bias 1-D. All contiguous, all of one dtype. The launch
// (tokens per CTA, hidden chunk, shared-memory bytes, grid) comes from
// mlagg_unet_torch/ops/mlla_fused.py::tail_launch_plan and is checked here:
// bf16 launches tail_mma_kernel (C a multiple of 32 up to 768, Hd a multiple
// of 32, 16-byte aligned token rows and weights), fp32 tail_kernel.
extern "C" int mlagg_mlla_tail(const void* h, const void* a, const void* s,
                               const void* wo, const void* bo, const void* lw,
                               const void* lb, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               long long M, int C, int Hd, float eps, int dtype,
                               int tokens_per_cta, int hidden_chunk, long long smem_bytes,
                               long long grid, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (M < 1 || C < 1 || Hd < 1 || tokens_per_cta < 1 || grid != (M + tokens_per_cta - 1) / tokens_per_cta ||
        grid > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (dtype == MLAGG_BF16) {
        const TailShape sh = tail_mma_shape(C);
        const int tm = 32 * sh.mt, hc = 32 * sh.nz;
        if (!sh.mt || Hd % 32 || tokens_per_cta != tm || hidden_chunk != hc ||
            smem_bytes != (long long)tail_mma_smem_bytes(tm, C, hc, sh.ring))
            return (int)cudaErrorInvalidValue;
        const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
        if (!aligned(h) || !aligned(a) || !aligned(s) || !aligned(out) || !aligned(wo) ||
            !aligned(w1) || !aligned(w2))
            return (int)cudaErrorMisalignedAddress;
#define X(W, MT, NZ, RING)                                                                \
    if (C <= W)                                                                           \
        return tail_mma_launch<MT, W / 32, NZ, RING>(h, a, s, wo, bo, lw, lb, w1, b1, w2, b2, \
                                                     out, M, C, Hd, eps, (size_t)smem_bytes,  \
                                                     grid, st);
        MLAGG_TAIL_SHAPES(X)
#undef X
        return (int)cudaErrorInvalidValue;
    }
    const int tm = pick_tm(2 * C + Hd);
    const size_t bytes = ((size_t)WARPS * tm * (2 * C + Hd) + BO * WLD) * sizeof(float);
    if (tokens_per_cta != WARPS * tm || hidden_chunk != Hd || smem_bytes != (long long)bytes)
        return (int)cudaErrorInvalidValue;
#define CALL(TM) tail_launch<TM>(h, a, s, wo, bo, lw, lb, w1, b1, w2, b2, out, M, C, Hd, eps, st)
    MLAGG_DISPATCH_TM(tm, CALL)
#undef CALL
}
