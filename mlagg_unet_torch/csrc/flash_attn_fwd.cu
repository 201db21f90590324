// Non-causal attention forward with online softmax: K4 of the port.
//
// Replaces the Pallas kernel mlagg_unet_tpu/ops/flash_attention.py
// `_flash_kernel` (launched by `_flash_forward`). out = softmax(q k^T * scale)
// v over (batch, heads, len, dim): fp32 scores, running max, sum and
// accumulator, the key tail masked with -1e30 as in the Pallas kernel, dk !=
// dv allowed, output in q's type. q, k and v may be strided views with a unit
// stride on the last axis, so the caller's head split needs no copy.
//
// What bounds it on the H100: on the flagship's pooled branch lk = 56, dk = 24
// and dv = 48, so a query row costs 56 * 72 MACs against 48 bytes of q in and
// 96 bytes of out: ~56 operations per byte, far below the ~295 at which the
// bf16 tensor cores, not the memory, would be the limit. The kernel is bound
// by the bytes of q and out; k and v are ~0.1 MB per call.
//
// Two kernels, chosen by the wrapper from the type alone:
//
// flash_fwd_mma_kernel (bf16 I/O). What the design does about the bytes:
// - A CTA of 4 warps owns a run of 64-row query tiles of one (b, h): it is
//   persistent over `tiles_per_cta` tiles, on a flattened 1-D grid (so b * h
//   has no 65535 limit); the wrapper sizes the grid to ~5 CTAs per SM, the
//   occupancy the flagship's instantiation is built for. Each warp owns 16
//   rows of each tile and streams its q rows with cp.async (16-byte copies
//   where the row start and stride allow it, else 4-byte copies, else plain
//   loads; the wrapper picks the width) into a ring of 3 slots, so two
//   tiles' loads are in flight while a third is computed (a double buffer
//   would leave one).
// - k and v are copied into shared memory with cp.async as bf16, once per
//   CTA when lk <= 64 (the flagship: one block of ~10 KB read from L2 once
//   for up to 6 tiles), else one 64-key block at a time per tile. Keys are
//   padded to 64, dk to a multiple of 16 and dv of 8; rows are an odd number
//   of 16-byte chunks apart, so each ldmatrix is conflict-free.
// - The key tail: where dk < dkp (the flagship: 24 < 32) the first padding
//   column carries the mask, 1 in q and 0 or -1e30 / |scale| in k, so a
//   padded key's score comes out of the product at -1e30 and no score is
//   tested; else each score of a block past lk is tested. Padded keys are
//   always computed (64 per block), never skipped: branches around the mma
//   tiles cost more than the 1/8 of the work they save at lk = 56.
// - S = Q K^T and O = P V on the tensor cores with
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32; Q and K fragments come from
//   ldmatrix, V fragments from ldmatrix.trans. The scores stay in registers
//   (16 x 64 fp32 per warp); the row max and sum are reduced within each quad
//   with shuffles; exp(s - m) (ex2.approx in the log2 domain) is rounded to
//   bf16 in registers and used as the A fragment of the P V product
//   (FlashAttention-2's register reuse); the running rescale alpha applies
//   across key blocks when lk > 64. The sum is of the fp32 p; the output is
//   divided by it at the end. (The plain twin rounds the normalised p
//   instead: both are within one bf16 rounding.)
// - The epilogue stages each warp's 16 output rows in shared memory as bf16
//   and writes the contiguous (b, h, lq, dv) rows with 16-byte stores.
// No atomics and a fixed reduction order: two runs give the same bits. On
// the flagship it moves q and out at about the rate of a PyTorch copy of the
// same strided bytes (chip_smoke.py phase 3; numbers in PERF.md).
//
// flash_fwd_fp32_kernel (fp32 I/O): the scalar kernel of the first port, kept
// for fp32 (bf16 tensor cores would break its 1e-4 agreement). One CTA of 256
// threads per 64 queries with q, k, v, scores and accumulator in fp32 shared
// memory and scalar FMAs; it is bound by issuing shared-memory loads.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per block in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
    long long b, h, l;
};

// ------------------------------------------------------------------ bf16 mma

constexpr int WARPS = 4;
constexpr int THREADS_MMA = 32 * WARPS;
constexpr int WROWS = 16;    // query rows per warp
constexpr int STAGES = 3;    // q tiles per warp in the cp.async ring
constexpr int SNT = BK / 8;  // n8 tiles of scores per key block

// Row stride, in elements, of a shared-memory tile of width d (a multiple of
// 8): an odd number of 16-byte chunks, so the 8 rows of one ldmatrix matrix
// fall in 8 distinct groups of 4 banks.
__host__ __device__ inline int row_stride(int d) { return (d / 8) % 2 ? d : d + 8; }

struct Layout {  // offsets and row strides in bf16 elements
    int ks, vs, qs, os;
    int k, v, q, o, total;
};

__host__ __device__ inline Layout layout(int dkp, int dvp) {
    Layout s;
    s.ks = s.qs = row_stride(dkp);
    s.vs = s.os = row_stride(dvp);
    s.k = 0;
    s.v = s.k + BK * s.ks;
    s.q = s.v + BK * s.vs;                       // per warp: STAGES x 16 rows
    s.o = s.q + WARPS * STAGES * WROWS * s.qs;   // per warp: 16 rows
    s.total = s.o + WARPS * WROWS * s.os;
    return s;
}

// 2^x (MUFU.EX2: ~2 ulp, denormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The chunks (r, c) of a matrix n rows by `chunks` wide that thread i0 of
// `step` visits (chunk index r * chunks + c = i0, i0 + step, ...): its first
// chunk and its stride, computed once so that no tile divides.
struct Walk {
    int r, c, dr, dc, chunks;
};

__device__ __forceinline__ Walk walk(int chunks, int i0, int step) {
    return Walk{i0 / chunks, i0 % chunks, step / chunks, step % chunks, chunks};
}

// Rows row0..row0+n-1 of a (len, d) matrix with row stride sl into dst (row
// stride ds), in chunks of copy_bytes along the walk w (chunks = d / (bytes /
// 2)), with cp.async (copy_bytes 2: plain loads); rows at or past len are
// zero-filled. Columns d.. of dst are not touched: they are set once at the
// kernel's start.
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ds, const __nv_bfloat16* src,
                                          long long sl, int row0, int n, int len,
                                          int copy_bytes, const Walk& w) {
    const int per = copy_bytes / 2;  // elements per copy
    for (int r = w.r, c = w.c; r < n;) {
        const bool ok = row0 + r < len;
        const __nv_bfloat16* from = src + (ok ? (long long)(row0 + r) * sl : 0) + c * per;
        __nv_bfloat16* to = dst + r * ds + c * per;
        if (copy_bytes == 16)
            cp_async16(smem_u32(to), from, ok);
        else if (copy_bytes == 4)
            cp_async4(smem_u32(to), from, ok);
        else
            *to = ok ? *from : __float2bfloat16_rn(0.f);
        r += w.dr;
        c += w.dc;
        if (c >= w.chunks) {
            c -= w.chunks;
            ++r;
        }
    }
}

// Zero columns d..dp of rows 0..n-1 (row stride ds).
__device__ __forceinline__ void zero_cols(__nv_bfloat16* dst, int ds, int n, int d, int dp, int i0,
                                          int step) {
    const int w = dp - d;
    for (int i = i0; i < n * w; i += step) dst[(i / w) * ds + d + i % w] = __float2bfloat16_rn(0.f);
}

// KT: most k16 steps of dk (dkp <= 16 KT); NT: most n8 tiles of dv (dvp <= 8 NT).
// The narrow instantiation (the flagship's) is held to 5 CTAs per SM (<= 102
// registers), the wide one is not held.
template <int KT, int NT>
__global__ void __launch_bounds__(THREADS_MMA, KT <= 2 ? 5 : 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                     int Lq, int Lk, int dk, int dv, int dkp, int dvp, int copy_bytes,
                     int kv_copy_bytes, int tiles_per_cta, int vec_out, Strides qstr,
                     Strides kstr, Strides vstr, float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    const Layout L = layout(dkp, dvp);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
    const int kt = dkp / 16, nt = dvp / 8, nkb = (Lk + BK - 1) / BK;

    const int tiles = (Lq + BQ - 1) / BQ;
    const int chunks = (tiles + tiles_per_cta - 1) / tiles_per_cta;
    const long long bh = blockIdx.x / chunks;
    const int t0 = (int)(blockIdx.x % chunks) * tiles_per_cta;
    const int t1 = min(t0 + tiles_per_cta, tiles);
    const int b = (int)(bh / H), h = (int)(bh % H);
    const __nv_bfloat16* qp = q + b * qstr.b + h * qstr.h;
    const __nv_bfloat16* kp = k + b * kstr.b + h * kstr.h;
    const __nv_bfloat16* vp = v + b * vstr.b + h * vstr.h;

    __nv_bfloat16* sK = smem + L.k;
    __nv_bfloat16* sV = smem + L.v;
    __nv_bfloat16* sQ = smem + L.q + warp * STAGES * WROWS * L.qs;
    __nv_bfloat16* sO = smem + L.o + warp * WROWS * L.os;

    // The key tail's mask: where dk < dkp, q's column dk is 1 and k's is 0 on
    // a key and -1e30 / |scale| past lk, so a padded key's score is -1e30 in
    // the scaled domain and exp gives 0 with no per-score test (keys read as
    // zeros elsewhere, so the real scores are the same sums). Else each
    // score is tested against lk.
    const bool bias_col = dk < dkp && scale != 0.f;
    const bool mask_keys = !bias_col && nkb * BK > Lk;
    const __nv_bfloat16 pad_bias = __float2bfloat16_rn(-copysignf(1e30f, scale) / fabsf(scale));
    // padded columns are never copied: zero them once (the bias column aside)
    zero_cols(sQ, L.qs, STAGES * WROWS, dk + bias_col, dkp, lane, 32);
    zero_cols(sK, L.ks, BK, dk + bias_col, dkp, tid, THREADS_MMA);
    zero_cols(sV, L.vs, BK, dv, dvp, tid, THREADS_MMA);
    if (bias_col)
        for (int r = lane; r < STAGES * WROWS; r += 32)
            sQ[r * L.qs + dk] = __float2bfloat16_rn(1.f);
    auto load_kv = [&](int k0) {
        const int per = kv_copy_bytes / 2;
        copy_rows(sK, L.ks, kp, kstr.l, k0, BK, Lk, kv_copy_bytes,
                  walk(dk / per, tid, THREADS_MMA));
        copy_rows(sV, L.vs, vp, vstr.l, k0, BK, Lk, kv_copy_bytes,
                  walk(dv / per, tid, THREADS_MMA));
        if (bias_col)
            for (int r = tid; r < BK; r += THREADS_MMA)
                sK[r * L.ks + dk] = k0 + r < Lk ? __float2bfloat16_rn(0.f) : pad_bias;
        cp_async_commit();
    };
    const Walk qw = walk(dk / (copy_bytes / 2), lane, 32);
    const Walk ow = walk(vec_out ? dv / 8 : dv, lane, 32);  // the epilogue's stores
    auto load_q = [&](int slot, int tile) {
        copy_rows(sQ + slot * WROWS * L.qs, L.qs, qp, qstr.l, tile * BQ + warp * WROWS, WROWS,
                  Lq, copy_bytes, qw);
    };
    // k and v (once, when they are one block), then the ring's first tiles
    if (nkb == 1) load_kv(0);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (t0 + s < t1) load_q(s, t0 + s);
        cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const float sl2 = scale * LOG2E;
    for (int t = t0, i = 0; t < t1; ++t, ++i) {
        if (t + STAGES - 1 < t1) load_q((i + STAGES - 1) % STAGES, t + STAGES - 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        __syncwarp();

        const __nv_bfloat16* cq = sQ + (i % STAGES) * WROWS * L.qs;
        uint32_t qf[KT][4];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
            if (kk < kt)
                ldsm_x4(qf[kk], smem_u32(cq + (lane & 15) * L.qs + kk * 16 + (lane >> 4) * 8));

        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

        for (int kb = 0; kb < nkb; ++kb) {
            if (nkb > 1) {
                __syncthreads();  // every warp is done with the previous block
                load_kv(kb * BK);
                cp_async_wait<0>();
                __syncthreads();
            }
            // S = Q K^T: 16 rows x 64 keys per warp
            float s[SNT][4];
#pragma unroll
            for (int n = 0; n < SNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                if (kk >= kt) continue;
#pragma unroll
                for (int np = 0; np < SNT / 2; ++np) {
                    uint32_t bf[4];
                    ldsm_x4(bf, smem_u32(sK + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * L.ks +
                                         kk * 16 + (mi & 1) * 8));
                    mma16816(s[2 * np], qf[kk], bf[0], bf[1]);
                    mma16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
                }
            }
            // scale into the log2 domain, mask the key tail (unless the
            // bias column did), online max
#pragma unroll
            for (int n = 0; n < SNT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
            if (mask_keys) {
                const int lim = Lk - kb * BK - 2 * t4;
#pragma unroll
                for (int n = 0; n < SNT; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (n * 8 + (e & 1) >= lim) s[n][e] = NEG_INF;
            }
            float mx0 = m0, mx1 = m1;
#pragma unroll
            for (int n = 0; n < SNT; ++n) {
                mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
                mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
            }
            mx0 = quad_max(mx0);
            mx1 = quad_max(mx1);
            const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
            m0 = mx0;
            m1 = mx1;
            // P = exp(S - m) in fp32 for the sum, bf16 as the A fragments
            uint32_t pf[SNT / 2][4];
            float r0 = 0.f, r1 = 0.f;
#pragma unroll
            for (int n = 0; n < SNT; ++n) {
                const float p0 = ex2(s[n][0] - m0), p1 = ex2(s[n][1] - m0);
                const float p2 = ex2(s[n][2] - m1), p3 = ex2(s[n][3] - m1);
                r0 += p0 + p1;
                r1 += p2 + p3;
                pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
                pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
            }
            l0 = l0 * a0 + r0;
            l1 = l1 * a1 + r1;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                acc[n][0] *= a0;
                acc[n][1] *= a0;
                acc[n][2] *= a1;
                acc[n][3] *= a1;
            }
            // O += P V: 4 k16 steps over the block's keys
#pragma unroll
            for (int j = 0; j < SNT / 2; ++j) {
                const int key = j * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
                for (int np = 0; np < (NT + 1) / 2; ++np) {
                    if (2 * np >= nt) continue;
                    uint32_t bf[4];
                    const uint32_t addr = smem_u32(sV + key * L.vs + np * 16 + (mi >> 1) * 8);
                    if (2 * np + 1 < nt) {
                        ldsm_x4_t(bf, addr);
                        mma16816(acc[2 * np], pf[j], bf[0], bf[1]);
                        mma16816(acc[2 * np + 1], pf[j], bf[2], bf[3]);
                    } else {
                        // lanes 16-31 point at column np * 16 + 8, ignored by .x2
                        ldsm_x2_t(bf, addr);
                        mma16816(acc[2 * np], pf[j], bf[0], bf[1]);
                    }
                }
            }
        }

        // epilogue: divide by the row sums, stage as bf16, 16-byte stores
        const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            if (n >= nt) continue;
            *reinterpret_cast<uint32_t*>(sO + g * L.os + n * 8 + 2 * t4) =
                pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
            *reinterpret_cast<uint32_t*>(sO + (g + 8) * L.os + n * 8 + 2 * t4) =
                pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
        }
        __syncwarp();
        const int row0 = t * BQ + warp * WROWS;
        __nv_bfloat16* op = o + ((long long)bh * Lq + row0) * dv;
        for (int r = ow.r, c = ow.c; r < WROWS;) {
            if (row0 + r < Lq) {
                if (vec_out)
                    *reinterpret_cast<uint4*>(op + (long long)r * dv + c * 8) =
                        *reinterpret_cast<const uint4*>(sO + r * L.os + c * 8);
                else
                    op[(long long)r * dv + c] = sO[r * L.os + c];
            }
            r += ow.dr;
            c += ow.dc;
            if (c >= ow.chunks) {
                c -= ow.chunks;
                ++r;
            }
        }
        __syncwarp();  // the staging rows and this tile's q slot are free again
    }
    cp_async_wait<0>();
}

template <int KT, int NT>
int launch_mma(const void* q, const void* k, const void* v, void* o, int H, int Lq, int Lk,
               int dk, int dv, int dkp, int dvp, int copy_bytes, int kv_copy_bytes,
               int tiles_per_cta, long long grid, Strides qs, Strides ks, Strides vs, float scale,
               cudaStream_t stream) {
    const size_t bytes = (size_t)layout(dkp, dvp).total * sizeof(__nv_bfloat16);
    const int e = set_smem(flash_fwd_mma_kernel<KT, NT>, bytes);
    if (e != 0) return e;
    const int vec_out = dv % 8 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
    flash_fwd_mma_kernel<KT, NT><<<(unsigned)grid, THREADS_MMA, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Lq, Lk, dk, dv,
        dkp, dvp, copy_bytes, kv_copy_bytes, tiles_per_cta, vec_out, qs, ks, vs, scale);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ fp32

constexpr int THREADS = 256;
constexpr int WARPS_F32 = THREADS / 32;

__host__ __device__ inline size_t smem_floats(int dk, int dv) {
    const int dkp = dk + 1;  // odd row stride: key rows hit distinct banks
    return (size_t)BQ * dkp + (size_t)BK * dkp + (size_t)BK * dv +
           (size_t)BQ * (BK + 1) + (size_t)BQ * dv + 3 * BQ;
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int H, int Lq,
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
    const int tiles = (Lq + BQ - 1) / BQ;
    const long long bh = blockIdx.x / tiles;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const int q0 = (int)(blockIdx.x % tiles) * BQ;
    const float* qp = q + b * qs.b + h * qs.h;
    const float* kp = k + b * ks.b + h * ks.h;
    const float* vp = v + b * vs.b + h * vs.h;

    for (int i = tid; i < BQ * dk; i += THREADS) {
        const int r = i / dk, c = i % dk;
        sQ[r * dkp + c] = q0 + r < Lq ? qp[(long long)(q0 + r) * qs.l + c] : 0.f;
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
            sK[r * dkp + c] = k0 + r < Lk ? kp[(long long)(k0 + r) * ks.l + c] : 0.f;
        }
        for (int i = tid; i < BK * dv; i += THREADS) {
            const int r = i / dv, c = i % dv;
            sV[i] = k0 + r < Lk ? vp[(long long)(k0 + r) * vs.l + c] : 0.f;
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

        for (int r = warp; r < BQ; r += WARPS_F32) {
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

    float* op = o + bh * Lq * dv;
    for (int i = tid; i < BQ * dv; i += THREADS) {
        const int r = i / dv, c = i % dv;
        if (q0 + r < Lq) op[(long long)(q0 + r) * dv + c] = sAcc[i] / sL[r];
    }
}

int launch_fp32(const void* q, const void* k, const void* v, void* o, int H, int Lq, int Lk,
                int dk, int dv, long long grid, Strides qs, Strides ks, Strides vs, float scale,
                cudaStream_t stream) {
    const size_t bytes = smem_floats(dk, dv) * sizeof(float);
    const int e = set_smem(flash_fwd_fp32_kernel, bytes);
    if (e != 0) return e;
    flash_fwd_fp32_kernel<<<(unsigned)grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, Lq, Lk, dk, dv, qs, ks, vs,
        scale);
    return (int)cudaGetLastError();
}

// Whether every (b, h, row) start of a (B, H, L, d) view is aligned to width.
bool aligned(const void* p, long long sb, long long sh, long long sl, int B, int H, int L, int d,
             int width) {
    const auto off = [&](long long stride, int n) { return n > 1 && stride * 2 % width; };
    return reinterpret_cast<uintptr_t>(p) % width == 0 && d * 2 % width == 0 && !off(sb, B) &&
           !off(sh, H) && !off(sl, L);
}

}  // namespace

// q: (B, H, Lq, dk), k: (B, H, Lk, dk), v: (B, H, Lk, dv), each with unit
// stride on its last axis and the given (b, h, l) strides in elements;
// o: (B, H, Lq, dv) contiguous. dk, dv <= 128. The launch plan (padded dims,
// the copy widths of q and of k and v, tiles per CTA, the 1-D grid) comes
// from the wrapper (mlagg_unet_torch/ops/flash_attention.py::launch_plan)
// and is checked here. bf16 launches flash_fwd_mma_kernel, fp32
// flash_fwd_fp32_kernel.
extern "C" int mlagg_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
    int dk, int dv, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
    long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
    float scale, int dtype, int dkp, int dvp, int copy_bytes, int kv_copy_bytes,
    int tiles_per_cta, long long grid, void* stream) {
    if (dk < 1 || dk > 128 || dv < 1 || dv > 128 || Lk < 1 || Lq < 1 || B < 1 || H < 1 ||
        tiles_per_cta < 1 || grid < 1 || grid > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const long long tiles = (Lq + BQ - 1) / BQ;
    const Strides qs{q_sb, q_sh, q_sl}, ks{k_sb, k_sh, k_sl}, vs{v_sb, v_sh, v_sl};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype != MLAGG_BF16) {
        if (grid != (long long)B * H * tiles) return (int)cudaErrorInvalidValue;
        return launch_fp32(q, k, v, o, H, Lq, Lk, dk, dv, grid, qs, ks, vs, scale, s);
    }
    const long long chunks = (tiles + tiles_per_cta - 1) / tiles_per_cta;
    const auto width_ok = [](int w) { return w == 16 || w == 4 || w == 2; };
    if (dkp < dk || dkp % 16 || dkp > 128 || dvp < dv || dvp % 8 || dvp > 128 ||
        !width_ok(copy_bytes) || !width_ok(kv_copy_bytes) || grid != (long long)B * H * chunks)
        return (int)cudaErrorInvalidValue;
    // the copies must be aligned to their width at every (b, h, row)
    if (!aligned(q, q_sb, q_sh, q_sl, B, H, Lq, dk, copy_bytes) ||
        !aligned(k, k_sb, k_sh, k_sl, B, H, Lk, dk, kv_copy_bytes) ||
        !aligned(v, v_sb, v_sh, v_sl, B, H, Lk, dv, kv_copy_bytes))
        return (int)cudaErrorMisalignedAddress;
    if (dkp <= 32 && dvp <= 48)
        return launch_mma<2, 6>(q, k, v, o, H, Lq, Lk, dk, dv, dkp, dvp, copy_bytes,
                                kv_copy_bytes, tiles_per_cta, grid, qs, ks, vs, scale, s);
    return launch_mma<8, 16>(q, k, v, o, H, Lq, Lk, dk, dv, dkp, dvp, copy_bytes,
                             kv_copy_bytes, tiles_per_cta, grid, qs, ks, vs, scale, s);
}
