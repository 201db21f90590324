// Selective scan (Mamba S6) backward: K5 of the port.
//
// Replaces the Pallas kernels mlagg_unet_tpu/ops/selective_scan_pallas.py
// `_bwd_kernel_v2` and `_bwd_kernel` (both launched by `_pallas_backward`).
// The forward (K1, selective_scan_fwd.cu) is, per row (b, g), channel d and
// state n, with a_t = exp(delta_t * A[g, d, n]):
//     h_t = a_t h_{t-1} + delta_t u_t B_t[n],   y_t = sum_n C_t[n] h_t + D u_t
// (a reverse scan runs t from L-1 down, h_{t+1} in place of h_{t-1}). Its
// adjoint is the reversed recurrence
//     g_t = gy_t C_t[n] + a_{t+1} g_{t+1}
// and the gradients are
//     du_t     = delta_t sum_n g_t B_t[n] + D gy_t
//     ddelta_t = (u_t sum_n g_t B_t[n] + sum_n g_t h_{t-1} a_t A)
//                * sigmoid(delta_t + bias)                 (softplus only)
//     dB_t[n]  = sum_d g_t delta_t u_t,   dC_t[n] = sum_d h_t gy_t
//     dA       = sum_{b,t} g_t h_{t-1} a_t delta_t,   dD = sum_{b,t} gy_t u_t,
//     dbias    = sum_{b,t} ddelta_t
// with fp32 arithmetic for bf16 or fp32 operands and an fp32 gy.
//
// What bounds it on the H100: at the training shapes (rows = 10 * 2, d = 96,
// n = 16, L = 19040) one launch must move ~0.52 GB (u, delta, B, C, gy and
// K1's tile-entry states in; du, ddelta, dB, dC out): 0.156 ms at 3.35 TB/s.
// Each of its 5.85e8 (row, d, n, t) elements needs at least one exp: 0.14
// ms on the SFU alone (16 per SM per clock at 132 SMs and 1.98 GHz), less
// where a polynomial on the FP32 pipe takes some of them. So bytes bound
// it; its fp32 arithmetic (~30 operations per element) is of the same
// order as the exps at 67 TFLOP/s. A scan that walks all of L in
// one thread per (row, d, n) has under 2 CTAs of 4 warps per SM and is bound
// by latency.
//
// What the design does about it: K1's tile-entry states make the h
// recompute independent per 64-step tile; only the adjoint g is carried from
// tile to tile, and it is linear. So a row's tiles are cut into groups of
// `tiles_per_cta` consecutive tiles (the plan picks it from L, the rows and
// the SM count) and three kernels run in parallel over the groups:
//  1. scan_bwd_group_kernel, one CTA per (row, group, chunk of 32 channels),
//     reads delta, gy and C only and, per (d, n), runs the adjoint back
//     through its group with zero carry-in: X = a_s g_s at the group's first
//     step s and P = prod a_t over the group;
//  2. scan_bwd_carry_kernel walks the groups from the scan's end per
//     (row, d, n): c_last = 0, c_{j-1} = X_j + P_j c_j, the carry into each
//     group (c_j = a g at the step after it), written over X;
//  3. scan_bwd_tile_kernel, one CTA per (row, group), is the tile body
//     started from g = c_j, a_next = 1, walking its group's tiles from the
//     last and keeping its running carry in the same buffer (the thread that
//     writes an entry is the one that reads it again).
// A CTA holds 32 channels x N states (N = 16 or 1, a template parameter:
// selective_scan_common.cuh), QS = min(4, N) states per thread: at N = 16
// 4 lanes per channel (a sum over n is 3 adds and 2 shuffles) and 128
// threads; at N = 1 a lane per channel and one warp, whose 32 channels' dB
// and dC are summed by a 5-level butterfly. Phase 3's CTA walks the
// row's channels in chunks of 32 for each tile, so that it sums dB and dC
// over all d of the row in shared memory in a fixed order (warps 0-3 of
// chunk 0, then of chunk 1, ...) and writes them once, in their final dtype:
// no per-channel-block partials and no global atomics. The 8 channels of a
// warp are summed by a 3-level butterfly that leaves each lane one of the
// warp's 32 (dB, dC) values. Per tile and chunk: u and gy come by 16-byte
// cp.async, delta's softplus and sigmoid(pre) are computed once per (d, t)
// from a copy of delta that cp.async brought in during the last chunk's
// adjoint, B and C are staged transposed once per tile; a forward pass from
// K1's entry state saves h at each 8-step sub-tile's entry; then per
// sub-tile from the last, h and a_t are recomputed into registers and the
// adjoint runs back through it with no stores until its end, then one
// barrier. That is 3 exps per element (phase 1 once, phase 3 twice) on the
// SFU's 16 per SM per clock: 0.42 ms per launch at least. Phase 3 takes ~70
// KB of shared memory and 168 registers a thread, so 3 CTAs (12 warps) share
// an SM. Padding steps of a ragged tile (always the last in scan order, whose
// carry-in is 0) are staged as zeros, which leave g = 0 and contribute
// nothing; where L % 8 or a pointer's alignment forbids 16-byte copies, the
// staging goes element by element. dA, dD and dbias are per-(row, group)
// partials that the wrapper sums in a fixed order.
#include "common.cuh"
#include "mma.cuh"
#include "selective_scan_common.cuh"

namespace {

using namespace scan;

constexpr int BCH = 32;           // channels per chunk
constexpr int SUB = 8;            // steps per sub-tile of the adjoint
constexpr int NSUB = LT / SUB;
constexpr int PT = LT + 1;        // fp32 channel row of delta-derived values
constexpr int GP = LT + 4;        // fp32 gy row: 16-byte rows for cp.async
constexpr int CARRY_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// the CTA's layout at N states per channel (mirrored by scan_bwd_launch_plan)
template <int N>
struct Geo {
    static_assert(is_instance<N>, "K5 is built for N = 1 and N = 16");
    static constexpr int QS = N < 4 ? N : 4;            // states per thread
    static constexpr int LPC = N / QS;                  // lanes per channel
    static constexpr int THREADS = BCH * LPC;           // 128 at N = 16, 32 at N = 1
    static constexpr int WARPS = THREADS / 32;
    static constexpr int ACCP = 2 * N + 1;              // a step's dB and dC sums
    // phase 3: shared memory allows 3 CTAs of 128 threads at N = 16, 4 of 32
    // at N = 1
    static constexpr int TILE_CTAS_PER_SM = N == 16 ? 3 : 4;
    static constexpr int GROUP_CTAS_PER_SM = N == 16 ? 6 : 16;
};

// u row in elements: 16-byte rows for cp.async, 4 banks apart per channel
template <typename T>
constexpr int U_PITCH = sizeof(T) == 2 ? LT + 8 : LT + 4;

// shared memory of the two tiled kernels, in bytes (mirrored by
// scan_bwd_launch_plan in ops/selective_scan_cuda.py)
template <int N>
constexpr int group_smem() { return (BCH * PT + BCH * GP + LT * N) * 4; }
// the sub-tile entry states; the first entries walked (the upper half) hold
// the next chunk's raw delta once the adjoint has passed them
template <typename T, int N>
constexpr int HENT_BYTES = NSUB * Geo<N>::THREADS * Geo<N>::QS * 4 > 2 * BCH * LT * (int)sizeof(T)
                               ? NSUB * Geo<N>::THREADS * Geo<N>::QS * 4
                               : 2 * BCH * LT * (int)sizeof(T);
template <typename T, int N>
constexpr int tile_smem() {
    return HENT_BYTES<T, N> + BCH * U_PITCH<T> * (int)sizeof(T) +
           (BCH * GP + 2 * BCH * PT + 2 * LT * N + 2 * Geo<N>::WARPS * SUB * 32 +
            LT * Geo<N>::ACCP) * 4;
}

// QS fp32 values at p (16-byte aligned when QS == 4) to / from registers
template <int QS>
__device__ __forceinline__ void ld_q(const float* p, float (&v)[QS]) {
    if constexpr (QS == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
        for (int j = 0; j < QS; ++j) v[j] = p[j];
    }
}
template <int QS>
__device__ __forceinline__ void st_q(float* p, const float (&v)[QS]) {
    if constexpr (QS == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int j = 0; j < QS; ++j) p[j] = v[j];
    }
}

struct Args {
    const void* u;
    const void* delta;
    const float* A;
    const void* B;
    const void* C;
    const float* D;
    const float* bias;
    const float* gy;
    const float* states;
    void* du;
    void* ddelta;
    void* dB;
    void* dC;
    float* carry;   // (rows, groups, Dd, N): X, then the carry c
    float* prod;    // (rows, groups, Dd, N): P
    float* dA_p;    // (rows, groups, Dd, N)
    float* dD_p;    // (rows, groups, Dd)
    float* dbias_p; // (rows, groups, Dd)
    int G, Dd, n_tiles, tiles_per_cta, groups, softplus, vec;
    long long L;
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// smem index of scan-order step k of a tile: a reverse tile is staged
// right-aligned, so both directions read their padding after step len - 1
template <bool REV>
__device__ __forceinline__ int step_idx(int k) { return REV ? LT - 1 - k : k; }

// element k of 16 bytes of T, as fp32 (bf16: the high half of an fp32)
template <typename T>
__device__ __forceinline__ float elem_of(const uint4& v, int k);
template <>
__device__ __forceinline__ float elem_of<float>(const uint4& v, int k) {
    return __uint_as_float(k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w);
}
template <>
__device__ __forceinline__ float elem_of<__nv_bfloat16>(const uint4& v, int k) {
    const unsigned w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
}

// fp32 delta after bias and softplus (and sigmoid(pre) when `s_sig` is
// given) of one pre-activation value; 0 outside the tile
__device__ __forceinline__ void delta_prep(float pre, float bias, bool ok, int softplus,
                                           float* dt_out, float* sig_out) {
    float dt = 0.f, sg = 0.f;
    if (ok) {
        pre += bias;
        dt = pre;
        sg = 1.f;
        if (softplus) {
            // softplus and 1 / (1 + exp(-pre)) from one e = exp(-|pre|) in
            // (0, 1]: log1p(e) = 2 atanh(z), z = e / (2 + e) <= 1/3, by its
            // series to z^13 (the next term is < 2e-8 of the sum); ~1e-7
            // relative, against K1's log1pf
            const float e = __expf(-fabsf(pre));
            const float z = __fdividef(e, 2.f + e), z2 = z * z;
            float p = fmaf(z2, 1.f / 13.f, 1.f / 11.f);
            p = fmaf(z2, p, 1.f / 9.f);
            p = fmaf(z2, p, 1.f / 7.f);
            p = fmaf(z2, p, 1.f / 5.f);
            p = fmaf(z2, p, 1.f / 3.f);
            p = fmaf(z2, p, 1.f);
            dt = fmaxf(pre, 0.f) + 2.f * z * p;
            const float r = __fdividef(1.f, 1.f + e);
            sg = pre >= 0.f ? r : e * r;
        }
    }
    *dt_out = dt;
    if (sig_out) *sig_out = sg;
}

// delta of chunk channels [d0, d0 + BCH) over one tile -> s_dt (and s_sig),
// zero outside the tile and for missing channels. `raw` (vec only): the
// chunk's delta already staged as [BCH][LT] by stage_rows_async; else read
// from global memory, 16 bytes at a time when vec.
template <typename T, int BTHREADS>
__device__ __forceinline__ void stage_delta(const Args& a, long long ud_base, int g, int d0,
                                            long long t0, int len, int off, const T* raw,
                                            float* s_dt, float* s_sig) {
    const T* delta = static_cast<const T*>(a.delta);
    if (a.vec) {
        constexpr int EPC = 16 / sizeof(T);
        constexpr int PER_ROW = LT / EPC;
        constexpr int PER_THREAD = BCH * PER_ROW / BTHREADS;
        uint4 v[PER_THREAD];
#pragma unroll
        for (int m = 0; m < PER_THREAD; ++m) {
            const int i = threadIdx.x + m * BTHREADS;
            const int c = i / PER_ROW, idx = (i % PER_ROW) * EPC, tt = idx - off;
            const bool ok = d0 + c < a.Dd && tt >= 0 && tt < len;
            v[m] = raw ? *reinterpret_cast<const uint4*>(raw + c * LT + idx)
                       : ok ? __ldg(reinterpret_cast<const uint4*>(
                                  delta + ud_base + (long long)(d0 + c) * a.L + t0 + tt))
                            : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int m = 0; m < PER_THREAD; ++m) {
            const int i = threadIdx.x + m * BTHREADS;
            const int c = i / PER_ROW, idx = (i % PER_ROW) * EPC, tt = idx - off;
            const bool ok = d0 + c < a.Dd && tt >= 0 && tt < len;
            const float bias = (ok && a.bias) ? a.bias[(long long)g * a.Dd + d0 + c] : 0.f;
#pragma unroll
            for (int k = 0; k < EPC; ++k)
                delta_prep(elem_of<T>(v[m], k), bias, ok, a.softplus, &s_dt[c * PT + idx + k],
                           s_sig ? &s_sig[c * PT + idx + k] : nullptr);
        }
        return;
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < BCH * LT; i += BTHREADS) {
        const int c = i / LT, idx = i % LT, tt = idx - off, d = d0 + c;
        const bool ok = tt >= 0 && tt < len && d < a.Dd;
        const float pre = ok ? to_f32(delta[ud_base + (long long)d * a.L + t0 + tt]) : 0.f;
        const float bias = (ok && a.bias) ? a.bias[(long long)g * a.Dd + d] : 0.f;
        delta_prep(pre, bias, ok, a.softplus, &s_dt[c * PT + idx],
                   s_sig ? &s_sig[c * PT + idx] : nullptr);
    }
}

// rows of length `pitch` elements of type E from `src` (row r at src + r *
// stride + t0) into smem rows, tile element tt at index off + tt; zeros
// elsewhere. 16-byte cp.async when `vec` (L % 8 == 0 and 16-byte aligned
// bases: every 16-byte piece is then wholly in or out of the tile); else
// element by element.
template <int BTHREADS, typename E>
__device__ __forceinline__ void stage_rows_async(const E* src, long long stride, int nrows,
                                                 int valid_rows, long long t0, int len, int off,
                                                 E* dst, int pitch, bool vec) {
    if (vec) {
        constexpr int EPC = 16 / sizeof(E);
        constexpr int PER_ROW = LT / EPC;
        for (int i = threadIdx.x; i < nrows * PER_ROW; i += BTHREADS) {
            const int r = i / PER_ROW, idx = (i % PER_ROW) * EPC, tt = idx - off;
            const bool ok = r < valid_rows && tt >= 0 && tt < len;
            const E* p = ok ? src + r * stride + t0 + tt : src;
            cp_async16(smem_u32(dst + r * pitch + idx), p, ok);
        }
        cp_async_commit();
    } else {
        for (int i = threadIdx.x; i < nrows * LT; i += BTHREADS) {
            const int r = i / LT, idx = i % LT, tt = idx - off;
            const bool ok = r < valid_rows && tt >= 0 && tt < len;
            dst[r * pitch + idx] = ok ? src[r * stride + t0 + tt] : E(0.f);
        }
    }
}

// B or C of one tile, transposed to [idx][n] fp32 (one float4 per state
// quad and step at N = 16). When vec, a thread reads 16 bytes of one state's
// row; the N states of a piece go to N neighbouring floats.
template <typename T, int N, int BTHREADS>
__device__ __forceinline__ void stage_bc(const T* src, long long bc_base, long long L,
                                         long long t0, int len, int off, bool vec, float* dst) {
    if (vec) {
        constexpr int EPC = 16 / sizeof(T);
#pragma unroll
        for (int i = threadIdx.x; i < N * (LT / EPC); i += BTHREADS) {
            const int n = i % N, idx = (i / N) * EPC, tt = idx - off;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (tt >= 0 && tt < len)
                v = __ldg(reinterpret_cast<const uint4*>(src + bc_base + n * L + t0 + tt));
#pragma unroll
            for (int k = 0; k < EPC; ++k) dst[(idx + k) * N + n] = elem_of<T>(v, k);
        }
        return;
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < N * LT; i += BTHREADS) {
        const int n = i % N, idx = i / N, tt = idx - off;
        dst[idx * N + n] =
            (tt >= 0 && tt < len) ? to_f32(src[bc_base + n * L + t0 + tt]) : 0.f;
    }
}

// N = 16: the sums over the 8 channels of a warp of pB[0..3] (dB of the
// thread's 4 states) and pC[0..3] (dC), reduce-scattered: lane l keeps the
// sum of value slot_of(l) (0-15: dB of state n, 16-31: dC of state n - 16).
__device__ __forceinline__ float warp_channel_sum(const float (&pB)[4], const float (&pC)[4],
                                                  int lane) {
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    float w[4], x[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float send = b4 ? pB[i] : pC[i];
        w[i] = (b4 ? pC[i] : pB[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float send = b3 ? w[i] : w[i + 2];
        x[i] = (b3 ? w[i + 2] : w[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    const float send = b2 ? x[0] : x[1];
    return (b2 ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
}

// 16 bytes of T from fp32 values (4 floats, or 8 rounded to bf16)
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* v);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* v) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ int slot_of(int lane) {
    return ((lane >> 4) & 1) * 16 + 4 * (lane & 3) + 2 * ((lane >> 3) & 1) + ((lane >> 2) & 1);
}

// N = 1: the sums over the 32 channels (lanes) of a warp of pB (dB) and pC
// (dC): lanes 0-15 end with dB's, lanes 16-31 with dC's.
__device__ __forceinline__ float warp_channel_sum1(float pB, float pC, int lane) {
    const bool hi = lane & 16;
    float v = (hi ? pC : pB) + __shfl_xor_sync(0xffffffffu, hi ? pB : pC, 16);
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// Phase 1: per (row, group, chunk of 32 channels) CTA and (d, n), X = a_s g_s
// with zero carry-in and P = prod a_t over the group, into carry and prod.
template <typename T, int N, bool REV>
__global__ void __launch_bounds__(Geo<N>::THREADS, Geo<N>::GROUP_CTAS_PER_SM)
scan_bwd_group_kernel(Args a) {
    constexpr int QS = Geo<N>::QS, LPC = Geo<N>::LPC, BTHREADS = Geo<N>::THREADS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* s_gy = reinterpret_cast<float*>(smem_raw);  // [BCH][GP]
    float* s_dt = s_gy + BCH * GP;                      // [BCH][PT]
    float* s_C = s_dt + BCH * PT;                       // [LT][N]

    const int chunks = (a.Dd + BCH - 1) / BCH;
    const int d0 = (blockIdx.x % chunks) * BCH;
    const int row = blockIdx.x / chunks / a.groups, grp = blockIdx.x / chunks % a.groups;
    const int g = row % a.G;
    const int tid = threadIdx.x, cl = tid / LPC, q = tid % LPC;
    const int i_lo = grp * a.tiles_per_cta;
    const int i_hi = min(i_lo + a.tiles_per_cta, a.n_tiles);
    const long long ud_base = (long long)row * a.Dd * a.L;
    const long long bc_base = (long long)row * N * a.L;

    {
        const int d = d0 + cl;
        const bool d_ok = d < a.Dd;
        float A2[QS], gv[QS], an[QS], P[QS];
#pragma unroll
        for (int j = 0; j < QS; ++j) {
            A2[j] = d_ok ? a.A[((long long)g * a.Dd + d) * N + QS * q + j] * LOG2E : 0.f;
            gv[j] = 0.f;
            an[j] = 0.f;
            P[j] = 1.f;
        }
        for (int it = i_hi - 1; it >= i_lo; --it) {
            int len;
            const long long t0 = tile_bounds(it, a.L, REV, &len);
            const int off = REV ? LT - len : 0;
            __syncthreads();  // the last tile's readers are done
            stage_rows_async<BTHREADS>(a.gy + ud_base + (long long)d0 * a.L, a.L, BCH,
                                       a.Dd - d0, t0, len, off, s_gy, GP, a.vec);
            stage_delta<T, BTHREADS>(a, ud_base, g, d0, t0, len, off, nullptr, s_dt, nullptr);
            stage_bc<T, N, BTHREADS>(static_cast<const T*>(a.C), bc_base, a.L, t0, len, off,
                                     a.vec, s_C);
            if (a.vec) cp_async_wait<0>();
            __syncthreads();
#pragma unroll 1
            for (int s = NSUB - 1; s >= 0; --s) {
#pragma unroll
                for (int k8 = SUB - 1; k8 >= 0; --k8) {
                    const int idx = step_idx<REV>(s * SUB + k8);
                    const float dt = s_dt[cl * PT + idx];
                    const float gyv = s_gy[cl * GP + idx];
                    float cv[QS];
                    ld_q<QS>(s_C + idx * N + QS * q, cv);
#pragma unroll
                    for (int j = 0; j < QS; ++j) {
                        const float at = ex2(dt * A2[j]);
                        gv[j] = fmaf(an[j], gv[j], gyv * cv[j]);
                        an[j] = at;
                        P[j] *= at;
                    }
                }
            }
        }
        if (d_ok) {
            const long long o = (((long long)row * a.groups + grp) * a.Dd + d) * N + QS * q;
            float X[QS];
#pragma unroll
            for (int j = 0; j < QS; ++j) X[j] = an[j] * gv[j];
            st_q<QS>(a.carry + o, X);
            st_q<QS>(a.prod + o, P);
        }
    }
}

// Phase 2: per (row, d, n), the carry into each group, from the scan's end.
template <int N>
__global__ void __launch_bounds__(CARRY_THREADS)
scan_bwd_carry_kernel(float* __restrict__ carry, const float* __restrict__ prod,
                      long long rows, int groups, int Dd) {
    const long long per_row = (long long)Dd * N;
    const long long i = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
    if (i >= rows * per_row) return;
    const long long row = i / per_row, dn = i % per_row;
    const long long base = row * groups * per_row + dn;
    constexpr int BATCH = 32;  // loads in flight at once
    float c = 0.f;
    for (int j1 = groups; j1 > 0; j1 -= BATCH) {
        const int n = min(BATCH, j1);
        float x[BATCH], p[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            if (k < n) {
                const long long o = base + (long long)(j1 - 1 - k) * per_row;
                x[k] = carry[o];
                p[k] = prod[o];
            }
        }
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            if (k < n) {
                carry[base + (long long)(j1 - 1 - k) * per_row] = c;
                c = fmaf(p[k], c, x[k]);
            }
        }
    }
}

// Phase 3: the gradients, per (row, group) CTA, its tiles from the last.
template <typename T, int N, bool REV>
__global__ void __launch_bounds__(Geo<N>::THREADS, Geo<N>::TILE_CTAS_PER_SM)
scan_bwd_tile_kernel(Args a) {
    constexpr int UP = U_PITCH<T>;
    constexpr int QS = Geo<N>::QS, LPC = Geo<N>::LPC, BTHREADS = Geo<N>::THREADS;
    constexpr int WARPS = Geo<N>::WARPS, ACCP = Geo<N>::ACCP;
    constexpr int HB = HENT_BYTES<T, N>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* s_hent = reinterpret_cast<float*>(smem_raw);              // [NSUB][BTHREADS][QS]
    T* s_u = reinterpret_cast<T*>(smem_raw + HB);                    // [BCH][UP], then du
    float* s_gy = reinterpret_cast<float*>(s_u + BCH * UP);          // [BCH][GP]
    float* s_B = s_gy + BCH * GP;                                    // [LT][N]
    float* s_C = s_B + LT * N;                                       // [LT][N]
    float* s_dt = s_C + LT * N;                                      // [BCH][PT]
    float* s_sig = s_dt + BCH * PT;                                  // [BCH][PT], then ddelta
    float* s_red = s_sig + BCH * PT;                                 // [2][WARPS][SUB][32]
    float* s_acc = s_red + 2 * WARPS * SUB * 32;                     // [LT][ACCP]

    const int row = blockIdx.x / a.groups, grp = blockIdx.x % a.groups;
    const int g = row % a.G;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cl = tid / LPC, q = tid % LPC;
    const int i_lo = grp * a.tiles_per_cta;
    const int i_hi = min(i_lo + a.tiles_per_cta, a.n_tiles);
    const long long ud_base = (long long)row * a.Dd * a.L;
    const long long bc_base = (long long)row * N * a.L;
    const long long part = ((long long)row * a.groups + grp) * a.Dd;
    const T* u = static_cast<const T*>(a.u);
    // the next chunk's delta, copied while this chunk's adjoint walks its
    // first half (whose sub-tile entry states are no longer needed)
    T* s_raw = reinterpret_cast<T*>(smem_raw + HB / 2);
    bool prefetched = false;
    T* du = static_cast<T*>(a.du);
    T* ddelta = static_cast<T*>(a.ddelta);

    for (int it = i_hi - 1; it >= i_lo; --it) {
        int len;
        const long long t0 = tile_bounds(it, a.L, REV, &len);
        const int off = REV ? LT - len : 0;
        const bool first = it == i_hi - 1;  // the group's first tile walked
        __syncthreads();  // the last tile's dB / dC are written out
        stage_bc<T, N, BTHREADS>(static_cast<const T*>(a.B), bc_base, a.L, t0, len, off, a.vec,
                                 s_B);
        stage_bc<T, N, BTHREADS>(static_cast<const T*>(a.C), bc_base, a.L, t0, len, off, a.vec,
                                 s_C);
        for (int i = tid; i < LT * ACCP; i += BTHREADS) s_acc[i] = 0.f;

        for (int d0 = 0; d0 < a.Dd; d0 += BCH) {
            const int d = d0 + cl;
            const bool d_ok = d < a.Dd;
            const int valid = a.Dd - d0;
            stage_rows_async<BTHREADS>(u + ud_base + (long long)d0 * a.L, a.L, BCH, valid, t0,
                                       len, off, s_u, UP, a.vec);
            stage_rows_async<BTHREADS>(a.gy + ud_base + (long long)d0 * a.L, a.L, BCH, valid,
                                       t0, len, off, s_gy, GP, a.vec);
            if (prefetched) {  // the delta copies issued during the last chunk's adjoint
                cp_async_wait<2>();
                __syncthreads();
            }
            stage_delta<T, BTHREADS>(a, ud_base, g, d0, t0, len, off,
                                     prefetched ? s_raw : nullptr, s_dt, s_sig);
            float Araw[QS], A2[QS], h[QS], gv[QS], an[QS], dA[QS];
            const long long o = (part + d) * N + QS * q;
#pragma unroll
            for (int j = 0; j < QS; ++j) {
                Araw[j] = d_ok ? a.A[((long long)g * a.Dd + d) * N + QS * q + j] : 0.f;
                A2[j] = Araw[j] * LOG2E;
                h[j] = d_ok ? a.states[(((long long)row * a.n_tiles + it) * a.Dd + d) * N +
                                       QS * q + j]
                            : 0.f;
                gv[j] = d_ok ? a.carry[o + j] : 0.f;
                an[j] = 1.f;
                dA[j] = 0.f;
            }
            const float d_coef = (a.D && d_ok) ? a.D[(long long)g * a.Dd + d] : 0.f;
            float dD = 0.f, dbias = 0.f;
            if (a.vec) cp_async_wait<0>();
            __syncthreads();

            // h through the tile in scan order from K1's entry state; keep
            // it at each sub-tile's entry
#pragma unroll 1
            for (int s = 0; s < NSUB; ++s) {
                st_q<QS>(s_hent + (s * BTHREADS + tid) * QS, h);
#pragma unroll
                for (int k8 = 0; k8 < SUB; ++k8) {
                    const int idx = step_idx<REV>(s * SUB + k8);
                    const float dt = s_dt[cl * PT + idx];
                    const float dtu = dt * to_f32(s_u[cl * UP + idx]);
                    float bv[QS];
                    ld_q<QS>(s_B + idx * N + QS * q, bv);
#pragma unroll
                    for (int j = 0; j < QS; ++j) h[j] = fmaf(ex2(dt * A2[j]), h[j], dtu * bv[j]);
                }
            }

            // the adjoint, back through the sub-tiles
            // the chunk staged next: the next chunk of this tile, or the
            // first chunk of the next tile of the group
            const bool next_here = d0 + BCH < a.Dd;
            const bool has_next = a.vec && (next_here || it > i_lo);
            int n_len = len;
            const long long n_t0 = next_here ? t0 : tile_bounds(it - 1, a.L, REV, &n_len);
            const int n_d0 = next_here ? d0 + BCH : 0;
#pragma unroll 1
            for (int s = NSUB - 1; s >= 0; --s) {
                if (s == NSUB / 2 - 1 && has_next)  // every thread has read its entries >= NSUB / 2
                    // (a barrier per sub-tile since)
                    stage_rows_async<BTHREADS>(static_cast<const T*>(a.delta) + ud_base +
                                                   (long long)n_d0 * a.L,
                                               a.L, BCH, a.Dd - n_d0, n_t0, n_len,
                                               REV ? LT - n_len : 0, s_raw, LT, true);
                // hs[k + 1]: h after the sub-tile's step k, hs[0] its entry
                float hs[SUB + 1][QS], as[SUB][QS];
                ld_q<QS>(s_hent + (s * BTHREADS + tid) * QS, hs[0]);
#pragma unroll
                for (int k8 = 0; k8 < SUB; ++k8) {
                    const int idx = step_idx<REV>(s * SUB + k8);
                    const float dt = s_dt[cl * PT + idx];
                    const float dtu = dt * to_f32(s_u[cl * UP + idx]);
                    float bv[QS];
                    ld_q<QS>(s_B + idx * N + QS * q, bv);
#pragma unroll
                    for (int j = 0; j < QS; ++j) {
                        as[k8][j] = ex2(dt * A2[j]);
                        hs[k8 + 1][j] = fmaf(as[k8][j], hs[k8][j], dtu * bv[j]);
                    }
                }
                // the step loop keeps its results in registers (no stores,
                // so the steps' shuffles overlap): each lane's (dB, dC) slot
                // per step, and du, ddelta of the steps k = q, q + LPC, ...
                // (the LPC lanes of a channel hold the same gB, sA and so
                // the same du, ddelta, dD and dbias)
                float ys[SUB], odu[SUB / LPC], odd[SUB / LPC];
#pragma unroll
                for (int k8 = SUB - 1; k8 >= 0; --k8) {
                    const int idx = step_idx<REV>(s * SUB + k8);
                    const float dt = s_dt[cl * PT + idx];
                    const float uu = to_f32(s_u[cl * UP + idx]);
                    const float dtu = dt * uu;
                    const float gyv = s_gy[cl * GP + idx];
                    const float sgv = s_sig[cl * PT + idx];
                    float bv[QS], cv[QS];
                    ld_q<QS>(s_B + idx * N + QS * q, bv);
                    ld_q<QS>(s_C + idx * N + QS * q, cv);
                    float gB = 0.f, sA = 0.f, pB[QS], pC[QS];
#pragma unroll
                    for (int j = 0; j < QS; ++j) {
                        const float at = as[k8][j];
                        gv[j] = fmaf(an[j], gv[j], gyv * cv[j]);
                        an[j] = at;
                        const float dda = gv[j] * hs[k8][j] * at;  // d loss / d(delta A)
                        dA[j] = fmaf(dda, dt, dA[j]);
                        gB = fmaf(gv[j], bv[j], gB);
                        sA = fmaf(dda, Araw[j], sA);
                        pB[j] = gv[j] * dtu;
                        pC[j] = hs[k8 + 1][j] * gyv;
                    }
                    // over the channel's N states: its LPC lanes
#pragma unroll
                    for (int m = 1; m < LPC; m <<= 1) {
                        gB += __shfl_xor_sync(0xffffffffu, gB, m);
                        sA += __shfl_xor_sync(0xffffffffu, sA, m);
                    }
                    if constexpr (N == 16) ys[k8] = warp_channel_sum(pB, pC, lane);
                    else ys[k8] = warp_channel_sum1(pB[0], pC[0], lane);
                    const float ddt = fmaf(uu, gB, sA) * sgv;
                    const float duv = fmaf(dt, gB, d_coef * gyv);
                    if ((k8 % LPC) == q) {
                        odu[k8 / LPC] = duv;
                        odd[k8 / LPC] = ddt;
                    }
                    dbias += ddt;
                    dD = fmaf(gyv, uu, dD);
                }
                // one barrier per sub-tile: its (dB, dC) sums alternate
                // between two buffers
                float* red = s_red + (s & 1) * WARPS * SUB * 32;
#pragma unroll
                for (int k8 = 0; k8 < SUB; ++k8) red[(warp * SUB + k8) * 32 + lane] = ys[k8];
                __syncwarp();  // the channel's lanes have read u and sigmoid at these steps
#pragma unroll
                for (int r = 0; r < SUB / LPC; ++r) {
                    const int idx = step_idx<REV>(s * SUB + r * LPC + q);
                    s_u[cl * UP + idx] = from_f32<T>(odu[r]);
                    s_sig[cl * PT + idx] = odd[r];
                }
                __syncthreads();
                // dB / dC of the sub-tile's steps: the warps in order, added
                // to the tile's sums after the chunks before (N = 1: lanes 0
                // and 16 of the one warp hold dB and dC)
                for (int r = tid; r < SUB * 2 * N; r += BTHREADS) {
                    const int k8 = r / (2 * N), sl = r % (2 * N);
                    const int l = N == 16 ? sl : 16 * sl;
                    float v = red[k8 * 32 + l];
#pragma unroll
                    for (int w = 1; w < WARPS; ++w) v += red[(w * SUB + k8) * 32 + l];
                    s_acc[step_idx<REV>(s * SUB + k8) * ACCP + (N == 16 ? slot_of(l) : sl)] += v;
                }
            }

            if (d_ok) {  // carry into the next tile; dA, dD, dbias partials
                if (!first) {
                    float was[QS];
                    ld_q<QS>(a.dA_p + o, was);
#pragma unroll
                    for (int j = 0; j < QS; ++j) dA[j] = was[j] + dA[j];
                }
                st_q<QS>(a.dA_p + o, dA);
                float X[QS];
#pragma unroll
                for (int j = 0; j < QS; ++j) X[j] = an[j] * gv[j];
                st_q<QS>(a.carry + o, X);
                if (q == 0) {
                    a.dD_p[part + d] = first ? dD : a.dD_p[part + d] + dD;
                    a.dbias_p[part + d] = first ? dbias : a.dbias_p[part + d] + dbias;
                }
            }
            // du and ddelta of the chunk
            if (a.vec) {
                constexpr int EPC = 16 / sizeof(T);
                for (int i = tid; i < BCH * (LT / EPC); i += BTHREADS) {
                    const int c = i / (LT / EPC), idx = (i % (LT / EPC)) * EPC, tt = idx - off;
                    if (c >= valid || tt < 0 || tt >= len) continue;
                    const long long go = ud_base + (long long)(d0 + c) * a.L + t0 + tt;
                    *reinterpret_cast<uint4*>(du + go) =
                        *reinterpret_cast<const uint4*>(s_u + c * UP + idx);
                    *reinterpret_cast<uint4*>(ddelta + go) = pack16<T>(s_sig + c * PT + idx);
                }
            } else {
                for (int i = tid; i < BCH * LT; i += BTHREADS) {
                    const int c = i / LT, idx = i % LT, tt = idx - off;
                    if (c >= valid || tt < 0 || tt >= len) continue;
                    const long long go = ud_base + (long long)(d0 + c) * a.L + t0 + tt;
                    du[go] = s_u[c * UP + idx];
                    ddelta[go] = from_f32<T>(s_sig[c * PT + idx]);
                }
            }
            prefetched = has_next;
            __syncthreads();  // before the next chunk is staged
        }

        // dB and dC of the tile, summed over every channel of the row
        T* dB = static_cast<T*>(a.dB);
        T* dC = static_cast<T*>(a.dC);
        for (int i = tid; i < 2 * N * LT; i += BTHREADS) {
            const int sl = i / LT, idx = i % LT, tt = idx - off;
            if (tt < 0 || tt >= len) continue;
            const float v = s_acc[idx * ACCP + sl];
            const long long go = bc_base + (long long)(sl % N) * a.L + t0 + tt;
            (sl < N ? dB : dC)[go] = from_f32<T>(v);
        }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int N, bool REV>
int launch(const Args& a, long long rows, int smem_group, int smem_tile, cudaStream_t stream) {
    constexpr int BTHREADS = Geo<N>::THREADS;
    // the plan's numbers, checked again (ops/selective_scan_cuda.py)
    if (smem_group != group_smem<N>() || smem_tile != tile_smem<T, N>())
        return (int)cudaErrorInvalidValue;
    const long long grid = rows * a.groups;
    const long long group_grid = grid * ((a.Dd + BCH - 1) / BCH);
    const long long carry_grid = (rows * a.Dd * N + CARRY_THREADS - 1) / CARRY_THREADS;
    if (group_grid > 0x7fffffffLL || carry_grid > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    int e = set_smem(scan_bwd_group_kernel<T, N, REV>, smem_group);
    if (e == 0) e = set_smem(scan_bwd_tile_kernel<T, N, REV>, smem_tile);
    if (e == 0)  // room for TILE_CTAS_PER_SM tile CTAs on an SM
        e = (int)cudaFuncSetAttribute(scan_bwd_tile_kernel<T, N, REV>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      (int)cudaSharedmemCarveoutMaxShared);
    if (e != 0) return e;
    scan_bwd_group_kernel<T, N, REV><<<(unsigned)group_grid, BTHREADS, smem_group, stream>>>(a);
    scan_bwd_carry_kernel<N><<<(unsigned)carry_grid, CARRY_THREADS, 0, stream>>>(
        a.carry, a.prod, rows, a.groups, a.Dd);
    scan_bwd_tile_kernel<T, N, REV><<<(unsigned)grid, BTHREADS, smem_tile, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int N>
int launch_n(const Args& a, long long rows, int smem_group, int smem_tile, int dtype,
             int reverse, cudaStream_t s) {
    if (dtype == MLAGG_BF16)
        return reverse ? launch<__nv_bfloat16, N, true>(a, rows, smem_group, smem_tile, s)
                       : launch<__nv_bfloat16, N, false>(a, rows, smem_group, smem_tile, s);
    return reverse ? launch<float, N, true>(a, rows, smem_group, smem_tile, s)
                   : launch<float, N, false>(a, rows, smem_group, smem_tile, s);
}

}  // namespace

// u, delta: (batch, G, Dd, L); A: (G, Dd, N) fp32; B, C: (batch, G, N, L),
// N = n_state, 1 or 16; D, delta_bias: (G, Dd) fp32 or null; gy: (batch, G,
// Dd, L) fp32; states: (batch, G, ceil(L / 64), Dd, N) fp32 from
// mlagg_scan_fwd with the same reverse flag. Outputs: du, ddelta (batch, G,
// Dd, L) and dB, dC (batch, G, N, L) in the operands' dtype; dA_p (batch, G,
// groups, Dd, N), dD_p and dbias_p (batch, G, groups, Dd) fp32 partials.
// Scratch: carry and prod (batch, G, groups, Dd, N) fp32, groups =
// ceil(ceil(L / 64) /
// tiles_per_cta). All contiguous. dtype: MLAGG_F32 or MLAGG_BF16 for u,
// delta, B, C, du, ddelta, dB, dC. `vec` (16-byte staging) needs L % 8 == 0
// and 16-byte aligned u, delta, B, C, gy, du, ddelta, dB, dC. smem_group and
// smem_tile are the plan's shared memory of the two tiled kernels. The three
// kernels run in order on `stream`.
extern "C" int mlagg_scan_bwd(const void* u, const void* delta, const float* A,
                              const void* B, const void* C, const float* D,
                              const float* delta_bias, const float* gy,
                              const float* states, void* du, void* ddelta, void* dB,
                              void* dC, float* carry, float* prod, float* dA_p,
                              float* dD_p, float* dbias_p, int batch, int G, int Dd,
                              int n_state, long long L, int softplus, int reverse,
                              int dtype, int tiles_per_cta, int vec, int smem_group,
                              int smem_tile, void* stream) {
    if ((n_state != 1 && n_state != 16) || tiles_per_cta < 1 || batch < 0 || G < 1 || Dd < 1 ||
        L < 1)
        return (int)cudaErrorInvalidValue;
    if (vec) {
        const void* ptrs[] = {u, delta, B, C, gy, du, ddelta, dB, dC};
        for (const void* p : ptrs)
            if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
        if (L % 8) return (int)cudaErrorInvalidValue;
    }
    Args a;
    a.u = u; a.delta = delta; a.A = A; a.B = B; a.C = C; a.D = D; a.bias = delta_bias;
    a.gy = gy; a.states = states; a.du = du; a.ddelta = ddelta; a.dB = dB; a.dC = dC;
    a.carry = carry; a.prod = prod; a.dA_p = dA_p; a.dD_p = dD_p; a.dbias_p = dbias_p;
    a.G = G; a.Dd = Dd; a.L = L;
    a.n_tiles = (int)((L + scan::LT - 1) / scan::LT);
    a.tiles_per_cta = tiles_per_cta;
    a.groups = (a.n_tiles + tiles_per_cta - 1) / tiles_per_cta;
    a.softplus = softplus;
    a.vec = vec;
    const long long rows = (long long)batch * G;
    if (rows == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return n_state == 1 ? launch_n<1>(a, rows, smem_group, smem_tile, dtype, reverse, s)
                        : launch_n<16>(a, rows, smem_group, smem_tile, dtype, reverse, s);
}
