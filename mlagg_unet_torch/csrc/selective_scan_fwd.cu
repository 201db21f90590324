// Selective scan (Mamba S6) forward: K1 of the port.
//
// Replaces the Pallas kernels mlagg_unet_tpu/ops/selective_scan_pallas.py
// `_fwd_kernel_v2` and `_fwd_kernel` (both launched by `_pallas_forward`).
// Per row (b, g), channel d and state n:
//     delta_l = softplus(delta_l + delta_bias[g, d])          (optional)
//     h_l     = exp(delta_l * A[g, d, n]) * h_{l-1} + delta_l * u_l * B_l[n]
//     y_l     = sum_n C_l[n] * h_l[n] + D[g, d] * u_l
// with fp32 state and fp32 y. reverse=1 walks l from L-1 down to 0 and writes
// y at the natural positions.
//
// For training, `states` (fp32, (batch, G, ceil(L / LT), Dd, 16)) receives h
// at the scan-entry of every LT-step tile, tiles counted in scan order (a
// reverse scan's tile i ends at L - i * LT, and its entry is its right
// edge), as `_pallas_forward(..., with_states=True)` emits chunk start
// states. The backward kernel (selective_scan_bwd.cu) recomputes h inside a
// tile from them. With `states` null (serving) nothing else changes: the
// same kernels run on the same plan, so y is bit-equal either way.
//
// What bounds it on the H100: at the serving shape (rows = 16 * 2, d = 96,
// n = 16, L = 19040, bf16 in) one launch moves ~0.5 GB (u, delta, B, C in,
// fp32 y out; 0.15 ms at 3.35 TB/s) and needs 9.4e8 exps, one per (row, d,
// n, step): 0.14 ms on the SFU and a polynomial on the FP32 pipe together,
// beside ~6 fp32 operations per element. The recurrence is sequential in l,
// so a walk over all of L per (row, d) is bound by latency.
//
// What the design does about it: h is linear in its entry state, so a row's
// ceil(L / LT) tiles are cut into groups of `tiles_per_cta` consecutive tiles
// in scan order (the plan picks it from the rows and the SM count), and
// three kernels run:
//  1. scan_fwd_group_kernel, one CTA per (row, group, chunk of channels),
//     scans its group from a zero entry state, reading u, delta and B only,
//     and writes the end state X (per d, n) and S = sum of delta over the
//     group (per d): the group's decay is P = exp(A * S), so no running
//     product is kept and the scratch for it is 16x smaller;
//  2. scan_fwd_carry_kernel walks the groups in scan order per (row, d, n):
//     h_in[0] = 0, h_in[j + 1] = X_j + P_j h_in[j], written over X;
//  3. scan_fwd_out_kernel, one CTA per (row, group, chunk), rescans its group
//     from h_in[j], writes y (plus D u) and, when asked, each tile's entry h.
// A thread owns one channel and all its 16 states, so y = C . h is 16 FMAs in
// registers (no shuffles) and softplus(delta + bias) is computed once per
// (d, step) in each of passes 1 and 3. A CTA is 32-128 channels (one
// thread each) of one row; B and C of a tile (shared by the row's channels)
// come by 16-byte cp.async into shared memory during the previous tile and
// are transposed to fp32 [step][n], which every thread reads by broadcast. u
// and delta go from global memory to registers 16 bytes at a time (8 bf16 or
// 4 fp32 steps of one channel), one 8-step chunk ahead of its use; y leaves
// as two 16-byte stores per chunk. Where L % 8 or a pointer's alignment
// forbids 16-byte accesses, the same code loads and stores element by
// element. Each element costs one exp (ex2.approx) in each of passes 1 and 3
// beside ~4 (pass 1: 3) fp32 instructions, and each (d, step) two more SFU
// operations for softplus: at 16 per SM per clock the SFU alone needs ~0.5
// ms per launch at the serving shape, and the other instructions fill most
// of the issue slots left beside it, so moving exps onto the FP32 pipe
// does not pay (PERF.md). Pass 3 is capped at 96 registers (ptxas spills a
// few words) so that 6 CTAs of 96 threads share an SM.
#include "common.cuh"
#include "mma.cuh"
#include "selective_scan_common.cuh"

namespace {

using namespace scan;

constexpr int MAX_CH = 128;       // channels (threads) per CTA at most
// pass 3 capped at the registers of 5 CTAs of MAX_CH threads (96), so that 6
// CTAs of the serving shape's 96 channels fit an SM: 18 warps, not 15
constexpr int OUT_CTAS_PER_SM = 5;
constexpr int SUB = 8;            // steps per chunk of u / delta in registers
constexpr int CARRY_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// a raw B / C row of a tile in shared memory, in elements: a 16-byte
// multiple, 4 banks apart per row so that the transposing reads of 8 rows at
// one step do not collide
template <typename T>
constexpr int RAW_PITCH = LT + 16 / (int)sizeof(T);

// shared memory of passes 1 (B) and 3 (B and C), in bytes (mirrored by
// scan_fwd_launch_plan in ops/selective_scan_cuda.py)
template <typename T, int NM>
constexpr int fwd_smem() {
    return NM * N * RAW_PITCH<T> * (int)sizeof(T) + LT * NM * N * 4;
}

struct Args {
    const void* u;
    const void* delta;
    const float* A;
    const void* B;
    const void* C;
    const float* D;
    const float* bias;
    float* y;
    float* states;
    float* carry;  // (rows, groups, Dd, N): X, then h_in
    float* dsum;   // (rows, groups, Dd): S, the sum of delta over the group
    int G, Dd, n_tiles, tiles_per_cta, groups, chunks, width, softplus, vec;
    long long L;
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// jax.nn.softplus == max(x, 0) + log1p(exp(-|x|)); log1p(e) = 2 atanh(z) with
// z = e / (2 + e) <= 1/3, by its series to z^13 (the next term is < 2e-8 of
// the sum): ~1e-7 relative, one exp and one reciprocal on the SFU
__device__ __forceinline__ float softplus_f(float x) {
    const float e = __expf(-fabsf(x));
    const float z = __fdividef(e, 2.f + e), z2 = z * z;
    float p = fmaf(z2, 1.f / 13.f, 1.f / 11.f);
    p = fmaf(z2, p, 1.f / 9.f);
    p = fmaf(z2, p, 1.f / 7.f);
    p = fmaf(z2, p, 1.f / 5.f);
    p = fmaf(z2, p, 1.f / 3.f);
    p = fmaf(z2, p, 1.f);
    return fmaxf(x, 0.f) + 2.f * z * p;
}

// 16-byte words holding SUB elements of T
template <typename T>
constexpr int NV = SUB * (int)sizeof(T) / 16;

__device__ __forceinline__ uint32_t word_of(const uint4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// element e (compile-time) of 16 bytes of T, as fp32 (bf16: the high half of
// an fp32)
template <typename T>
__device__ __forceinline__ float elem16(const uint4& v, int e) {
    if constexpr (sizeof(T) == 2) {
        const uint32_t w = word_of(v, e >> 1);
        return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    } else {
        return __uint_as_float(word_of(v, e));
    }
}

// element e (compile-time) of SUB elements of T
template <typename T>
__device__ __forceinline__ float elem(const uint4 (&v)[NV<T>], int e) {
    constexpr int EPC = 16 / sizeof(T);
    return elem16<T>(v[e / EPC], e % EPC);
}

__device__ __forceinline__ uint32_t bits_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// the SUB elements of a row at natural positions [base, base + SUB); those
// outside [lo, hi) read as 0. vec: all inside, 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, long long base, long long lo,
                                           long long hi, bool vec, uint4 (&v)[NV<T>]) {
    if (vec) {
#pragma unroll
        for (int i = 0; i < NV<T>; ++i) v[i] = __ldg(reinterpret_cast<const uint4*>(row + base) + i);
        return;
    }
    uint32_t w[4 * NV<T>];
#pragma unroll
    for (int i = 0; i < 4 * NV<T>; ++i) w[i] = 0u;
#pragma unroll
    for (int e = 0; e < SUB; ++e) {
        const long long t = base + e;
        if (t >= lo && t < hi) {
            if constexpr (sizeof(T) == 2)
                w[e >> 1] |= bits_of(row[t]) << (16 * (e & 1));
            else
                w[e] = bits_of(row[t]);
        }
    }
#pragma unroll
    for (int i = 0; i < NV<T>; ++i) v[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// chunk j of the tile at [t0, t0 + len): the natural base of its SUB slots
// (a reverse chunk's slots end at its first step in scan order)
template <bool REV>
__device__ __forceinline__ long long chunk_base(long long t0, int len, int j) {
    return REV ? t0 + len - SUB * (j + 1) : t0 + (long long)SUB * j;
}

// B (and C) of the tile at [t0, t0 + len), raw, into s_raw [NM][N][RAW_PITCH]
// by 16-byte cp.async (vec only: len % 8 == 0 and aligned rows)
template <typename T, int NM>
__device__ __forceinline__ void copy_bc_async(const T* Bm, const T* Cm, long long L, long long t0,
                                              int len, T* s_raw) {
    constexpr int EPC = 16 / sizeof(T);
    const int per_row = len / EPC;
    for (int i = threadIdx.x; i < NM * N * per_row; i += blockDim.x) {
        const int r = i / per_row, p = i % per_row;  // r = m * N + n
        const T* src = (r < N ? Bm : Cm) + (long long)(r % N) * L + t0 + p * EPC;
        cp_async16(smem_u32(s_raw + r * RAW_PITCH<T> + p * EPC), src, true);
    }
    cp_async_commit();
}

// s_bc[k][m * N + n] = (B, C)[n] at scan step k of the tile, fp32: from s_raw
// (vec), 16 bytes a thread, or element by element from global memory
template <typename T, bool REV, int NM>
__device__ __forceinline__ void stage_bc(const T* Bm, const T* Cm, long long L, long long t0,
                                         int len, bool vec, const T* s_raw, float* s_bc) {
    if (vec) {
        constexpr int EPC = 16 / sizeof(T);
        const int per_row = len / EPC;
        for (int i = threadIdx.x; i < NM * N * per_row; i += blockDim.x) {
            const int r = i % (NM * N), p = i / (NM * N);
            const uint4 v = *reinterpret_cast<const uint4*>(s_raw + r * RAW_PITCH<T> + p * EPC);
#pragma unroll
            for (int e = 0; e < EPC; ++e) {
                const int j = p * EPC + e;
                s_bc[(REV ? len - 1 - j : j) * NM * N + r] = elem16<T>(v, e);
            }
        }
        return;
    }
    for (int i = threadIdx.x; i < NM * N * len; i += blockDim.x) {
        const int r = i % (NM * N), k = i / (NM * N);
        const long long t = REV ? t0 + len - 1 - k : t0 + k;
        s_bc[i] = to_f32((r < N ? Bm : Cm)[(long long)(r % N) * L + t]);
    }
}

// Passes 1 (OUT = false) and 3 (OUT = true): one CTA per (row, group, chunk
// of `width` channels), one thread per channel, the group's tiles in scan
// order. Pass 1 starts from h = 0 and writes X and S; pass 3 starts from the
// carry's h_in and writes y and the tile-entry states.
template <typename T, bool REV, bool OUT>
__device__ __forceinline__ void scan_fwd_body(const Args& a) {
    constexpr int NM = OUT ? 2 : 1;  // B (and C)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_raw = reinterpret_cast<T*>(smem_raw);                                  // [NM][N][RAW_PITCH]
    float* s_bc = reinterpret_cast<float*>(smem_raw + NM * N * RAW_PITCH<T> * sizeof(T));  // [LT][NM * N]
    const float4* s_bc4 = reinterpret_cast<const float4*>(s_bc);

    const long long bid = blockIdx.x;
    const int chunk = (int)(bid % a.chunks);
    const int grp = (int)(bid / a.chunks % a.groups);
    const long long row = bid / a.chunks / a.groups;
    const int g = (int)(row % a.G);
    const int d = chunk * a.width + threadIdx.x;
    const bool ok = (int)threadIdx.x < a.width && d < a.Dd;
    const int dd = ok ? d : 0;  // a thread without a channel walks channel 0 and writes nothing
    const int i_lo = grp * a.tiles_per_cta;
    const int i_hi = min(i_lo + a.tiles_per_cta, a.n_tiles);
    const long long ud = (row * a.Dd + dd) * a.L;
    const T* u = static_cast<const T*>(a.u) + ud;
    const T* dl = static_cast<const T*>(a.delta) + ud;
    const T* Bm = static_cast<const T*>(a.B) + row * N * a.L;
    const T* Cm = static_cast<const T*>(a.C) + row * N * a.L;
    const long long part = (row * a.groups + grp) * a.Dd + dd;  // (row, group, d)
    const bool vec = a.vec;

    float A2[N], h[N];
    const float4* A4 = reinterpret_cast<const float4*>(a.A + ((long long)g * a.Dd + dd) * N);
    const float4* H4 = reinterpret_cast<const float4*>(a.carry + part * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
        const float4 av = A4[q];
        const float4 hv = OUT ? H4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        A2[4 * q] = av.x * LOG2E, A2[4 * q + 1] = av.y * LOG2E;
        A2[4 * q + 2] = av.z * LOG2E, A2[4 * q + 3] = av.w * LOG2E;
        h[4 * q] = hv.x, h[4 * q + 1] = hv.y, h[4 * q + 2] = hv.z, h[4 * q + 3] = hv.w;
    }
    const float bias = a.bias ? a.bias[(long long)g * a.Dd + dd] : 0.f;
    const float dco = (OUT && a.D) ? a.D[(long long)g * a.Dd + dd] : 0.f;
    float* y = OUT ? a.y + ud : nullptr;
    float dsum = 0.f;

    int len;
    long long t0 = tile_bounds(i_lo, a.L, REV, &len);
    if (vec) copy_bc_async<T, NM>(Bm, Cm, a.L, t0, len, s_raw);
    // the chunk in registers, and the next one in flight
    uint4 cu[NV<T>], cd[NV<T>], nu[NV<T>], nd[NV<T>];
    load_chunk(u, chunk_base<REV>(t0, len, 0), t0, t0 + len, vec, nu);
    load_chunk(dl, chunk_base<REV>(t0, len, 0), t0, t0 + len, vec, nd);

    for (int it = i_lo; it < i_hi; ++it) {
        if (it > i_lo) t0 = tile_bounds(it, a.L, REV, &len);
        if (vec) cp_async_wait<0>();
        __syncthreads();  // this tile's B (C) landed; the last tile's readers of s_bc are done
        stage_bc<T, REV, NM>(Bm, Cm, a.L, t0, len, vec, s_raw, s_bc);
        __syncthreads();  // s_bc is ready, s_raw free
        int n_len = 0;
        const long long n_t0 = it + 1 < i_hi ? tile_bounds(it + 1, a.L, REV, &n_len) : 0;
        if (vec && it + 1 < i_hi) copy_bc_async<T, NM>(Bm, Cm, a.L, n_t0, n_len, s_raw);
        if (OUT && a.states && ok) {  // h at this tile's scan-entry
            float4* st = reinterpret_cast<float4*>(
                a.states + (((row * a.n_tiles + it) * a.Dd) + d) * N);
#pragma unroll
            for (int q = 0; q < N / 4; ++q)
                st[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        }

        const int nch = (len + SUB - 1) / SUB;
#pragma unroll 1
        for (int j = 0; j < nch; ++j) {
#pragma unroll
            for (int i = 0; i < NV<T>; ++i) cu[i] = nu[i], cd[i] = nd[i];
            const long long base = chunk_base<REV>(t0, len, j);
            if (j + 1 < nch) {
                const long long nb = chunk_base<REV>(t0, len, j + 1);
                load_chunk(u, nb, t0, t0 + len, vec, nu);
                load_chunk(dl, nb, t0, t0 + len, vec, nd);
            } else if (it + 1 < i_hi) {
                const long long nb = chunk_base<REV>(n_t0, n_len, 0);
                load_chunk(u, nb, n_t0, n_t0 + n_len, vec, nu);
                load_chunk(dl, nb, n_t0, n_t0 + n_len, vec, nd);
            }
            float ys[SUB];
#pragma unroll
            for (int kk = 0; kk < SUB; ++kk) {
                const int e = REV ? SUB - 1 - kk : kk;  // the step's slot in the chunk
                const int k = j * SUB + kk;               // its scan step in the tile
                ys[e] = 0.f;
                if (k < len) {
                    float dt = elem<T>(cd, e) + bias;
                    if (a.softplus) dt = softplus_f(dt);
                    const float uu = elem<T>(cu, e);
                    const float dtu = dt * uu;
                    const float4* bc = s_bc4 + k * (NM * N / 4);
                    float yq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                    for (int q = 0; q < N / 4; ++q) {
                        const float4 b4 = bc[q];
                        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            const int n = 4 * q + r;
                            h[n] = fmaf(ex2(dt * A2[n]), h[n], dtu * bv[r]);
                        }
                        if (OUT) {
                            const float4 c4 = bc[N / 4 + q];
                            yq[q] = fmaf(c4.x, h[4 * q], yq[q]);
                            yq[q] = fmaf(c4.y, h[4 * q + 1], yq[q]);
                            yq[q] = fmaf(c4.z, h[4 * q + 2], yq[q]);
                            yq[q] = fmaf(c4.w, h[4 * q + 3], yq[q]);
                        }
                    }
                    if (OUT) ys[e] = fmaf(dco, uu, (yq[0] + yq[1]) + (yq[2] + yq[3]));
                    else dsum += dt;
                }
            }
            if (OUT && ok) {
                if (vec) {
                    float4* y4 = reinterpret_cast<float4*>(y + base);
                    y4[0] = make_float4(ys[0], ys[1], ys[2], ys[3]);
                    y4[1] = make_float4(ys[4], ys[5], ys[6], ys[7]);
                } else {
#pragma unroll
                    for (int e = 0; e < SUB; ++e)
                        if (base + e >= t0 && base + e < t0 + len) y[base + e] = ys[e];
                }
            }
        }
    }
    if (!OUT && ok) {
        float4* X4 = reinterpret_cast<float4*>(a.carry + part * N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
            X4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        a.dsum[part] = dsum;
    }
}

// Pass 1: per (row, group, chunk) CTA, the group's end state from a zero
// entry state and the sum of its deltas, into carry and dsum.
template <typename T, bool REV>
__global__ void __launch_bounds__(MAX_CH) scan_fwd_group_kernel(Args a) {
    scan_fwd_body<T, REV, false>(a);
}

// Pass 2: per (row, d, n), the state entering each group, in scan order.
__global__ void __launch_bounds__(CARRY_THREADS)
scan_fwd_carry_kernel(float* __restrict__ carry, const float* __restrict__ dsum,
                      const float* __restrict__ A, long long rows, int groups, int G, int Dd) {
    const long long per_row = (long long)Dd * N;
    const long long i = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
    if (i >= rows * per_row) return;
    const long long row = i / per_row, dn = i % per_row;
    const long long d = dn / N;
    const float a2 = A[(row % G) * per_row + dn] * LOG2E;
    const long long base = row * groups * per_row + dn;
    const long long sbase = row * groups * Dd + d;
    constexpr int BATCH = 32;  // loads in flight at once
    float h = 0.f;
    for (int j0 = 0; j0 < groups; j0 += BATCH) {
        const int m = min(BATCH, groups - j0);
        float x[BATCH], s[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            if (k < m) {
                x[k] = carry[base + (j0 + k) * per_row];
                s[k] = dsum[sbase + (long long)(j0 + k) * Dd];
            }
        }
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
            if (k < m) {
                carry[base + (j0 + k) * per_row] = h;
                h = fmaf(ex2(a2 * s[k]), h, x[k]);  // P_j = exp(A S_j)
            }
        }
    }
}

// Pass 3: per (row, group, chunk) CTA, y and the tile-entry states from the
// group's true entry state.
template <typename T, bool REV>
__global__ void __launch_bounds__(MAX_CH, OUT_CTAS_PER_SM) scan_fwd_out_kernel(Args a) {
    scan_fwd_body<T, REV, true>(a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool REV>
int launch(const Args& a, long long rows, int threads, int smem_group, int smem_out,
           cudaStream_t stream) {
    // the plan's numbers, checked again (ops/selective_scan_cuda.py)
    if (smem_group != fwd_smem<T, 1>() || smem_out != fwd_smem<T, 2>())
        return (int)cudaErrorInvalidValue;
    const long long grid = rows * a.groups * a.chunks;
    const long long carry_grid = (rows * a.Dd * N + CARRY_THREADS - 1) / CARRY_THREADS;
    if (grid > 0x7fffffffLL || carry_grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    int e = set_smem(scan_fwd_group_kernel<T, REV>, smem_group);
    if (e == 0) e = set_smem(scan_fwd_out_kernel<T, REV>, smem_out);
    if (e != 0) return e;
    scan_fwd_group_kernel<T, REV><<<(unsigned)grid, threads, smem_group, stream>>>(a);
    scan_fwd_carry_kernel<<<(unsigned)carry_grid, CARRY_THREADS, 0, stream>>>(
        a.carry, a.dsum, a.A, rows, a.groups, a.G, a.Dd);
    scan_fwd_out_kernel<T, REV><<<(unsigned)grid, threads, smem_out, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, bool REV>
int occupancy(int threads, int* out) {
    cudaFuncAttributes fa;
    int e = (int)cudaFuncGetAttributes(&fa, scan_fwd_group_kernel<T, REV>);
    out[1] = fa.numRegs;
    if (e == 0)
        e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], scan_fwd_group_kernel<T, REV>,
                                                               threads, fwd_smem<T, 1>());
    if (e == 0) e = (int)cudaFuncGetAttributes(&fa, scan_fwd_out_kernel<T, REV>);
    out[3] = fa.numRegs;
    if (e == 0)
        e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], scan_fwd_out_kernel<T, REV>,
                                                               threads, fwd_smem<T, 2>());
    return e;
}

// the channels of a CTA for Dd channels: chunks of at most MAX_CH, as even as
// can be; threads: the width rounded up to whole warps
void split_channels(int Dd, int* chunks, int* width, int* threads) {
    *chunks = (Dd + MAX_CH - 1) / MAX_CH;
    *width = (Dd + *chunks - 1) / *chunks;
    *threads = (*width + 31) / 32 * 32;
}

}  // namespace

// u, delta: (batch, G, Dd, L); A: (G, Dd, 16) fp32; B, C: (batch, G, 16, L);
// D, delta_bias: (G, Dd) fp32 or null; y: (batch, G, Dd, L) fp32; states:
// (batch, G, ceil(L / 64), Dd, 16) fp32 or null. Scratch: carry (batch, G,
// groups, Dd, 16) and dsum (batch, G, groups, Dd) fp32, groups =
// ceil(ceil(L / 64) / tiles_per_cta). All contiguous. dtype: MLAGG_F32 or
// MLAGG_BF16 for u, delta, B, C. `vec` (16-byte loads and stores) needs
// L % 8 == 0 and 16-byte aligned u, delta, B, C, y. threads, smem_group and
// smem_out are the plan's CTA size and shared memory of passes 1 and 3. The
// three kernels run in order on `stream`.
extern "C" int mlagg_scan_fwd(const void* u, const void* delta, const float* A, const void* B,
                              const void* C, const float* D, const float* delta_bias, float* y,
                              float* states, float* carry, float* dsum, int batch, int G, int Dd,
                              int n_state, long long L, int softplus, int reverse, int dtype,
                              int tiles_per_cta, int vec, int threads, int smem_group,
                              int smem_out, void* stream) {
    if (n_state != scan::N || tiles_per_cta < 1 || batch < 0 || G < 1 || Dd < 1 || L < 1)
        return (int)cudaErrorInvalidValue;
    Args a;
    int want_threads;
    split_channels(Dd, &a.chunks, &a.width, &want_threads);
    if (threads != want_threads) return (int)cudaErrorInvalidValue;
    if (vec) {
        const void* ptrs[] = {u, delta, B, C, y};
        for (const void* p : ptrs)
            if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
        if (L % 8) return (int)cudaErrorInvalidValue;
    }
    a.u = u; a.delta = delta; a.A = A; a.B = B; a.C = C; a.D = D; a.bias = delta_bias;
    a.y = y; a.states = states; a.carry = carry; a.dsum = dsum;
    a.G = G; a.Dd = Dd; a.L = L;
    a.n_tiles = (int)((L + scan::LT - 1) / scan::LT);
    a.tiles_per_cta = tiles_per_cta;
    a.groups = (a.n_tiles + tiles_per_cta - 1) / tiles_per_cta;
    a.softplus = softplus;
    a.vec = vec;
    const long long rows = (long long)batch * G;
    if (rows == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == MLAGG_BF16)
        return reverse ? launch<__nv_bfloat16, true>(a, rows, threads, smem_group, smem_out, s)
                       : launch<__nv_bfloat16, false>(a, rows, threads, smem_group, smem_out, s);
    return reverse ? launch<float, true>(a, rows, threads, smem_group, smem_out, s)
                   : launch<float, false>(a, rows, threads, smem_group, smem_out, s);
}

// Resident CTAs per SM and registers per thread of passes 1 and 3 for CTAs of
// `threads` threads: out = {pass 1 CTAs, pass 1 registers, pass 3 CTAs,
// pass 3 registers} (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int mlagg_scan_fwd_occupancy(int dtype, int reverse, int threads, int* out) {
    if (dtype == MLAGG_BF16)
        return reverse ? occupancy<__nv_bfloat16, true>(threads, out)
                       : occupancy<__nv_bfloat16, false>(threads, out);
    return reverse ? occupancy<float, true>(threads, out) : occupancy<float, false>(threads, out);
}
