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
// What bounds it on the H100: at the training shapes (rows = 10 * 2,
// d = 96, n = 16, L = 19040) it moves ~0.52 GB (u, delta, B, C, gy, the
// saved states in; du, ddelta, dB, dC out), 0.16 ms at 3.35 TB/s, and its
// ~15 fp32 operations and 2 exp per (row, d, n, t) are of the same order.
// Like K1 it walks L sequentially, so the design is bound by latency.
//
// What the design does about it: the geometry is K1's (selective_scan_common
// .cuh): a CTA holds 8 channels x 16 states, one thread each, and walks the
// LT-step tiles from the scan's end (a forward scan's tiles last to first, a
// reverse scan's first to last). Per tile it stages u, delta (with bias,
// softplus and sigmoid(pre) computed once), gy, B and C in shared memory,
// recomputes the tile's h from the entry state K1 saved, keeping every
// step's h in shared memory (one row per thread: no bank conflicts), then
// runs the adjoint back through the tile with (g, a) carried in registers
// across tiles. Sums over the 16 states are __shfl_xor_sync reductions.
// dB and dC sum over the channels: the two channels of a warp by one
// shuffle, the 4 warps by shared-memory atomics into a per-tile row, and the
// 12 CTAs that split d = 96 by writing per-CTA partials that the wrapper
// sums. Partials, not global atomics: the sum is then deterministic, like the
// JAX kernel's `dB_c` (selective_scan_pallas.py:1053, :1078), for 2 x 0.29 GB
// of extra fp32 traffic at the training shapes. dA, dD and dbias are summed
// over L in registers and written per row; the wrapper sums the batch.
#include "common.cuh"
#include "selective_scan_common.cuh"

namespace {

using namespace scan;

// shared memory, in floats: 7 per-channel tile rows, B and C tile rows, one
// h row per step, and the dB / dC tile rows (16 states padded to 17)
constexpr int NP = N + 1;
constexpr int SMEM_FLOATS = 7 * DC * LP + 2 * N * LP + LT * THREADS + 2 * LT * NP;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ delta_bias,
                const float* __restrict__ gy, const float* __restrict__ states,
                T* __restrict__ du, T* __restrict__ ddelta,
                float* __restrict__ dA_part, float* __restrict__ dB_part,
                float* __restrict__ dC_part, float* __restrict__ dD_part,
                float* __restrict__ dbias_part, int G, int Dd, long long L,
                int softplus, int reverse) {
    extern __shared__ float smem[];
    float(*s_dt)[LP] = reinterpret_cast<float(*)[LP]>(smem);
    float(*s_dtu)[LP] = s_dt + DC;     // delta * u
    float(*s_u)[LP] = s_dtu + DC;
    float(*s_gy)[LP] = s_u + DC;
    float(*s_sig)[LP] = s_gy + DC;     // d softplus / d pre, or 1
    float(*s_odu)[LP] = s_sig + DC;    // du of the tile
    float(*s_oddt)[LP] = s_odu + DC;   // ddelta of the tile
    float(*s_B)[LP] = s_oddt + DC;
    float(*s_C)[LP] = s_B + N;
    float(*s_h)[THREADS] = reinterpret_cast<float(*)[THREADS]>(s_C + N);
    float(*s_dB)[NP] = reinterpret_cast<float(*)[NP]>(s_h + LT);
    float(*s_dC)[NP] = s_dB + LT;

    const int row = blockIdx.y;  // b * G + g
    const int rows = gridDim.y;
    const int g = row % G;
    const int d0 = blockIdx.x * DC;
    const int tid = threadIdx.x;
    const int c = tid / N;
    const int n = tid % N;
    const int d = d0 + c;
    const bool d_ok = d < Dd;  // lanes of a missing channel carry zeros
    const float a_coef = d_ok ? A[((long long)g * Dd + d) * N + n] : 0.f;
    const float d_coef = (Dv && d_ok) ? Dv[(long long)g * Dd + d] : 0.f;

    const long long ud_base = (long long)row * Dd * L;
    const long long bc_base = (long long)row * N * L;
    const long long part_base = ((long long)blockIdx.x * rows + row) * N * L;
    const long long n_tiles = (L + LT - 1) / LT;

    float g_adj = 0.f;   // g at the step after this one in scan order
    float a_next = 0.f;  // a at that step
    float dA_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;

    for (long long it = n_tiles - 1; it >= 0; --it) {
        int len;
        const long long t0 = tile_bounds(it, L, reverse, &len);

        for (int i = tid; i < DC * LT; i += THREADS) {
            const int cc = i / LT, t = i % LT, dd = d0 + cc;
            float dt = 0.f, uu = 0.f, gv = 0.f, sig = 1.f;
            if (t < len && dd < Dd) {
                const long long off = ud_base + (long long)dd * L + t0 + t;
                uu = to_f32(u[off]);
                float pre = to_f32(delta[off]);
                if (delta_bias) pre += delta_bias[(long long)g * Dd + dd];
                dt = pre;
                if (softplus) {
                    dt = softplus_f(pre);
                    sig = 1.f / (1.f + expf(-pre));
                }
                gv = gy[off];
            }
            s_dt[cc][t] = dt;
            s_dtu[cc][t] = dt * uu;
            s_u[cc][t] = uu;
            s_gy[cc][t] = gv;
            s_sig[cc][t] = sig;
        }
        for (int i = tid; i < N * LT; i += THREADS) {
            const int nn = i / LT, t = i % LT;
            float bv = 0.f, cv = 0.f;
            if (t < len) {
                const long long off = bc_base + (long long)nn * L + t0 + t;
                bv = to_f32(Bm[off]);
                cv = to_f32(Cm[off]);
            }
            s_B[nn][t] = bv;
            s_C[nn][t] = cv;
        }
        for (int i = tid; i < 2 * LT * NP; i += THREADS)  // s_dB and s_dC
            reinterpret_cast<float*>(s_dB)[i] = 0.f;
        __syncthreads();

        // h through the tile in scan order, from the entry state K1 saved;
        // step k of the scan order sits at natural offset t
        const float h_entry =
            d_ok ? states[(((long long)row * n_tiles + it) * Dd + d) * N + n] : 0.f;
        float h = h_entry;
#pragma unroll 4
        for (int k = 0; k < len; ++k) {
            const int t = reverse ? len - 1 - k : k;
            h = fmaf(__expf(s_dt[c][t] * a_coef), h, s_dtu[c][t] * s_B[n][t]);
            s_h[k][tid] = h;
        }

        // the adjoint, back through the tile
#pragma unroll 4
        for (int k = len - 1; k >= 0; --k) {
            const int t = reverse ? len - 1 - k : k;
            const float dt = s_dt[c][t];
            const float a = __expf(dt * a_coef);
            const float gyv = s_gy[c][t];
            g_adj = fmaf(a_next, g_adj, gyv * s_C[n][t]);
            a_next = a;
            const float h_prev = k > 0 ? s_h[k - 1][tid] : h_entry;
            const float dda = g_adj * h_prev * a;  // d loss / d(delta A)
            dA_acc = fmaf(dda, dt, dA_acc);
            float gB = g_adj * s_B[n][t];
            float sA = dda * a_coef;
            float pB = g_adj * s_dtu[c][t];
            float pC = s_h[k][tid] * gyv;
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) {  // over the channel's 16 states
                gB += __shfl_xor_sync(0xffffffffu, gB, o);
                sA += __shfl_xor_sync(0xffffffffu, sA, o);
            }
            // over the warp's two channels, then the CTA's four warps
            pB += __shfl_xor_sync(0xffffffffu, pB, 16);
            pC += __shfl_xor_sync(0xffffffffu, pC, 16);
            if ((tid & 31) < N) {
                atomicAdd(&s_dB[t][n], pB);
                atomicAdd(&s_dC[t][n], pC);
            }
            if (n == 0) {
                const float uu = s_u[c][t];
                const float ddt = fmaf(uu, gB, sA) * s_sig[c][t];
                s_odu[c][t] = fmaf(dt, gB, d_coef * gyv);
                s_oddt[c][t] = ddt;
                dbias_acc += ddt;
                dD_acc = fmaf(gyv, uu, dD_acc);
            }
        }
        __syncthreads();

        for (int i = tid; i < DC * LT; i += THREADS) {
            const int cc = i / LT, t = i % LT, dd = d0 + cc;
            if (t < len && dd < Dd) {
                const long long off = ud_base + (long long)dd * L + t0 + t;
                du[off] = from_f32<T>(s_odu[cc][t]);
                ddelta[off] = from_f32<T>(s_oddt[cc][t]);
            }
        }
        for (int i = tid; i < N * LT; i += THREADS) {
            const int nn = i / LT, t = i % LT;
            if (t < len) {
                const long long off = part_base + (long long)nn * L + t0 + t;
                dB_part[off] = s_dB[t][nn];
                dC_part[off] = s_dC[t][nn];
            }
        }
        __syncthreads();
    }

    if (d_ok) {
        dA_part[((long long)row * Dd + d) * N + n] = dA_acc;
        if (n == 0) {
            dD_part[(long long)row * Dd + d] = dD_acc;
            dbias_part[(long long)row * Dd + d] = dbias_acc;
        }
    }
}

template <typename T>
int launch(const void* u, const void* delta, const float* A, const void* B,
           const void* C, const float* D, const float* delta_bias,
           const float* gy, const float* states, void* du, void* ddelta,
           float* dA_part, float* dB_part, float* dC_part, float* dD_part,
           float* dbias_part, int batch, int G, int Dd, long long L,
           int softplus, int reverse, cudaStream_t stream) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    // the launch gate: the shared memory this kernel asks for must fit
    if (SMEM_BYTES > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(scan_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Dd + DC - 1) / DC, batch * G);
    scan_bwd_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(delta), A,
        static_cast<const T*>(B), static_cast<const T*>(C), D, delta_bias, gy,
        states, static_cast<T*>(du), static_cast<T*>(ddelta), dA_part, dB_part,
        dC_part, dD_part, dbias_part, G, Dd, L, softplus, reverse);
    return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one CTA asks for, in bytes (the wrapper checks it against
// the device before the first launch).
extern "C" int mlagg_scan_bwd_smem_bytes() { return (int)SMEM_BYTES; }

// u, delta: (batch, G, Dd, L); A: (G, Dd, 16) fp32; B, C: (batch, G, 16, L);
// D, delta_bias: (G, Dd) fp32 or null; gy: (batch, G, Dd, L) fp32; states:
// (batch, G, ceil(L / 64), Dd, 16) fp32 from mlagg_scan_fwd with the same
// reverse flag. Outputs: du, ddelta (batch, G, Dd, L) in the operands'
// dtype; dA_part (batch, G, Dd, 16), dD_part and dbias_part (batch, G, Dd),
// dB_part and dC_part (ceil(Dd / 8), batch, G, 16, L), all fp32. All
// contiguous. dtype: MLAGG_F32 or MLAGG_BF16 for u, delta, B, C, du, ddelta.
extern "C" int mlagg_scan_bwd(const void* u, const void* delta, const float* A,
                              const void* B, const void* C, const float* D,
                              const float* delta_bias, const float* gy,
                              const float* states, void* du, void* ddelta,
                              float* dA_part, float* dB_part, float* dC_part,
                              float* dD_part, float* dbias_part, int batch,
                              int G, int Dd, int n_state, long long L,
                              int softplus, int reverse, int dtype,
                              void* stream) {
    if (n_state != scan::N) return (int)cudaErrorInvalidValue;
    if (batch * G > 65535) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == MLAGG_BF16)
        return launch<__nv_bfloat16>(u, delta, A, B, C, D, delta_bias, gy,
                                     states, du, ddelta, dA_part, dB_part,
                                     dC_part, dD_part, dbias_part, batch, G,
                                     Dd, L, softplus, reverse, s);
    return launch<float>(u, delta, A, B, C, D, delta_bias, gy, states, du,
                         ddelta, dA_part, dB_part, dC_part, dD_part,
                         dbias_part, batch, G, Dd, L, softplus, reverse, s);
}
