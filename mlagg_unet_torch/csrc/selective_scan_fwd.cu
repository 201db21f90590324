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
// tile from them. With `states` null (serving) nothing else changes.
//
// What bounds it on the H100: at the flagship shapes (rows = 16 * 2,
// d = 96, n = 16, L = 19040, bf16 in) it moves ~0.5 GB (u, delta, B, C in,
// fp32 y out) and evaluates 9.4e8 exp on the SFU, so both bounds are a
// fraction of a millisecond. The
// recurrence over l is sequential, so this design is bound by latency: one
// thread per (row, d, n) gives 49,152 threads, a few warps per SM, each
// walking all of L.
//
// What the design does about it: the 16 states of a channel are 16 lanes of
// one warp, so C . h is a 4-step __shfl_xor_sync reduction and y leaves from
// one lane. Tiles of LT steps of u, delta (per channel) and B, C (per state)
// are staged through shared memory with coalesced loads; softplus and
// delta * u are computed once per (d, l) while staging, so the inner step is
// one exp, two FMAs and the reduction, and the steps of a tile are unrolled so
// that the loads, exps and shuffles of later steps overlap the h chain.
// Chunked or parallel-in-L designs are later work.
#include "common.cuh"
#include "selective_scan_common.cuh"

namespace {

using namespace scan;

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ delta_bias, float* __restrict__ y,
                float* __restrict__ states, int G, int Dd, long long L,
                int softplus, int reverse) {
    __shared__ float s_dt[DC][LP];
    __shared__ float s_du[DC][LP];
    __shared__ float s_u[DC][LP];
    __shared__ float s_B[N][LP];
    __shared__ float s_C[N][LP];
    __shared__ float s_y[DC][LP];

    const int row = blockIdx.y;  // b * G + g
    const int g = row % G;
    const int d0 = blockIdx.x * DC;
    const int tid = threadIdx.x;
    const int c = tid / N;
    const int n = tid % N;
    const int d = d0 + c;
    const float a_coef = d < Dd ? A[((long long)g * Dd + d) * N + n] : 0.f;

    const long long ud_base = (long long)row * Dd * L;  // u/delta/y row base
    const long long bc_base = (long long)row * N * L;   // B/C row base
    float h = 0.f;

    const long long n_tiles = (L + LT - 1) / LT;
    for (long long it = 0; it < n_tiles; ++it) {
        int len;
        const long long t0 = tile_bounds(it, L, reverse, &len);
        if (states && d < Dd)  // h at this tile's scan-entry
            states[(((long long)row * n_tiles + it) * Dd + d) * N + n] = h;

        for (int i = tid; i < DC * LT; i += THREADS) {
            const int cc = i / LT, t = i % LT, dd = d0 + cc;
            float dt = 0.f, uu = 0.f;
            if (t < len && dd < Dd) {
                const long long off = ud_base + (long long)dd * L + t0 + t;
                uu = to_f32(u[off]);
                dt = to_f32(delta[off]);
                if (delta_bias) dt += delta_bias[(long long)g * Dd + dd];
                if (softplus) dt = softplus_f(dt);
            }
            s_dt[cc][t] = dt;
            s_du[cc][t] = dt * uu;
            s_u[cc][t] = uu;
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
        __syncthreads();

#pragma unroll 4
        for (int k = 0; k < len; ++k) {
            const int t = reverse ? len - 1 - k : k;
            const float dA = __expf(s_dt[c][t] * a_coef);
            h = fmaf(dA, h, s_du[c][t] * s_B[n][t]);
            float p = h * s_C[n][t];
            p += __shfl_xor_sync(0xffffffffu, p, 8);
            p += __shfl_xor_sync(0xffffffffu, p, 4);
            p += __shfl_xor_sync(0xffffffffu, p, 2);
            p += __shfl_xor_sync(0xffffffffu, p, 1);
            if (n == 0) s_y[c][t] = p;
        }
        __syncthreads();

        for (int i = tid; i < DC * LT; i += THREADS) {
            const int cc = i / LT, t = i % LT, dd = d0 + cc;
            if (t < len && dd < Dd) {
                float v = s_y[cc][t];
                if (Dv) v += Dv[(long long)g * Dd + dd] * s_u[cc][t];
                y[ud_base + (long long)dd * L + t0 + t] = v;
            }
        }
        __syncthreads();
    }
}

template <typename T>
int launch(const void* u, const void* delta, const float* A, const void* B,
           const void* C, const float* D, const float* delta_bias, float* y,
           float* states, int batch, int G, int Dd, long long L, int softplus,
           int reverse, cudaStream_t stream) {
    const dim3 grid((Dd + DC - 1) / DC, batch * G);
    scan_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(delta), A,
        static_cast<const T*>(B), static_cast<const T*>(C), D, delta_bias, y,
        states, G, Dd, L, softplus, reverse);
    return (int)cudaGetLastError();
}

}  // namespace

// u, delta: (batch, G, Dd, L); A: (G, Dd, 16) fp32; B, C: (batch, G, 16, L);
// D, delta_bias: (G, Dd) fp32 or null; y: (batch, G, Dd, L) fp32; states:
// (batch, G, ceil(L / 64), Dd, 16) fp32 or null. All contiguous. dtype:
// MLAGG_F32 or MLAGG_BF16 for u, delta, B, C.
extern "C" int mlagg_scan_fwd(const void* u, const void* delta, const float* A,
                              const void* B, const void* C, const float* D,
                              const float* delta_bias, float* y, float* states,
                              int batch, int G, int Dd, int n_state,
                              long long L, int softplus, int reverse,
                              int dtype, void* stream) {
    if (n_state != scan::N) return (int)cudaErrorInvalidValue;
    if (batch * G > 65535) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == MLAGG_BF16)
        return launch<__nv_bfloat16>(u, delta, A, B, C, D, delta_bias, y,
                                     states, batch, G, Dd, L, softplus,
                                     reverse, s);
    return launch<float>(u, delta, A, B, C, D, delta_bias, y, states, batch, G,
                         Dd, L, softplus, reverse, s);
}
