// The contract between the selective-scan forward (K1, selective_scan_fwd.cu)
// and backward (K5, selective_scan_bwd.cu) kernels. K1 saves h at the entry
// of every LT-step tile and K5 recomputes h inside the same tiles from them,
// so both cut a row into tiles the same way and are built for the same
// state counts: LT, tile_bounds and the instances are all the two share.
#pragma once

namespace scan {

constexpr int LT = 64;  // steps per tile; K1 saves h at every tile's entry

// The states per channel N each kernel is instantiated at: 1 and 16, the
// two the networks of the repo use. The wrapper (ops/selective_scan_cuda.py)
// zero-pads A, B and C of any other n up to 16, or runs n > 16 as passes of
// 16; the C entry points refuse any other N.
template <int N>
constexpr bool is_instance = N == 1 || N == 16;

// Bounds of tile `it` in scan order: a forward scan's tile it starts at
// it * LT; a reverse scan's ends at L - it * LT (its ragged tile is the
// leftmost). Returns the first natural position and sets the length.
__device__ __forceinline__ long long tile_bounds(long long it, long long L,
                                                 int reverse, int* len) {
    if (!reverse) {
        const long long t0 = it * LT;
        *len = (int)min((long long)LT, L - t0);
        return t0;
    }
    const long long end = L - it * LT;
    const long long t0 = end > LT ? end - LT : 0;
    *len = (int)(end - t0);
    return t0;
}

}  // namespace scan
