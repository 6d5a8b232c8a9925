// Mate rescue's anchor search: for each candidate window of a chunk, the
// longest exact diagonal match of the mate read that starts inside the
// window, one CTA a candidate.
//
// Replaces host code, not a Pallas kernel: src/repro/pe/rescue.py:49
// best_diag_seed, which both packages run in numpy for every candidate
// window of mate rescue, one window at a time (an (n, L) matrix of the
// window's diagonals, a running maximum along each and an argmax).
// Results are exact to it: a diagonal d in [0, n) of an n-byte window
// W = S[wlo, whi) compares W[d + j] with the mate's q[j] for j in [0, L);
// a base matches only when it equals the mate's and the mate's is a
// nucleotide (code < 4); bytes past the window never match (the reference
// pads it with L bytes of code 5, here the walk of diagonal d stops at
// j = n - d, which is the same).  The result is the longest run, on the
// smallest diagonal among the longest, and its first end on that diagonal
// (numpy's argmax over the row-major (n, L) matrix), as (d, j_end, len);
// (0, 0, 0) where no run reaches min_len.  The host forms the reference
// coordinate rb = wlo + d + j_end - len + 1 in int64, so the kernel holds
// no reference coordinate.
//
// What bounds it on the H100: nothing of note.  A chunk of 3,312 pairs
// has ~600 windows of ~785 bytes and mates of 151: ~70 M byte compares and
// ~0.6 MB read once, microseconds of the card against its 3.35 TB/s and
// its int32 rate, so the design is for a short, simple launch:
//
// * One CTA a candidate, THREADS threads.  The mate, then the window, are
//   staged once into dynamic shared memory (up16(L) + n bytes); the
//   wrapper sizes it to the largest candidate that fits a CTA's 227 KB
//   (less the reduction's static bytes) and a candidate larger than that
//   reads both from device memory (a grid-stride walk over its
//   diagonals, coalesced across lanes and cached in L1), so no window is
//   refused and nothing is sized by a knob.
// * Thread t owns diagonals t, t + THREADS, ...  It walks j = 0..L-1 with
//   a run length that breaks on a mismatch, and keeps its best run with a
//   strict >, so within its diagonals the smallest d and the leftmost end
//   win, as in the reference's row-major argmax.
// * A warp-shuffle reduction and one across the CTA's warps in shared
//   memory pick the largest len, then the smallest d (with that d's
//   j_end): the reference's tie order.
//
// The kernel allocates nothing; the entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Best {
    int len, d, j;
};

// (la, da) beats (lb, db): a longer run, or as long on a smaller diagonal.
__device__ __forceinline__ bool beats(int la, int da, int lb, int db) {
    return la > lb || (la == lb && da < db);
}

// This thread's diagonals of window W (n bytes) against mate Q (L bytes).
__device__ __forceinline__ Best scan(const uint8_t* W, const uint8_t* Q,
                                     int n, int L) {
    Best b{0, 0, 0};
    for (int d = threadIdx.x; d < n; d += THREADS) {
        const int jmax = min(L, n - d);
        int run = 0;
        for (int j = 0; j < jmax; ++j) {
            const uint8_t q = Q[j];
            run = (W[d + j] == q && q < 4) ? run + 1 : 0;
            if (run > b.len) b = Best{run, d, j};
        }
    }
    return b;
}

__global__ void __launch_bounds__(THREADS)
diagseed_kernel(const uint8_t* __restrict__ win,
                const int64_t* __restrict__ woff,
                const int32_t* __restrict__ wlen,
                const uint8_t* __restrict__ mates,
                const int64_t* __restrict__ moff,
                const int32_t* __restrict__ mlen, int min_len, int smem,
                int32_t* __restrict__ out) {
    extern __shared__ uint8_t stage[];
    __shared__ int red[3][WARPS];
    const int c = blockIdx.x;
    const int n = wlen[c], L = mlen[c];
    const uint8_t* gw = win + woff[c];
    const uint8_t* gq = mates + moff[c];
    const int lq = (L + 15) / 16 * 16;
    Best b;
    if (lq + n <= smem) {            // uniform across the CTA
        uint8_t* sq = stage;
        uint8_t* sw = stage + lq;
        for (int i = threadIdx.x; i < L; i += THREADS) sq[i] = gq[i];
        for (int i = threadIdx.x; i < n; i += THREADS) sw[i] = gw[i];
        __syncthreads();
        b = scan(sw, sq, n, L);
    } else {
        b = scan(gw, gq, n, L);
    }
    for (int off = 16; off > 0; off >>= 1) {
        const int l = __shfl_down_sync(FULL, b.len, off);
        const int d = __shfl_down_sync(FULL, b.d, off);
        const int j = __shfl_down_sync(FULL, b.j, off);
        if (beats(l, d, b.len, b.d)) b = Best{l, d, j};
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[0][warp] = b.len;
        red[1][warp] = b.d;
        red[2][warp] = b.j;
    }
    __syncthreads();
    if (warp != 0) return;
    b = lane < WARPS ? Best{red[0][lane], red[1][lane], red[2][lane]}
                     : Best{0, 0, 0};
    for (int off = 16; off > 0; off >>= 1) {
        const int l = __shfl_down_sync(FULL, b.len, off);
        const int d = __shfl_down_sync(FULL, b.d, off);
        const int j = __shfl_down_sync(FULL, b.j, off);
        if (beats(l, d, b.len, b.d)) b = Best{l, d, j};
    }
    if (lane == 0) {
        const bool hit = b.len >= min_len;
        out[3 * c] = hit ? b.d : 0;
        out[3 * c + 1] = hit ? b.j : 0;
        out[3 * c + 2] = hit ? b.len : 0;
    }
}

}  // namespace

// count candidates: windows at win + woff[c] (wlen[c] bytes), mates at
// mates + moff[c] (mlen[c] bytes); smem bytes of dynamic shared memory a
// CTA; out (count, 3) int32 (d, j_end, len).
extern "C" int diagseed(const void* win, const void* woff, const void* wlen,
                        const void* mates, const void* moff,
                        const void* mlen, int count, int min_len, int smem,
                        void* out, void* stream) {
    if (count == 0) return (int)cudaSuccess;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            (const void*)diagseed_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    diagseed_kernel<<<count, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const uint8_t*)win, (const int64_t*)woff, (const int32_t*)wlen,
        (const uint8_t*)mates, (const int64_t*)moff, (const int32_t*)mlen,
        min_len, smem, (int32_t*)out);
    return (int)cudaGetLastError();
}

// Load the kernel now (see fmocc_load in fmocc.cu).
extern "C" int diagseed_load() {
    cudaFuncAttributes a;
    return (int)cudaFuncGetAttributes(&a, (const void*)diagseed_kernel);
}
