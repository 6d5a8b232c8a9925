// One SMEM extension round: for every entry e of the round, the backward
// (or forward) extension of the bi-interval (k, l, s) by base c, with all
// of its FM-index occupancy lookups, in the two bucket layouts of
// core/fmindex.py.
//
// Replaces, as one kernel, what one round of repro's SMEM loop runs on the
// TPU (repro/core/smem.py:236-237 _fwd_round_j / _bwd_round_j):
//   occ_count_pallas_call        (repro/kernels/fmocc/kernel.py:86, eta=32)
//   occ_count_packed_pallas_call (repro/kernels/fmocc/kernel.py:96, eta=128)
// and the bucket gather and extension arithmetic that XLA fuses around
// them (repro/kernels/fmocc/ops.py:112 _backward_ext_impl, :154
// backward_ext_pallas).  The plain version is core/fmindex.py
// backward_ext_v / forward_ext_v with occ_opt_v (eta32) or occ_base_v
// (eta128).
//
// What bounds it on the H100: memory latency.  It is a random gather, not
// a tensor-core kernel: wgmma and TMA have no tile to work on.  Per entry
// the kernel reads k, l, s, c (16 B, coalesced) and, for each of its two
// positions k-1 and k+s-1, one bucket's 4 counts (16 B) and its 32-byte
// row, at random addresses; it writes k', l', s' (12 B).  The arithmetic
// is a few hundred integer operations.  What the design does about it:
//   * one thread an entry issues its six independent 16-byte read-only
//     loads before any arithmetic, so each thread keeps six misses in
//     flight and no shared memory caps the warps an SM holds;
//   * the count tables of the index are small enough for the 50 MB L2
//     (the eta32 table of a 4.6-Mbp genome: 290,104 buckets x 48 B =
//     13.9 MB), and nothing else runs on the card between rounds, so a
//     round finds them there;
//   * everything between the loads and the three stores stays in
//     registers: the 4 bases are counted at once from bit planes of the
//     row words, the sentinel test, the l3..l0 chain and the choice of c
//     are selects.  No intermediate reaches device memory, and a round is
//     one launch.
//
// Contract (both layouts), per entry, with positions p = k (for k-1) and
// p = k+s (for k+s-1) in [0, N]:
//   eta32:  bucket b = p>>5, r = p&31; occ(a, p-1) = counts[b][a]
//           + #{j < r : row[j] == a}  (bytes 4 = sentinel, 5 = pad never
//           equal a base);
//   eta128: b = p>>7, r = p&127; the row holds 128 2-bit codes LSB-first;
//           occ(a, p-1) = counts[b][a] + #{j < r : code[j] == a}, minus 1
//           for a = 0 when b*128 <= primary < p: the sentinel was packed
//           as code 0 (repro/kernels/fmocc/ops.py:64-68).
//   backward: cc = clamp(c, 0, 3); k' = C[cc] + occ(cc, k-1);
//           s' = c > 3 ? 0 : occ(cc, k+s-1) - occ(cc, k-1);
//           l' = l + [k <= primary < k+s] + sum over a > cc of s_a.
//   forward: the backward extension of (l, k, s) by cbar = c > 3 ? c : 3-c,
//           with k' and l' swapped back.
// `C` and `primary` are device pointers, so a launch reads nothing back.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t LSB8 = 0x01010101u;   // bit 0 of every byte
constexpr uint32_t LSB2 = 0x55555555u;   // bit 0 of every 2-bit code

// mask of the low n bytes of a 32-bit word (n <= 0: none, n >= 4: all)
__device__ __forceinline__ uint32_t low_bytes(int n) {
    if (n <= 0) return 0u;
    return n >= 4 ? 0xFFFFFFFFu : ((1u << (8 * n)) - 1u);
}

// mask of the low n 2-bit codes of a 32-bit word (n <= 0: none, n >= 16: all)
__device__ __forceinline__ uint32_t low_pairs(int n) {
    if (n <= 0) return 0u;
    return n >= 16 ? 0xFFFFFFFFu : ((1u << (2 * n)) - 1u);
}

// Adds to n the count of each base 0..3 among the lanes of `m` (bit 0 of
// every lane that is counted), given the lanes' low two bits in b0, b1
// (already masked by m).
__device__ __forceinline__ void count_planes(uint32_t m, uint32_t b0,
                                             uint32_t b1, int4& n) {
    n.x += __popc(m & ~(b0 | b1));
    n.y += __popc(b0 & ~b1);
    n.z += __popc(b1 & ~b0);
    n.w += __popc(b0 & b1);
}

struct Eta32 {
    static constexpr int SHIFT = 5;
    // occ of every base over the first r bytes of the row w
    static __device__ __forceinline__ int4 row_counts(const uint4& lo,
                                                      const uint4& hi, int r,
                                                      int, int) {
        const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        int4 n = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // bytes 0..3 have bit 2 clear; 4 (sentinel) and 5 (pad) set it
            uint32_t m = low_bytes(r - 4 * j) & LSB8 & ~(w[j] >> 2);
            count_planes(m, w[j] & m, (w[j] >> 1) & m, n);
        }
        return n;
    }
};

struct Eta128 {
    static constexpr int SHIFT = 7;
    static __device__ __forceinline__ int4 row_counts(const uint4& lo,
                                                      const uint4& hi, int r,
                                                      int p, int primary) {
        const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        int4 n = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // word j holds codes 16j .. 16j+15
            uint32_t m = low_pairs(r - 16 * j) & LSB2;
            count_planes(m, w[j] & m, (w[j] >> 1) & m, n);
        }
        // the sentinel, packed as code 0, inside the counted part [b*128, p)
        n.x -= (primary >= p - r && primary < p) ? 1 : 0;
        return n;
    }
};

__device__ __forceinline__ int pick(const int4& v, int cc) {
    return cc == 0 ? v.x : cc == 1 ? v.y : cc == 2 ? v.z : v.w;
}

template <class Layout>
__global__ void ext_round_kernel(const int32_t* __restrict__ k_in,
                                 const int32_t* __restrict__ l_in,
                                 const int32_t* __restrict__ s_in,
                                 const int32_t* __restrict__ c_in,
                                 const int4* __restrict__ counts,
                                 const uint4* __restrict__ rows,
                                 const int32_t* __restrict__ C,
                                 const int32_t* __restrict__ primary_p,
                                 int32_t* __restrict__ out, int n, int fwd) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    int k = __ldg(k_in + e), l = __ldg(l_in + e);
    const int s = __ldg(s_in + e);
    int c = __ldg(c_in + e);
    if (fwd) {
        const int t = k; k = l; l = t;
        c = c > 3 ? c : 3 - c;
    }
    const int p1 = k, p2 = k + s;                 // positions k-1, k+s-1, +1
    const int b1 = p1 >> Layout::SHIFT, b2 = p2 >> Layout::SHIFT;
    // the six independent loads, all issued before any arithmetic
    const int4 n1 = __ldg(counts + b1), n2 = __ldg(counts + b2);
    const uint4 r1lo = __ldg(rows + 2 * b1), r1hi = __ldg(rows + 2 * b1 + 1);
    const uint4 r2lo = __ldg(rows + 2 * b2), r2hi = __ldg(rows + 2 * b2 + 1);
    const int primary = __ldg(primary_p);
    const int cc = min(max(c, 0), 3);
    const int C_cc = __ldg(C + cc);

    const int mask = (1 << Layout::SHIFT) - 1;
    const int4 q1 = Layout::row_counts(r1lo, r1hi, p1 & mask, p1, primary);
    const int4 q2 = Layout::row_counts(r2lo, r2hi, p2 & mask, p2, primary);
    const int4 o1 = make_int4(n1.x + q1.x, n1.y + q1.y, n1.z + q1.z,
                              n1.w + q1.w);
    const int4 ss = make_int4(n2.x + q2.x - o1.x, n2.y + q2.y - o1.y,
                              n2.z + q2.z - o1.z, n2.w + q2.w - o1.w);
    const int sent = (k <= primary && primary < k + s) ? 1 : 0;
    const int l3 = l + sent;
    const int l2 = l3 + ss.w;
    const int l1 = l2 + ss.z;
    const int l0 = l1 + ss.y;
    const int kk = C_cc + pick(o1, cc);
    const int ll = cc == 0 ? l0 : cc == 1 ? l1 : cc == 2 ? l2 : l3;
    const int so = c > 3 ? 0 : pick(ss, cc);
    out[e] = fwd ? ll : kk;
    out[n + e] = fwd ? kk : ll;
    out[2 * n + e] = so;
}

template <class Layout>
int launch(const void* k, const void* l, const void* s, const void* c,
           const void* counts, const void* rows, const void* C,
           const void* primary, void* out, int n, int fwd, int block,
           void* stream) {
    if (n > 0) {
        ext_round_kernel<Layout><<<(n + block - 1) / block, block, 0,
                                   (cudaStream_t)stream>>>(
            (const int32_t*)k, (const int32_t*)l, (const int32_t*)s,
            (const int32_t*)c, (const int4*)counts, (const uint4*)rows,
            (const int32_t*)C, (const int32_t*)primary, (int32_t*)out, n,
            fwd);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Load both round kernels now (under lazy module loading a kernel loads at
// its first launch, which waits for the device: a stream held by the launch
// gate, csrc/gate.cu, would never let it finish).
extern "C" int fmocc_load() {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, ext_round_kernel<Eta32>);
    return (int)(e != cudaSuccess ? e
                                  : cudaFuncGetAttributes(
                                        &a, ext_round_kernel<Eta128>));
}

extern "C" int fmocc_ext_eta32(const void* k, const void* l, const void* s,
                               const void* c, const void* counts,
                               const void* rows, const void* C,
                               const void* primary, void* out, int n, int fwd,
                               int block, void* stream) {
    return launch<Eta32>(k, l, s, c, counts, rows, C, primary, out, n, fwd,
                         block, stream);
}

extern "C" int fmocc_ext_eta128(const void* k, const void* l, const void* s,
                                const void* c, const void* counts,
                                const void* rows, const void* C,
                                const void* primary, void* out, int n, int fwd,
                                int block, void* stream) {
    return launch<Eta128>(k, l, s, c, counts, rows, C, primary, out, n, fwd,
                          block, stream);
}
