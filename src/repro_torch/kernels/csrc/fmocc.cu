// FM-index occupancy count Occ(c, i) for a batch of queries, in the two
// bucket layouts of core/fmindex.py.
//
// Replaces the Pallas kernels of repro/kernels/fmocc/kernel.py:
//   occ_count_pallas_call        (eta=32 layout, body _occ_kernel_body)
//   occ_count_packed_pallas_call (eta=128 layout, body _occ_packed_kernel_body)
// together with the bucket gather that repro/kernels/fmocc/ops.py:_occ_impl
// leaves to XLA.  Here the gather is inside the kernel: one thread per
// query reads its bucket's count word and its 32-byte row directly.
//
// What bounds it on the H100: memory.  Per query the kernel reads c and i
// (8 B, coalesced), one 4-byte count out of a 32-byte sector and one
// 32-byte bucket row (both gathers at random addresses), and writes 4 B.
// The arithmetic is a handful of integer operations.  The design keeps the
// row to two 16-byte loads (one sector), keeps the compare and popcount in
// registers, and takes no shared memory, so occupancy is limited only by
// the block size the engine's sweep picks.
//
// Contract (both layouts): c in 0..3, i in [-1, N-1]; p = i+1.  The
// eta128 entry takes `primary` as a pointer to the device scalar, so a
// launch needs no device-to-host read.
//   eta32:  b = p>>5, r = p&31;  out = counts[b][c] + #{j < r : row[j] == c}
//           (bytes 4 = sentinel and 5 = pad never equal c)
//   eta128: b = p>>7, r = p&127; row holds 128 2-bit codes LSB-first;
//           out = counts[b][c] - corr + #{j < r : code[j] == c}, where
//           corr = (c == 0 && b*128 <= primary < p): the sentinel was
//           packed as code 0 (repro/kernels/fmocc/ops.py:64-68).
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// mask of the low n bytes of a 32-bit word (n <= 0: none, n >= 4: all)
__device__ __forceinline__ uint32_t low_bytes(int n) {
    if (n <= 0) return 0u;
    return n >= 4 ? 0xFFFFFFFFu : ((1u << (8 * n)) - 1u);
}

// mask of the low n 2-bit lanes of a 32-bit word (n <= 0: none, n >= 16: all)
__device__ __forceinline__ uint32_t low_pairs(int n) {
    if (n <= 0) return 0u;
    return n >= 16 ? 0xFFFFFFFFu : ((1u << (2 * n)) - 1u);
}

__device__ __forceinline__ void load_row(const uint8_t* rows, int b,
                                         uint32_t w[8]) {
    const uint4* row = reinterpret_cast<const uint4*>(rows + (size_t)b * 32);
    uint4 v0 = __ldg(row);
    uint4 v1 = __ldg(row + 1);
    w[0] = v0.x; w[1] = v0.y; w[2] = v0.z; w[3] = v0.w;
    w[4] = v1.x; w[5] = v1.y; w[6] = v1.z; w[7] = v1.w;
}

__global__ void occ_eta32_kernel(const int32_t* __restrict__ c,
                                 const int32_t* __restrict__ i,
                                 const int32_t* __restrict__ counts,
                                 const uint8_t* __restrict__ rows,
                                 int32_t* __restrict__ out, int T) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    int cc = c[t];
    int p = i[t] + 1;
    int b = p >> 5;
    int r = p & 31;
    uint32_t w[8];
    load_row(rows, b, w);
    uint32_t rep = (uint32_t)cc * 0x01010101u;
    int n = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        uint32_t x = w[k] ^ rep;              // zero byte where row == c
        // exact zero-byte test: high bit of each byte set iff byte == 0
        uint32_t z = ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
        n += __popc(z & low_bytes(r - 4 * k));
    }
    out[t] = __ldg(counts + 4 * b + cc) + n;
}

__global__ void occ_eta128_kernel(const int32_t* __restrict__ c,
                                  const int32_t* __restrict__ i,
                                  const int32_t* __restrict__ counts,
                                  const uint8_t* __restrict__ rows,
                                  const int32_t* __restrict__ primary_p,
                                  int32_t* __restrict__ out, int T) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    int cc = c[t];
    int p = i[t] + 1;
    int b = p >> 7;
    int r = p & 127;
    uint32_t w[8];
    load_row(rows, b, w);
    uint32_t rep = (uint32_t)cc * 0x55555555u;   // c in every 2-bit lane
    int n = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        uint32_t x = w[k] ^ rep;              // zero pair where code == c
        uint32_t z = ~(x | (x >> 1)) & 0x55555555u;
        // word k holds codes 16k .. 16k+15
        n += __popc(z & low_pairs(r - 16 * k));
    }
    const int primary = __ldg(primary_p);
    int corr = (cc == 0 && primary >= (b << 7) && primary < p) ? 1 : 0;
    out[t] = __ldg(counts + 4 * b + cc) - corr + n;
}

}  // namespace

extern "C" int fmocc_eta32(const void* c, const void* i, const void* counts,
                           const void* rows, void* out, int T, int block,
                           void* stream) {
    if (T > 0) {
        occ_eta32_kernel<<<(T + block - 1) / block, block, 0,
                           (cudaStream_t)stream>>>(
            (const int32_t*)c, (const int32_t*)i, (const int32_t*)counts,
            (const uint8_t*)rows, (int32_t*)out, T);
    }
    return (int)cudaGetLastError();
}

extern "C" int fmocc_eta128(const void* c, const void* i, const void* counts,
                            const void* rows, const void* primary, void* out,
                            int T, int block, void* stream) {
    if (T > 0) {
        occ_eta128_kernel<<<(T + block - 1) / block, block, 0,
                            (cudaStream_t)stream>>>(
            (const int32_t*)c, (const int32_t*)i, (const int32_t*)counts,
            (const uint8_t*)rows, (const int32_t*)primary, (int32_t*)out, T);
    }
    return (int)cudaGetLastError();
}
