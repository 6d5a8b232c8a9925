// Banded Smith-Waterman seed extension (bwa's ksw_extend2) for W
// independent tasks, one warp per task.
//
// Replaces the Pallas kernel src/repro/kernels/bsw/kernel.py:61
// bsw_pallas_call (body _bsw_kernel_body; row math
// repro/core/bsw.py:bsw_row_step).  The output spec is the scalar loop of
// core/bsw.py:bsw_extend: affine gaps, the adjusted_band clamp (done on
// the host), per-row band shrink, z-drop, the m == 0 exit and the
// last-index tie-break of the row maximum.  Results are bit-exact to it.
//
// What bounds it on the H100: int32 operations (ksw_extend2's cell is 20
// ALU operations), but in practice latency.  A DP row is a chain: F(i, j)
// depends on F(i, j-1), and each row depends on the one before, so a task
// exposes one row of parallelism at a time and a 256-task block gives
// each SM ~2 warps.  The pace is set by the chain of dependent warp
// shuffles and shared-memory round trips a row takes, not by the ALU.
//
// The design keeps that chain short and everything on chip:
// * One warp per task, several tasks a CTA (the wrapper picks the count
//   from W and the SM count).  Every loop bound and every scalar of the
//   ksw state (beg, end, max, max_i, max_j, max_ie, gscore, max_off, the
//   m == 0 and z-drop exits) is warp-uniform, so no lane diverges on its
//   own task.
// * The H and E rows (qlen + 1 entries: H[end] is written) and the query
//   codes (bytes, staged once with coalesced loads) live in the warp's
//   slice of dynamic shared memory.  Target codes come 32 rows at a time
//   in one coalesced load, one per lane, and are broadcast a row at a
//   time by a shuffle.
// * A row runs in strips of 32 lanes x COLS columns from beg rounded down
//   to COLS, so a row of up to 125 columns is one strip: each lane reads
//   its COLS entries of H(i-1, j-1), E(i, j) and the query in one 16-byte
//   and one 4-byte load, computes the score, M and E(i+1, j), and stores
//   its columns back in one 16-byte store of each row (entries outside
//   [beg, end) keep their value).
// * F is the max-plus prefix of core/bsw.py:bsw_row_step: g_j =
//   max(M_j - oe_ins, 0) + (j+1) e_ins, its prefix max taken inside the
//   lane and then by a 5-step warp max-scan of the lanes' totals, carried
//   across strips; F_j = max(excl_j, beg e_ins) - j e_ins.  H(i, j-1) for
//   column j comes from the lane's previous column, or lane - 1 by a
//   shuffle.  A lane reads and writes only its own columns, so a strip
//   needs no barrier.
// * Each lane keeps its own running row maximum with the last column
//   attaining it, and the first and last column where (H, E) != 0; at the
//   end of the row four warp reductions give the row max, its last index
//   (the max of the lanes' indices at the max) and the shrunken band.
//
// Inputs: qs (W, qmax) and ts (W, tmax) int32 codes (4 = ambiguous, also
// the pad); qlens, tlens, h0s, ws (W,) int32 with qlen, tlen, h0 > 0 and
// qlen <= qmax, tlen <= tmax.  Output: (6, W) int32 rows score, qle, tle,
// gtle, gscore, max_off.  Launch: ctas x (32 warps) threads and warps x
// warp_bytes of dynamic shared memory, warp_bytes >= 9 ncol with ncol =
// qmax + 1 rounded up to COLS (kernels/bsw/ops.py:launch_geometry).  The
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int COLS = 4;              // columns a lane (one int4 of H, of E)
constexpr int STRIP = 32 * COLS;     // columns a warp step
static_assert(COLS == 4, "a lane loads its H and E columns as one int4");
constexpr int NEG = -0x3fffffff;     // below every g_j; no overflow in max
constexpr int NONE = 0x7fffffff;     // no column yet (a lane's first nz)

__global__ void bsw_kernel(const int32_t* __restrict__ qs,
                           const int32_t* __restrict__ ts,
                           const int32_t* __restrict__ qlens,
                           const int32_t* __restrict__ tlens,
                           const int32_t* __restrict__ h0s,
                           const int32_t* __restrict__ ws,
                           int W, int qmax, int tmax,
                           int a, int b, int o_del, int e_del,
                           int o_ins, int e_ins, int zdrop, int warp_bytes,
                           int32_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int t = blockIdx.x * (blockDim.x >> 5) + warp;
    if (t >= W) return;                       // the whole warp: no barriers
    const int ncol = (qmax + COLS) & ~(COLS - 1);  // qmax + 1 rounded up
    int32_t* Hs = reinterpret_cast<int32_t*>(smem + (size_t)warp * warp_bytes);
    int32_t* Es = Hs + ncol;
    uint8_t* Qs = reinterpret_cast<uint8_t*>(Es + ncol);
    const int qlen = qlens[t], tlen = tlens[t], h0 = h0s[t], w = ws[t];
    const int32_t* qg = qs + (size_t)t * qmax;
    const int32_t* tg = ts + (size_t)t * tmax;
    const int oe_del = o_del + e_del;
    const int oe_ins = o_ins + e_ins;

    // query codes as bytes (codes >= 4 are all ambiguous), and the first
    // row: H[0] = h0, H[j] = max(h0 - oe_ins - (j-1) e_ins, 0), E = 0 (the
    // closed form of the scalar fill's early stop)
    for (int j = lane; j <= qlen; j += 32) {
        if (j < qlen) Qs[j] = (uint8_t)min(qg[j], 4);
        Hs[j] = j == 0 ? h0 : max(h0 - oe_ins - (j - 1) * e_ins, 0);
        Es[j] = 0;
    }
    __syncwarp();

    int max_ = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0;
    int beg = 0, end = qlen;
    // target codes of rows [i, i+32) and, loaded a chunk ahead, [i+32, i+64)
    int tcur = lane < tlen ? min(tg[lane], 4) : 4;
    int tnext = 32 + lane < tlen ? min(tg[32 + lane], 4) : 4;
    for (int i = 0; i < tlen; ++i) {
        if ((i & 31) == 0 && i) {
            const int r = i + 32 + lane;
            tcur = tnext;
            tnext = r < tlen ? min(tg[r], 4) : 4;
        }
        const int trow = __shfl_sync(FULL, tcur, i & 31);
        beg = max(beg, i - w);
        end = min(min(end, i + w + 1), qlen);
        // hprev = H(i, j0 - 1) for the strip at j0: the first column's
        // value at beg, then the last column of the strip before
        int hprev = beg == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
        int h1 = hprev;                   // H(i, end-1) once the row is done
        int carry = NEG;                  // max of g over earlier strips
        int lm = -1, lmj = -1;            // this lane's max and last index
        int lfirst = NONE, llast = -1;    // its (H, E) != 0 columns
        const int ebeg = beg * e_ins;
        for (int j0 = beg & ~(COLS - 1); j0 < end; j0 += STRIP) {
            const int jb = j0 + COLS * lane;
            int4 hv = make_int4(0, 0, 0, 0), ev = hv;
            uint32_t qv = 0x04040404u;
            if (jb < end) {
                hv = *reinterpret_cast<const int4*>(Hs + jb);
                ev = *reinterpret_cast<const int4*>(Es + jb);
                qv = *reinterpret_cast<const uint32_t*>(Qs + jb);
            }
            const int Hk[COLS] = {hv.x, hv.y, hv.z, hv.w};   // H(i-1, j-1)
            const int Ek[COLS] = {ev.x, ev.y, ev.z, ev.w};   // E(i, j)
            int M[COLS], pre[COLS];
#pragma unroll
            for (int k = 0; k < COLS; ++k) {
                const int j = jb + k;
                const int qc = (qv >> (8 * k)) & 0xff;
                const int sc = (trow >= 4 || qc >= 4) ? -1
                                                      : (trow == qc ? a : -b);
                M[k] = Hk[k] ? Hk[k] + sc : 0;
                const int g = (j >= beg && j < end)
                                  ? max(M[k] - oe_ins, 0) + (j + 1) * e_ins
                                  : NEG;
                pre[k] = k ? max(pre[k - 1], g) : g;
            }
            int incl = pre[COLS - 1];     // inclusive max-scan of lane totals
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int v = __shfl_up_sync(FULL, incl, d);
                if (lane >= d) incl = max(incl, v);
            }
            const int up = __shfl_up_sync(FULL, incl, 1);
            const int base = lane ? max(carry, up) : carry;
            int h[COLS], en[COLS];
#pragma unroll
            for (int k = 0; k < COLS; ++k) {
                const int j = jb + k;
                const int excl = k ? max(base, pre[k - 1]) : base;
                const int F = max(excl, ebeg) - j * e_ins;   // F(i, j)
                // columns before beg pass H(i, beg-1) on to column beg
                h[k] = j < beg ? hprev : max(max(M[k], Ek[k]), F);
                en[k] = max(Ek[k] - e_del, max(M[k] - oe_del, 0));
            }
            int hs0 = __shfl_up_sync(FULL, h[COLS - 1], 1);  // H(i, jb-1)
            if (lane == 0) hs0 = hprev;
            int nh[COLS], ne[COLS];
#pragma unroll
            for (int k = 0; k < COLS; ++k) {
                const int j = jb + k;
                const int hs = k ? h[k - 1] : hs0;           // H(i, j-1)
                const bool live = j >= beg && j < end;
                if (live && h[k] >= lm) {   // >=: the last index wins a tie
                    lm = h[k];
                    lmj = j;
                }
                if (live && (hs | en[k])) {
                    lfirst = min(lfirst, j);
                    llast = j;
                }
                nh[k] = live ? hs : Hk[k];
                ne[k] = live ? en[k] : Ek[k];
            }
            if (jb < end) {
                *reinterpret_cast<int4*>(Hs + jb) =
                    make_int4(nh[0], nh[1], nh[2], nh[3]);
                *reinterpret_cast<int4*>(Es + jb) =
                    make_int4(ne[0], ne[1], ne[2], ne[3]);
            }
            carry = max(carry, __shfl_sync(FULL, incl, 31));
            if (j0 + STRIP < end) {
                hprev = __shfl_sync(FULL, h[COLS - 1], 31);
            } else {                      // the last strip holds end - 1
                const int o = end - 1 - j0, k = o & (COLS - 1);
                const int hk = k == 0 ? h[0] : k == 1 ? h[1]
                             : k == 2 ? h[2] : h[3];
                h1 = __shfl_sync(FULL, hk, o / COLS);
            }
        }
        __syncwarp();                     // the strips' stores before H[end]
        if (lane == 0) {
            Hs[end] = h1;
            Es[end] = 0;
        }
        int m = __reduce_max_sync(FULL, lm);
        const int first_nz = __reduce_min_sync(FULL, lfirst);
        int last_nz = __reduce_max_sync(FULL, llast);
        const int mj = m < 0 ? -1 : __reduce_max_sync(FULL, lm == m ? lmj : -1);
        m = max(m, 0);                    // an empty band: m = 0
        if (end == qlen) {
            max_ie = gscore > h1 ? max_ie : i;
            gscore = gscore > h1 ? gscore : h1;
        }
        if (m == 0) break;
        if (m > max_) {
            max_ = m;
            max_i = i;
            max_j = mj;
            const int off = mj > i ? mj - i : i - mj;
            max_off = max_off > off ? max_off : off;
        } else if (zdrop > 0) {
            if (i - max_i > mj - max_j) {
                if (max_ - m - ((i - max_i) - (mj - max_j)) * e_del > zdrop)
                    break;
            } else {
                if (max_ - m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop)
                    break;
            }
        }
        // shrink the band to the columns that can still score: beg to the
        // first nonzero of [beg, end), end past the last of [beg, end]
        beg = first_nz != NONE ? first_nz : end;
        if (h1) last_nz = end;
        const int jlast = last_nz >= beg ? last_nz : beg - 1;
        end = min(jlast + 2, qlen);
        __syncwarp();                     // H[end] before the next row reads
    }
    if (lane == 0) {
        out[t] = max_;
        out[W + t] = max_j + 1;
        out[2 * W + t] = max_i + 1;
        out[3 * W + t] = max_ie + 1;
        out[4 * W + t] = gscore;
        out[5 * W + t] = max_off;
    }
}

}  // namespace

// Load the kernel now (see fmocc_load in fmocc.cu).
extern "C" int bsw_load() {
    cudaFuncAttributes a;
    return (int)cudaFuncGetAttributes(&a, bsw_kernel);
}

extern "C" int bsw_extend(const void* qs, const void* ts, const void* qlens,
                          const void* tlens, const void* h0s, const void* ws,
                          int W, int qmax, int tmax, int a, int b, int o_del,
                          int e_del, int o_ins, int e_ins, int zdrop,
                          void* out, int ctas, int warps, int warp_bytes,
                          void* stream) {
    if (W <= 0) return (int)cudaGetLastError();
    const int ncol = (qmax + COLS) & ~(COLS - 1);
    if ((long long)ctas * warps < W || warp_bytes % 16 ||
        warp_bytes < 9 * ncol)
        return (int)cudaErrorInvalidValue;
    const int smem = warps * warp_bytes;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            bsw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    bsw_kernel<<<ctas, 32 * warps, smem, (cudaStream_t)stream>>>(
        (const int32_t*)qs, (const int32_t*)ts, (const int32_t*)qlens,
        (const int32_t*)tlens, (const int32_t*)h0s, (const int32_t*)ws,
        W, qmax, tmax, a, b, o_del, e_del, o_ins, e_ins, zdrop, warp_bytes,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
