// Banded Smith-Waterman seed extension (bwa's ksw_extend2) for W
// independent tasks.
//
// Replaces the Pallas kernel repro/kernels/bsw/kernel.py:bsw_pallas_call
// (body _bsw_kernel_body; row math repro/core/bsw.py:bsw_row_step).  The
// output spec is the scalar loop of core/bsw.py:bsw_extend: affine gaps,
// the adjusted_band clamp (done on the host), per-row band shrink, z-drop,
// the m == 0 exit and the last-index tie-break of the row maximum.  Each
// thread runs that loop for one task; the TPU kernel's Hillis-Steele
// prefix max over a whole row is a device for 128-lane vector units and
// has no place here.
//
// What bounds it on the H100: operations, and today latency.  A banded
// cell costs 20 int32 ALU operations (score: ambiguity test, equality,
// two selects; M: zero test, add, select; h: two max; row max: compare,
// select, max; E and F: sub, max, sub, max each; the target's ambiguity
// test is per row), besides two 4-byte loads and stores of the H/E rows,
// the query load and loop control; the cells per task depend on the data
// (band and early exits).  The H and E rows live in a wrapper-allocated int32 scratch laid
// out (qmax+1, W), so at a given column the threads of a warp touch
// neighbouring words; the rows are cached in L1/L2, not in shared memory.
// With one thread per task a block of 256 tasks fills only a few warps of
// a few SMs, and tasks of one warp diverge when their bands or exits
// differ.  Shared-memory rows and one warp per task are later work.
//
// Inputs: qs (W, qmax) and ts (W, tmax) int32 codes (4 = ambiguous, also
// the pad); qlens, tlens, h0s, ws (W,) int32 with qlen, tlen, h0 > 0 and
// qlen <= qmax, tlen <= tmax.  Output: (6, W) int32 rows score, qle, tle,
// gtle, gscore, max_off.  The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void bsw_kernel(const int32_t* __restrict__ qs,
                           const int32_t* __restrict__ ts,
                           const int32_t* __restrict__ qlens,
                           const int32_t* __restrict__ tlens,
                           const int32_t* __restrict__ h0s,
                           const int32_t* __restrict__ ws,
                           int W, int qmax, int tmax,
                           int a, int b, int o_del, int e_del,
                           int o_ins, int e_ins, int zdrop,
                           int32_t* __restrict__ eh_h,
                           int32_t* __restrict__ eh_e,
                           int32_t* __restrict__ out) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= W) return;
    const int qlen = qlens[t], tlen = tlens[t], h0 = h0s[t], w = ws[t];
    const int32_t* q = qs + (size_t)t * qmax;
    const int32_t* tg = ts + (size_t)t * tmax;
    int32_t* H = eh_h + t;           // H[j * W]: H(i-1, j-1) at row start
    int32_t* E = eh_e + t;           // E[j * W]: E(i, j)
    const int oe_del = o_del + e_del;
    const int oe_ins = o_ins + e_ins;

    // first row: eh_h[0] = h0, eh_h[1] = max(h0 - oe_ins, 0), then down
    // by e_ins while the previous value exceeds e_ins; the rest is 0
    for (int j = 0; j <= qlen; ++j) {
        H[(size_t)j * W] = 0;
        E[(size_t)j * W] = 0;
    }
    H[0] = h0;
    H[(size_t)W] = h0 - oe_ins > 0 ? h0 - oe_ins : 0;
    for (int j = 2; j <= qlen && H[(size_t)(j - 1) * W] > e_ins; ++j)
        H[(size_t)j * W] = H[(size_t)(j - 1) * W] - e_ins;

    int max_ = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0;
    int beg = 0, end = qlen;
    for (int i = 0; i < tlen; ++i) {
        int f = 0, m = 0, mj = -1;
        const int trow = tg[i];
        if (beg < i - w) beg = i - w;
        if (end > i + w + 1) end = i + w + 1;
        if (end > qlen) end = qlen;
        int h1 = 0;
        if (beg == 0) {
            h1 = h0 - (o_del + e_del * (i + 1));
            if (h1 < 0) h1 = 0;
        }
        for (int j = beg; j < end; ++j) {
            // H[j] = H(i-1, j-1), E[j] = E(i, j), f = F(i, j), h1 = H(i, j-1)
            int M = H[(size_t)j * W];
            int e = E[(size_t)j * W];
            H[(size_t)j * W] = h1;
            const int qc = q[j];
            const int sc = (trow >= 4 || qc >= 4) ? -1 : (trow == qc ? a : -b);
            M = M ? M + sc : 0;
            int h = M > e ? M : e;
            h = h > f ? h : f;
            h1 = h;
            mj = m > h ? mj : j;          // last index attaining the max
            m = m > h ? m : h;
            int tt = M - oe_del;
            tt = tt > 0 ? tt : 0;
            e -= e_del;
            e = e > tt ? e : tt;
            E[(size_t)j * W] = e;         // E(i+1, j)
            tt = M - oe_ins;
            tt = tt > 0 ? tt : 0;
            f -= e_ins;
            f = f > tt ? f : tt;
        }
        H[(size_t)end * W] = h1;
        E[(size_t)end * W] = 0;
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
        // shrink the band to the columns that can still score
        int j = beg;
        while (j < end && H[(size_t)j * W] == 0 && E[(size_t)j * W] == 0) ++j;
        beg = j;
        j = end;
        while (j >= beg && H[(size_t)j * W] == 0 && E[(size_t)j * W] == 0) --j;
        end = j + 2 < qlen ? j + 2 : qlen;
    }
    out[t] = max_;
    out[W + t] = max_j + 1;
    out[2 * W + t] = max_i + 1;
    out[3 * W + t] = max_ie + 1;
    out[4 * W + t] = gscore;
    out[5 * W + t] = max_off;
}

}  // namespace

extern "C" int bsw_extend(const void* qs, const void* ts, const void* qlens,
                          const void* tlens, const void* h0s, const void* ws,
                          int W, int qmax, int tmax, int a, int b, int o_del,
                          int e_del, int o_ins, int e_ins, int zdrop,
                          void* eh_h, void* eh_e, void* out, int block,
                          void* stream) {
    if (W > 0) {
        bsw_kernel<<<(W + block - 1) / block, block, 0,
                     (cudaStream_t)stream>>>(
            (const int32_t*)qs, (const int32_t*)ts, (const int32_t*)qlens,
            (const int32_t*)tlens, (const int32_t*)h0s, (const int32_t*)ws,
            W, qmax, tmax, a, b, o_del, e_del, o_ins, e_ins, zdrop,
            (int32_t*)eh_h, (int32_t*)eh_e, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}
