// Banded global alignment with affine gaps and traceback (ksw_global's
// banded DP) for T independent tasks, one warp per task: the score and
// the CIGAR of each region that finalize emits.
//
// Replaces host code, not a Pallas kernel: src/repro/core/sam.py:18
// global_align_cigar, a per-cell Python double loop that both packages
// run for every emitted region (no Pallas counterpart).  Results are
// bit-exact to it: w = max(w, |n - m| + 3); row 0 and column 0 set only up
// to min(m, w) and min(n, w); the band [max(1, i - w), min(m, i + w)];
// cells outside it hold the reference's NEG = -2^28, and the recurrences
// compute on it as on any score; the traceback's tie order M, then E,
// then F; E and F closing back to H only on the exact open equality; the
// corner branch (emits M, never taken in the band); n == 0 and m == 0.
// int32 holds every value: they stay within 2^28 + (n + m) times the
// largest penalty, which the wrapper checks (kernels/galign/ops.py).
//
// What bounds it on the H100: int32 operations (~20 a cell for the DP,
// counted as bsw_kernel's), but in practice latency.  A row depends on
// the one before, so a task exposes one row of parallelism at a time,
// and the traceback is one dependent chain of n + m steps.
//
// The design, simple first (one warp a task, as bsw_kernel):
// * A row's band runs in strips of 32 columns, one a lane.  H(i-1, j-1),
//   H(i-1, j) and F(i-1, j) come from the previous row, so the diagonal
//   and F need no neighbour.  E, the gap along the row, is a max-plus
//   prefix: with Hp = max(diag, F) and d = e_del + min(0, o_del),
//   E(j) = max(E(jlo) + d jlo, max over jlo <= k < j of
//   Hp(k) - o_del - e_del + d (k + 1)) - d j, an exclusive 5-step warp
//   max-scan carried across strips (E(j - 1) - o_del - e_del never beats
//   E(j - 1) - d).  H(i, j - 1) for the E-close test comes from lane - 1
//   by a shuffle.
// * Two rows of H and F live in global scratch, 4 (m + 1) int32 a task,
//   written and read by the task's own warp only (a __syncwarp orders
//   them); a row writes its band, column 0 and the NEG just past the
//   band, which is all the next row reads.
// * Each cell's traceback decisions are 4 bits of one byte, in global
//   scratch of (n + 1)(m + 1) bytes a task (sized by the wrapper from
//   the tasks' lengths, so no length is refused): which of M, E, F the
//   cell's H equals first (2 bits), and whether its E and F equal the gap
//   opened from the H before them.
// * Lane 0 walks the traceback over those bytes, run-length encodes the
//   ops and writes the runs in CIGAR order.  A walk that would leave the
//   band, or reach E at column 0 or F at row 0 (the reference would then
//   index its NEG cells, which no score in the band can lead to), writes
//   nruns -1 and the wrapper raises.
//
// Inputs: qs (T, qstride) and ts (T, tstride) uint8 codes 0..4; ns, ms,
// ws (T,) int32; boff, roff (T,) int64 offsets of each task's decision
// bytes and row scratch.  Outputs: score, nruns (T,) int32 and runs
// (T, run_stride) int32, a run count << 2 | op with op 0 M, 1 I, 2 D.
// Launch: ceil(T / warps) CTAs of 32 warps threads, no shared memory.
// The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 28);       // the reference's minus infinity
constexpr int FLOOR = -(1 << 30);     // below every prefix term
constexpr int OP_M = 0, OP_I = 1, OP_D = 2;

__device__ __forceinline__ int cell_score(int x, int y, int a, int b) {
    return (x == 4 || y == 4) ? -1 : (x == y ? a : -b);
}

__global__ void galign_kernel(const uint8_t* __restrict__ qs,
                              const uint8_t* __restrict__ ts,
                              int qstride, int tstride,
                              const int32_t* __restrict__ ns,
                              const int32_t* __restrict__ ms,
                              const int32_t* __restrict__ ws,
                              const int64_t* __restrict__ boff,
                              const int64_t* __restrict__ roff,
                              uint8_t* __restrict__ bits,
                              int32_t* __restrict__ rows, int T,
                              int a, int b, int o_del, int e_del,
                              int o_ins, int e_ins, int run_stride,
                              int32_t* __restrict__ score,
                              int32_t* __restrict__ nruns,
                              int32_t* __restrict__ runs) {
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (t >= T) return;
    const int n = ns[t], m = ms[t];
    int32_t* out = runs + (int64_t)t * run_stride;
    if (n == 0 || m == 0) {
        if (lane == 0) {
            if (n == 0) {
                score[t] = m ? -o_del - e_del * m : 0;
                nruns[t] = m ? 1 : 0;
                if (m) out[0] = (m << 2) | OP_D;
            } else {
                score[t] = -o_ins - e_ins * n;
                nruns[t] = 1;
                out[0] = (n << 2) | OP_I;
            }
        }
        return;
    }
    const int w = max(ws[t], abs(n - m) + 3);
    const uint8_t* q = qs + (int64_t)t * qstride;
    const uint8_t* tg = ts + (int64_t)t * tstride;
    uint8_t* bt = bits + boff[t];
    int32_t* R = rows + roff[t];
    const int M1 = m + 1;
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    const int d = e_del + min(0, o_del);
    const int wm = min(m, w), wn = min(n, w);

    for (int j = lane; j <= m; j += 32) {           // row 0
        R[j] = j == 0 ? 0 : (j <= wm ? -(o_del + e_del * j) : NEG);
        R[M1 + j] = NEG;
    }
    __syncwarp();
    for (int i = 1; i <= n; ++i) {
        const int32_t* Hu = R + ((i - 1) & 1) * 2 * M1;
        const int32_t* Fu = Hu + M1;
        int32_t* Hc = R + (i & 1) * 2 * M1;
        int32_t* Fc = Hc + M1;
        const int jlo = max(1, i - w), jhi = min(m, i + w);
        const int first = i <= wn ? -(o_ins + e_ins * i) : NEG;  // H(i, 0)
        const int hleft = jlo == 1 ? first : NEG;                // H(i, jlo-1)
        const int elo = max(NEG - e_del, hleft - oe_del);        // E(i, jlo)
        int carry = elo + d * jlo;
        int hprev = hleft;
        const int qc = q[i - 1];
        uint8_t* brow = bt + (int64_t)i * M1;
        if (lane == 0) {
            Hc[0] = first;
            Fc[0] = first;
            if (jhi + 1 <= m) {
                Hc[jhi + 1] = NEG;
                Fc[jhi + 1] = NEG;
            }
        }
        for (int c0 = jlo; c0 <= jhi; c0 += 32) {
            const int j = c0 + lane;
            const bool in = j <= jhi;
            int diag = 0, Fn = 0, Hp = 0, A = FLOOR, fclose = 0;
            if (in) {
                const int hu = Hu[j];
                diag = Hu[j - 1] + cell_score(qc, tg[j - 1], a, b);
                Fn = max(Fu[j] - e_ins, hu - oe_ins);
                fclose = Fn == hu - oe_ins;
                Hp = max(diag, Fn);
                A = Hp - oe_del + d * (j + 1);
            }
            int x = A;                                 // inclusive max-scan
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const int y = __shfl_up_sync(FULL, x, s);
                if (lane >= s) x = max(x, y);
            }
            int ex = __shfl_up_sync(FULL, x, 1);
            ex = lane == 0 ? carry : max(carry, ex);
            const int E = ex - d * j;
            const int Hn = max(Hp, E);
            int hl = __shfl_up_sync(FULL, Hn, 1);      // H(i, j - 1)
            if (lane == 0) hl = hprev;
            if (in) {
                const int hdir = Hn == diag ? 0 : (Hn == E ? 1 : (Hn == Fn ? 2 : 3));
                brow[j] = (uint8_t)(hdir | ((E == hl - oe_del) << 2) | (fclose << 3));
                Hc[j] = Hn;
                Fc[j] = Fn;
            }
            carry = max(carry, __shfl_sync(FULL, x, 31));
            hprev = __shfl_sync(FULL, Hn, 31);
        }
        __syncwarp();
    }
    if (lane != 0) return;
    int i = n, j = m, st = 0, k = 0, bad = 0, cur = -1, len = 0;
    while (i > 0 || j > 0) {
        int op = -1;
        if (i == 0) {
            if (st == 2) { bad = 1; break; }
            op = OP_D; --j;
        } else if (j == 0) {
            if (st == 1) { bad = 1; break; }
            op = OP_I; --i;
        } else {
            if (j < max(1, i - w) || j > min(m, i + w)) { bad = 1; break; }
            const int bb = bt[(int64_t)i * M1 + j];
            if (st == 0) {
                const int hd = bb & 3;
                if (hd == 0 || hd == 3) { op = OP_M; --i; --j; }
                else st = hd;
            } else if (st == 1) {
                op = OP_D;
                if ((bb >> 2) & 1) st = 0;
                --j;
            } else {
                op = OP_I;
                if ((bb >> 3) & 1) st = 0;
                --i;
            }
        }
        if (op < 0) continue;
        if (op == cur) {
            ++len;
        } else {
            if (cur >= 0) out[k++] = (len << 2) | cur;
            cur = op;
            len = 1;
        }
    }
    if (!bad && cur >= 0) out[k++] = (len << 2) | cur;
    for (int x = 0, y = k - 1; x < y; ++x, --y) {
        const int32_t v = out[x];
        out[x] = out[y];
        out[y] = v;
    }
    score[t] = R[(n & 1) * 2 * M1 + m];
    nruns[t] = bad ? -1 : k;
}

}  // namespace

extern "C" int galign(const void* qs, const void* ts, int qstride,
                      int tstride, const void* ns, const void* ms,
                      const void* ws, const void* boff, const void* roff,
                      void* bits, void* rows, int T, int a, int b,
                      int o_del, int e_del, int o_ins, int e_ins,
                      int run_stride, void* score, void* nruns, void* runs,
                      int warps, void* stream) {
    if (T > 0) {
        galign_kernel<<<(T + warps - 1) / warps, 32 * warps, 0,
                        (cudaStream_t)stream>>>(
            (const uint8_t*)qs, (const uint8_t*)ts, qstride, tstride,
            (const int32_t*)ns, (const int32_t*)ms, (const int32_t*)ws,
            (const int64_t*)boff, (const int64_t*)roff, (uint8_t*)bits,
            (int32_t*)rows, T, a, b, o_del, e_del, o_ins, e_ins, run_stride,
            (int32_t*)score, (int32_t*)nruns, (int32_t*)runs);
    }
    return (int)cudaGetLastError();
}
