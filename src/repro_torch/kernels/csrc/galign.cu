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
// corner branch never taken (H equals one of M, E, F in the band);
// n == 0 and m == 0.  int32 holds every value: they stay within
// 2^28 + (n + m) times the largest penalty, which the wrapper checks
// (kernels/galign/ops.py), with a, -b and -1 in a signed byte.
//
// What bounds it on the H100: int32 operations (~11 a cell for the spec's
// DP, ~0.004 ms for a batch of 101-base reads), but in practice latency:
// a row depends on the one before, so a task exposes one row at a time,
// and a batch of reads puts ~5 tasks on an SM, one warp a scheduler, so
// nothing hides a row's dependent instructions and shuffles.  The design
// keeps the row-to-row chain and the traceback on chip and shortens both:
//
// * galign_kernel<K, GLOBAL>: the band in band-relative columns, row i's
//   offset o = j - max(1, i - w); W = min(m, 2w + 1) is a row's widest
//   band and 32 K > W for every task of the launch (K, a power of two
//   from 2 to 32, picked by the wrapper from the widest band).  Lane L
//   holds offsets [L K, L K + K) of the previous row's H and F, and the
//   target codes under them (4 bits each), in registers.  A row's scores
//   come from one __byte_perm of a table of 5 score bytes by the code
//   nibbles, 4 cells at once; the max-plus steps are DPX instructions
//   (__viaddmax_s32, __vimax3_s32).
//   - Rows 1..w + 1 keep jlo = 1, so a lane's columns stay put, and they
//     run as a wavefront: lane L on row s - L at step s, handed its left
//     neighbour's H and E and the row's query code by lane - 1, which did
//     the row a step before.  E runs the reference's own recurrence along
//     the lane's cells; a step is three independent shuffles and K cells.
//     For reads whose band covers the matrix (w >= n - 1, every 101-base
//     read on BWA-MEM's band) these are all the rows: n + 25 steps for a
//     101-base read at K = 4 (the 26 lanes that hold band columns).
//   - Later rows move one column right: the up values of a lane's last
//     cell, and its next target code, come from lane + 1 by
//     __shfl_down_sync (lane 31's code is loaded a row ahead, as the next
//     row's query code), so a row needs all of the row before, and E is
//     a max-plus prefix: with Hp = max(diag, F) and
//     d = e_del + min(0, o_del), E(j) = max(E(jlo) + d jlo, max over
//     jlo <= k < j of Hp(k) - o_del - e_del + d (k + 1)) - d j
//     (E(j - 1) - o_del - e_del never beats E(j - 1) - d), taken over the
//     lane's K cells, then one 5-step warp max-scan: a row costs the scan
//     and three shuffles, whatever its width.
//   Nothing of a row leaves the registers.  Offsets at or past the row's
//   band hold NEG, which is all the next row reads there (32 K > W leaves
//   lane 31's last offset off every band, so no up value comes from past
//   the window).
// * Each cell's traceback decisions are 4 bits: H equals the diagonal
//   (bit 0), H equals E (bit 1; read only without bit 0, so the tie order
//   is M, E, F), and whether E and F equal the gap opened from the H
//   before them (bits 2, 3).  A lane packs its K nibbles into one store
//   of K / 2 bytes; row i (1..n) holds RB = ceil(W / K) K / 2 bytes.  With
//   GLOBAL false they live in the warp's slot of dynamic shared memory:
//   n RB bytes, then 4 (n + m) bytes for the runs, each rounded up to 16
//   (6,080 bytes for a 101-base read), 4 slots a CTA.  A task whose slot
//   is larger than a quarter of the 227 KB a CTA may take is launched
//   with GLOBAL true, the same code over a slot in global scratch (a size
//   dispatch made by the wrapper from the host-side lengths).
// * The traceback takes up to 32 steps at once: lane l reads the cell l
//   steps on along the state's direction (H: up-left, E: left, F: up),
//   and a ballot finds where the run of one op ends (a switch out of H, a
//   close back to H, the band's edge, row or column 0), so a run of M, D
//   or I costs one shared-memory load a lane and a ballot.  The runs go
//   into the slot last first, and the warp copies them to the output in
//   CIGAR order.  A walk that would leave the band, or reach E at column 0
//   or F at row 0 (the reference would then index its NEG cells, which no
//   score in the band can lead to), writes nruns -1 and the wrapper
//   raises.
//
// galign_wide_kernel takes the tasks whose band is too wide for the
// registers (W >= 32 x 32), so that no length is refused: one warp a task
// in strips of 32 columns, two rows of H and F in global scratch
// (4 (m + 1) int32) and a decision byte a cell ((n + 1)(m + 1) bytes).
//
// Inputs: qs (T, qstride) and ts (T, tstride) uint8 codes 0..4; ns, ms,
// ws (T,) int32; order (n_smem + n_global + n_wide) int64 task ids, each
// path's longest first; boff, roff (T,) int64 offsets of a task's global
// slot and row scratch.  Outputs: score, nruns (T,) int32 and runs
// (T, run_stride) int32, a run count << 2 | op with op 0 M, 1 I, 2 D.
// Launch: ceil(tasks / 4) CTAs of 128 threads a path, with 4 slots of
// dynamic shared memory on the shared path.  The entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 28);       // the reference's minus infinity
constexpr int FLOOR = -(1 << 30);     // below every prefix term
constexpr int OP_M = 0, OP_I = 1, OP_D = 2;
constexpr int WARPS = 4;              // tasks a CTA (ops.py WARPS)

struct Params {
    int a, b, o_del, e_del, o_ins, e_ins;
};

__device__ __forceinline__ int cell_score(int x, int y, int a, int b) {
    return (x == 4 || y == 4) ? -1 : (x == y ? a : -b);
}

// One store of a lane's K nibbles (K / 2 bytes, aligned to K / 2).
template <int K>
__device__ __forceinline__ void store_nibbles(uint8_t* p, const uint32_t* w) {
    if constexpr (K == 2) *p = (uint8_t)w[0];
    else if constexpr (K == 4) *(uint16_t*)p = (uint16_t)w[0];
    else if constexpr (K == 8) *(uint32_t*)p = w[0];
    else if constexpr (K == 16) *(uint2*)p = make_uint2(w[0], w[1]);
    else *(uint4*)p = make_uint4(w[0], w[1], w[2], w[3]);
}

// Byte b of w, sign-extended (prmt: selector nibbles 8 + b replicate the
// byte's sign bit; b is a constant once the cell loop is unrolled).
__device__ __forceinline__ int sext_byte(uint32_t w, int b) {
    int r;
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(b * 0x1111 + 0x8880));
    return r;
}

// The score and runs of a task with an empty query or target.
__device__ void edge_task(int n, int m, const Params& p, int32_t* score,
                          int32_t* nruns, int32_t* out) {
    if (n == 0) {
        *score = m ? -p.o_del - p.e_del * m : 0;
        *nruns = m ? 1 : 0;
        if (m) out[0] = (m << 2) | OP_D;
    } else {
        *score = -p.o_ins - p.e_ins * n;
        *nruns = 1;
        out[0] = (n << 2) | OP_I;
    }
}

// (launch bounds with a minimum of one CTA an SM: without it ptxas caps
// the K = 16 kernel at 128 registers and spills)
template <int K, bool GLOBAL>
__global__ void __launch_bounds__(32 * WARPS, 1)
galign_kernel(const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
              int qstride, int tstride, const int32_t* __restrict__ ns,
              const int32_t* __restrict__ ms, const int32_t* __restrict__ ws,
              const int64_t* __restrict__ order, int ntasks,
              const int64_t* __restrict__ boff, uint8_t* __restrict__ gbits,
              int slot, Params p, int run_stride, int32_t* __restrict__ score,
              int32_t* __restrict__ nruns, int32_t* __restrict__ runs) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = blockIdx.x * WARPS + warp;
    if (g >= ntasks) return;
    const int64_t t = order[g];
    const int n = ns[t], m = ms[t];
    int32_t* out = runs + t * run_stride;
    if (n == 0 || m == 0) {
        if (lane == 0) edge_task(n, m, p, score + t, nruns + t, out);
        return;
    }
    const int w = max(ws[t], abs(n - m) + 3);
    const int W = (int)min((int64_t)m, 2 * (int64_t)w + 1);
    const int RB = (W + K - 1) / K * (K / 2);      // decision bytes a row
    uint8_t* dec = GLOBAL ? gbits + boff[t] : smem + (size_t)warp * slot;
    int32_t* rbuf = (int32_t*)(dec + (((int64_t)n * RB + 15) & ~(int64_t)15));
    const uint8_t* q = qs + t * qstride;
    const uint8_t* tg = ts + t * tstride;
    const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
    const int d = p.e_del + min(0, p.o_del);
    const int wm = min(m, w), wn = min(n, w);
    const int base = lane * K;                     // the lane's first offset

    constexpr int NW = (K + 7) / 8;                // words of 8 code nibbles
    int H[K], F[K];
    uint32_t tn[NW];                               // target codes, 4 bits
#pragma unroll
    for (int x = 0; x < NW; ++x) tn[x] = 0;
    // the target code that enters lane 31's last offset when the band
    // moves right at row i: column max(1, i - w) + 32 K - 1, fetched a row
    // ahead so that the load stays off the row's chain
    auto code = [&](int c) { return c <= m ? (uint32_t)tg[c - 1] : 4u; };
#pragma unroll
    for (int k = 0; k < K; ++k) {                  // row 0, band from j = 1
        const int j = base + k + 1;
        H[k] = j <= wm ? -(p.o_del + p.e_del * j) : NEG;
        F[k] = NEG;
        tn[k / 8] |= code(j) << (4 * (k % 8));
    }
    // a row's scores as bytes by target code (0..4), picked for 4 cells
    // at once by __byte_perm with their code nibbles as the selector
    const uint32_t mis = ((uint32_t)(-p.b) & 0xffu) * 0x01010101u;
    auto scores = [&](uint32_t qc, uint32_t* sw) {
        const uint32_t qsh = 8 * qc;
        const uint32_t lo4 = qc == 4 ? 0xffffffffu
            : (mis & ~(0xffu << qsh)) | (((uint32_t)p.a & 0xffu) << qsh);
#pragma unroll
        for (int g = 0; g < (K + 3) / 4; ++g)
            sw[g] = __byte_perm(lo4, 0xffu, tn[g / 2] >> (16 * (g % 2)));
    };

    // rows 1..w + 1 as a wavefront: lane - 1 hands over its last H and E
    // of row i (the first cell's left neighbour) and the row's query code;
    // its last H of row i - 1, kept from the step before, is the first
    // cell's diagonal; lane 0 takes column 0, H(i, 0) and E = NEG
    const int split = min(n, w + 1);
    {
        // lanes at or past nl hold no column of these rows' bands: they
        // keep row 0's NEG, which is row split's there, and the wavefront
        // ends when lane nl - 1 has done row split
        const int nl = min(32, (min(m, split + w) + K - 1) / K);
        int hout = H[K - 1], eout = NEG, dprev = 0;
        uint32_t qout = 0, qnext = q[0];
        for (int step = 1; step < split + nl; ++step) {
            const int i = step - lane;
            int hin = __shfl_up_sync(FULL, hout, 1);
            int ein = __shfl_up_sync(FULL, eout, 1);
            uint32_t qc = __shfl_up_sync(FULL, qout, 1);
            if (lane == 0) {
                hin = step <= wn ? -(p.o_ins + p.e_ins * step) : NEG;
                ein = NEG;
                qc = qnext;
                qnext = q[min(step, n - 1)];
            }
            const int diag0 = dprev;               // H(i - 1, lane's j - 1)
            dprev = hin;
            if (i < 1 || i > split) continue;
            const int jhi = min(m, i + w);
            uint32_t sw[(K + 3) / 4], pk[NW];
            scores(qc, sw);
#pragma unroll
            for (int x = 0; x < NW; ++x) pk[x] = 0;
            int e = ein, hl = hin, hd = diag0;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int hu = H[k], hoe = hu - oe_ins;
                const int dg = hd + sext_byte(sw[k / 4], k % 4);
                hd = hu;
                const int fn = __viaddmax_s32(F[k], -p.e_ins, hoe);
                const int hloe = hl - oe_del;
                e = __viaddmax_s32(e, -p.e_del, hloe);
                const int hn = __vimax3_s32(dg, e, fn);
                pk[k / 8] |= ((uint32_t)(hn == dg) | (uint32_t)(hn == e) << 1
                              | (uint32_t)(e == hloe) << 2
                              | (uint32_t)(fn == hoe) << 3) << (4 * (k % 8));
                H[k] = base + k < jhi ? hn : NEG;
                F[k] = base + k < jhi ? fn : NEG;
                hl = hn;
            }
            hout = H[K - 1];
            eout = e;
            qout = qc;
            if (base < jhi)
                store_nibbles<K>(dec + (size_t)(i - 1) * RB + base / 2, pk);
        }
    }

    // later rows, one column right each: a prefix and a scan a row
    uint32_t qn = q[min(split, n - 1)];
    uint32_t tin = code(max(1, split + 1 - w) + 32 * K - 1);
    for (int i = split + 1; i <= n; ++i) {
        const uint32_t qc = qn, t_in = tin;
        qn = q[min(i, n - 1)];                     // the next row's codes
        tin = code(max(1, i + 1 - w) + 32 * K - 1);
        const int jlo = i - w, jhi = min(m, i + w);
        const int width = jhi - jlo + 1;
        // H(i, jlo - 1) and E(i, jlo - 1) are off the band, so NEG
        const int carry = max(NEG - p.e_del, NEG - oe_del) + d * jlo;
        int nh = __shfl_down_sync(FULL, H[0], 1);
        int nf = __shfl_down_sync(FULL, F[0], 1);
        uint32_t nt = __shfl_down_sync(FULL, tn[0], 1) & 15u;
        if (lane == 31) {
            nh = nf = NEG;
            nt = t_in;
        }
#pragma unroll
        for (int x = 0; x + 1 < NW; ++x)
            tn[x] = __funnelshift_r(tn[x], tn[x + 1], 4);
        tn[NW - 1] = (tn[NW - 1] >> 4) | (nt << (4 * ((K - 1) % 8)));
        uint32_t sw[(K + 3) / 4];
        scores(qc, sw);
        // E's prefix terms A(o) = max(diag, F) - o_del - e_del + d (j + 1)
        // at j = jlo + o, and d j: row constants at the lane's first cell
        // plus d k.  A lane's cells past the band only reach E's of cells
        // past it, whose H the row sets to NEG, so the prefix takes them
        // unmasked.  DPX: __viaddmax_s32(a, b, c) = max(a + b, c).
        const int rc = d * (jlo + base + 1) - oe_del, dj = d * (jlo + base);
        int dg[K], P[K];
        uint32_t pk[NW];                           // the row's nibbles
#pragma unroll
        for (int x = 0; x < NW; ++x) pk[x] = 0;
        int run = FLOOR;
#pragma unroll
        for (int k = 0; k < K; ++k) {              // diagonal, F, E's terms
            const int kn = k + 1 < K ? k + 1 : k;
            const int hu = k + 1 < K ? H[kn] : nh;
            const int fu = k + 1 < K ? F[kn] : nf;
            dg[k] = H[k] + sext_byte(sw[k / 4], k % 4);
            const int hoe = hu - oe_ins;
            const int fn = __viaddmax_s32(fu, -p.e_ins, hoe);
            pk[k / 8] |= (uint32_t)(fn == hoe) << (4 * (k % 8) + 3);
            F[k] = base + k < width ? fn : NEG;
            // the cell fed by lane + 1's shuffle comes last in the prefix
            P[k] = run = max(run, max(dg[k], fn) + (rc + d * k));
        }
        int x = run;                               // inclusive max-scan (a
#pragma unroll                                     // low lane's shuffle
        for (int sh = 1; sh < 32; sh <<= 1)        // returns its own x)
            x = max(x, __shfl_up_sync(FULL, x, sh));
        // lanes before this one, then the row's carry (lane 0: the carry
        // alone, its own x pushed below it)
        const int ex = __viaddmax_s32(__shfl_up_sync(FULL, x, 1),
                                      lane == 0 ? FLOOR : 0, carry);
        // a cell's nibble: H == diagonal (bit 0), H == E (bit 1), E and F
        // closing (bits 2 and 3); bit 0 then bit 1 give the tie order
        int e0 = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {              // E, H and the decisions
            const int kp = k > 0 ? k - 1 : 0;
            const int djk = dj + d * k;
            const int E = k == 0 ? ex - dj
                                 : __viaddmax_s32(ex, -djk, P[kp] - djk);
            const int hn = __vimax3_s32(dg[k], F[k], E);
            uint32_t nib = (uint32_t)(hn == dg[k]) | ((uint32_t)(hn == E) << 1);
            if (k == 0) e0 = E;
            else nib |= (uint32_t)(E == H[kp] - oe_del) << 2;
            pk[k / 8] |= nib << (4 * (k % 8));
            H[k] = base + k < width ? hn : NEG;
        }
        int hl = __shfl_up_sync(FULL, H[K - 1], 1);  // H(i, j - 1) at k = 0
        if (lane == 0) hl = NEG;
        pk[0] |= (uint32_t)(e0 == hl - oe_del) << 2;
        if (base < width)
            store_nibbles<K>(dec + (size_t)(i - 1) * RB + base / 2, pk);
    }
    const int om = m - max(1, n - w);              // H(n, m)'s offset
    int sc = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k)
        if (base + k == om) sc = H[k];
    sc = __shfl_sync(FULL, sc, om / K);
    __syncwarp();
    // the traceback, up to 32 steps a ballot; every lane holds the walk's
    // state, lane 0 writes the runs, last first
    int i = n, j = m, st = 0, cur = -1, len = 0, k = 0, bad = 0;
    auto emit = [&](int op, int count) {
        if (op == cur) {
            len += count;
            return;
        }
        if (cur >= 0) {
            if (lane == 0) rbuf[k] = (len << 2) | cur;
            ++k;
        }
        cur = op;
        len = count;
    };
    while (i > 0 || j > 0) {
        if (i == 0) {                              // row 0: D to the corner
            if (st == 2) { bad = 1; break; }
            emit(OP_D, j);
            j = 0;
            continue;
        }
        if (j == 0) {                              // column 0: I
            if (st == 1) { bad = 1; break; }
            emit(OP_I, i);
            i = 0;
            continue;
        }
        const int r = i - (st == 1 ? 0 : lane), c = j - (st == 2 ? 0 : lane);
        bool ok = r >= 1 && c >= 1;
        int bb = 0;
        if (ok) {
            const int lo = max(1, r - w);
            ok = c >= lo && c <= min(m, r + w);
            if (ok) {
                const int o = c - lo;
                bb = dec[(size_t)(r - 1) * RB + (o >> 1)];
                bb = (bb >> ((o & 1) << 2)) & 15;
            }
        }
        if (st == 0) {
            const unsigned go = __ballot_sync(FULL, ok && (bb & 1));
            const int f = go == FULL ? 32 : __ffs(~go) - 1;
            const bool okf = __shfl_sync(FULL, (int)ok, f & 31);
            const int hdf = __shfl_sync(FULL, bb & 2 ? 1 : 2, f & 31);
            if (f > 0) {
                emit(OP_M, f);
                i -= f;
                j -= f;
            }
            if (f < 32 && i > 0 && j > 0) {
                if (!okf) { bad = 1; break; }      // off the band
                st = hdf;
            }
        } else {
            const int op = st == 1 ? OP_D : OP_I;
            const int cl = (bb >> (st == 1 ? 2 : 3)) & 1;
            const unsigned stop = __ballot_sync(FULL, !ok || cl);
            const int f = stop ? __ffs(stop) - 1 : 32;
            if (f < 32 && !__shfl_sync(FULL, (int)ok, f)) {
                bad = 1;                           // off the band, or E at
                break;                             // column 0 / F at row 0
            }
            const int steps = f < 32 ? f + 1 : 32;
            emit(op, steps);
            if (st == 1) j -= steps;
            else i -= steps;
            if (f < 32) st = 0;
        }
    }
    if (!bad && cur >= 0) emit(-1, 0);
    if (lane == 0) {
        score[t] = sc;
        nruns[t] = bad ? -1 : k;
    }
    __syncwarp();
    if (!bad)
        for (int x = lane; x < k; x += 32) out[x] = rbuf[k - 1 - x];
}

__global__ void __launch_bounds__(32 * WARPS)
galign_wide_kernel(const uint8_t* __restrict__ qs,
                   const uint8_t* __restrict__ ts, int qstride, int tstride,
                   const int32_t* __restrict__ ns,
                   const int32_t* __restrict__ ms,
                   const int32_t* __restrict__ ws,
                   const int64_t* __restrict__ order, int ntasks,
                   const int64_t* __restrict__ boff,
                   const int64_t* __restrict__ roff,
                   uint8_t* __restrict__ bits, int32_t* __restrict__ rows,
                   Params p, int run_stride, int32_t* __restrict__ score,
                   int32_t* __restrict__ nruns, int32_t* __restrict__ runs) {
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (g >= ntasks) return;
    const int64_t t = order[g];
    const int n = ns[t], m = ms[t];
    int32_t* out = runs + t * run_stride;
    const int w = max(ws[t], abs(n - m) + 3);
    const uint8_t* q = qs + t * qstride;
    const uint8_t* tg = ts + t * tstride;
    uint8_t* bt = bits + boff[t];
    int32_t* R = rows + roff[t];
    const int M1 = m + 1;
    const int oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
    const int d = p.e_del + min(0, p.o_del);
    const int wm = min(m, w), wn = min(n, w);

    for (int j = lane; j <= m; j += 32) {           // row 0
        R[j] = j == 0 ? 0 : (j <= wm ? -(p.o_del + p.e_del * j) : NEG);
        R[M1 + j] = NEG;
    }
    __syncwarp();
    for (int i = 1; i <= n; ++i) {
        const int32_t* Hu = R + ((i - 1) & 1) * 2 * M1;
        const int32_t* Fu = Hu + M1;
        int32_t* Hc = R + (i & 1) * 2 * M1;
        int32_t* Fc = Hc + M1;
        const int jlo = max(1, i - w), jhi = min(m, i + w);
        const int first = i <= wn ? -(p.o_ins + p.e_ins * i) : NEG;
        const int hleft = jlo == 1 ? first : NEG;
        int carry = max(NEG - p.e_del, hleft - oe_del) + d * jlo;
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
                diag = Hu[j - 1] + cell_score(qc, tg[j - 1], p.a, p.b);
                Fn = max(Fu[j] - p.e_ins, hu - oe_ins);
                fclose = Fn == hu - oe_ins;
                Hp = max(diag, Fn);
                A = Hp - oe_del + d * (j + 1);
            }
            int x = A;
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const int y = __shfl_up_sync(FULL, x, s);
                if (lane >= s) x = max(x, y);
            }
            int ex = __shfl_up_sync(FULL, x, 1);
            ex = lane == 0 ? carry : max(carry, ex);
            const int E = ex - d * j;
            const int Hn = max(Hp, E);
            int hl = __shfl_up_sync(FULL, Hn, 1);
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

template <int K, bool GLOBAL>
void* kernel_of() {
    return (void*)galign_kernel<K, GLOBAL>;
}

// The register path's kernel for K, or null for a K it was not built for.
void* pick(int k, bool global) {
    switch (k) {
        case 2: return global ? kernel_of<2, true>() : kernel_of<2, false>();
        case 4: return global ? kernel_of<4, true>() : kernel_of<4, false>();
        case 8: return global ? kernel_of<8, true>() : kernel_of<8, false>();
        case 16: return global ? kernel_of<16, true>() : kernel_of<16, false>();
        case 32: return global ? kernel_of<32, true>() : kernel_of<32, false>();
        default: return nullptr;
    }
}

// Let fn take smem bytes of dynamic shared memory (above 48 KB only after
// this attribute is raised).
cudaError_t allow_smem(void* fn, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute((const void*)fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

}  // namespace

extern "C" int galign(const void* qs, const void* ts, int qstride,
                      int tstride, const void* ns, const void* ms,
                      const void* ws, const void* order, int n_smem,
                      int n_global, int n_wide, const void* boff,
                      const void* roff, void* bits, void* rows, int k,
                      int slot, int a, int b, int o_del, int e_del,
                      int o_ins, int e_ins, int run_stride, void* score,
                      void* nruns, void* runs, void* stream) {
    const Params p{a, b, o_del, e_del, o_ins, e_ins};
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t* ord = (const int64_t*)order;
    for (int global = 0; global < 2; ++global) {
        const int count = global ? n_global : n_smem;
        if (count == 0) continue;
        void* fn = pick(k, global);
        if (fn == nullptr) return (int)cudaErrorInvalidValue;
        const int smem = global ? 0 : WARPS * slot;
        const cudaError_t e = allow_smem(fn, smem);
        if (e != cudaSuccess) return (int)e;
        const uint8_t* q8 = (const uint8_t*)qs;
        const uint8_t* t8 = (const uint8_t*)ts;
        const int32_t *n32 = (const int32_t*)ns, *m32 = (const int32_t*)ms,
                      *w32 = (const int32_t*)ws;
        const int64_t* o64 = ord + (global ? n_smem : 0);
        const int64_t* b64 = (const int64_t*)boff;
        uint8_t* g8 = (uint8_t*)bits;
        int32_t *s32 = (int32_t*)score, *r32 = (int32_t*)nruns,
                *u32 = (int32_t*)runs;
        void* args[] = {&q8, &t8, &qstride, &tstride, &n32, &m32, &w32,
                        &o64, (void*)&count, &b64, &g8, &slot, (void*)&p,
                        &run_stride, &s32, &r32, &u32};
        const cudaError_t le = cudaLaunchKernel(
            (const void*)fn, dim3((count + WARPS - 1) / WARPS),
            dim3(32 * WARPS), args, (size_t)smem, st);
        if (le != cudaSuccess) return (int)le;
    }
    if (n_wide > 0) {
        galign_wide_kernel<<<(n_wide + WARPS - 1) / WARPS, 32 * WARPS, 0,
                             st>>>(
            (const uint8_t*)qs, (const uint8_t*)ts, qstride, tstride,
            (const int32_t*)ns, (const int32_t*)ms, (const int32_t*)ws,
            ord + n_smem + n_global, n_wide, (const int64_t*)boff,
            (const int64_t*)roff, (uint8_t*)bits, (int32_t*)rows, p,
            run_stride, (int32_t*)score, (int32_t*)nruns, (int32_t*)runs);
    }
    return (int)cudaGetLastError();
}

// Load every galign kernel now (see fmocc_load in fmocc.cu).
extern "C" int galign_load() {
    cudaFuncAttributes a;
    for (int k = 2; k <= 32; k *= 2)
        for (int global = 0; global < 2; ++global) {
            const cudaError_t e = cudaFuncGetAttributes(&a, pick(k, global));
            if (e != cudaSuccess) return (int)e;
        }
    return (int)cudaFuncGetAttributes(&a, galign_wide_kernel);
}

// Resident CTAs a SM of the shared path's kernel for K at smem bytes of
// dynamic shared memory, into *blocks.
extern "C" int galign_occupancy(int k, int smem, void* blocks) {
    void* fn = pick(k, false);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        (int*)blocks, (const void*)fn, 32 * WARPS, (size_t)smem);
    return (int)e;
}
