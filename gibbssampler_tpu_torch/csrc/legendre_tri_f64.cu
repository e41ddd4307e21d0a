// Triangular Legendre contractions in float64 for Hopper (sm_90a):
// streaming kernels bound by the bytes of the table, on the FMA pipes, fed
// by a cp.async ring.  Plain C interface, loaded with ctypes.
//
// Replaces, for float64 operands, the Pallas TPU kernels of
// gibbssampler_tpu/sht/pallas_legendre.py:
//   legendre_synth_tri (:52, _synth_kernel, pallas_call :76)
//       out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
//   legendre_adj_tri   (:106, _adj_kernel, pallas_call :121)
//       out[m, c, l] = sum_r lam[m, l, r] g[m, r, c],  0 for l < m
// with the layouts of the float32 kernels (legendre_tri.cu): lam (L, L, nr)
// row-major, zero for l < m; x (L, C, L) with unit stride on l; g (L, nr, C)
// with unit stride on r or on c; synthesis out (L, nr, C) row-major; adjoint
// out (L, C, L) with unit stride on l, every element written (the zeros of
// l < m too: the wrapper allocates it with torch.empty).  The m-slab form
// (ms, M) is that of legendre_tri.cu: row i < M of every operand, of degree
// order ms[i]; ms = null is the full table (M = L, ms[i] = i).
// The ring-parity mode (synth_par_f64, adj_par_f64; entry points
// legendre_*_par_f64) is the one of legendre_tri.cu: a table over the
// ceil(nr / 2) north rings, the sums over even and odd l - m kept apart and
// mirrored into the south rings.  Its kernels are those below with every
// other degree row per stage; they are kernels of their own so that the
// dense ones keep their code.
//
// What bounds them: bytes.  The CG family calls them at C = 16 (8 chains x
// Re/Im).  At L 513, nr 65 one call does 2 nr C L(L+1)/2 = 274 MFLOP, 8.2 us
// at the H100 SXM data sheet's 33.5 TFLOP/s fp64 FMA rate, and must move
// 89.7 MB (table half 68.6 MB, batch half 16.9 MB, output 4.3 MB for the
// synthesis), 26.8 us at 3.35 TB/s; at nr 513 it is 64.6 us against
// 176.6 us.  Each table element read serves C FMAs, so at the byte rate the
// FMA pipes run at ~40% of their peak at C = 16 and ~80% at C = 32: the
// design has to move the table at full rate and waste few FMA slots.
//
// Design.
// - A batch tile equal to the call's columns: TC in {8, 16, 32} is picked
//   from C (C > 32 walks 32-column tiles in the grid), so no FMA and no
//   copy works on padding columns.  A thread holds a register tile of CT =
//   8 columns times 2 rings (synthesis) or 4 degree rows (adjoint): every
//   batch value it reads from shared memory serves 2 or 4 FMAs.
// - No padded ring tiles.  A synthesis block holds all of an m's rings
//   when they fit 256 threads (nr <= 255 at TC 16: 65, 83, 193, 211), else
//   the fewest tiles that fit, of sizes that differ by at most one (513 ->
//   3 x 171); only a block's last warp carries idle lanes.  The adjoint
//   contracts over the rings in chunks of at most 16, also of even sizes
//   (65 -> 5 x 13).
// - Each m's table slab lam[m, m:L, :] streams through a ring of 3
//   shared-memory stages filled by cp.async, two stages in flight while one
//   multiplies.  The synthesis stage is up to 32 whole degree rows of its
//   ring tile (~17 KB at nr 65: one contiguous span when the block holds
//   all rings); the adjoint stage is 128 degree rows x one ring chunk.
//   Copies are 16 bytes (cp.async.cg) where source and destination are
//   16-byte aligned: each row's place in shared memory is shifted by one
//   double so that its parity matches its source's, which lines up every
//   pair of a row whatever L, nr and the ring offset are (L 513, nr 65:
//   odd); a row's odd first or last element goes by an 8-byte cp.async.ca.
//   The batch side (x[m, c, l-chunk] beside the synthesis stage, g[m,
//   r-chunk, c] beside the adjoint's) rides in the same stage by 8-byte
//   copies along the operand's unit stride, stored [c][k] with an odd row
//   stride, so that neither the copies nor the broadcast reads conflict on
//   banks.  Table row strides are odd too (the adjoint's warp reads 32
//   rows at once).
// - More warps per slab without atomics.  A block's threads form row
//   groups (synthesis: up to 4, the rows k = g mod groups of each stage;
//   adjoint: 2, the rings k = g mod 2 of each chunk) whose partial sums meet
//   in shared memory in group order at the end of an m.
// - The triangle.  A synthesis block takes rows i and M-1-i in one
//   pipeline: m and L-1-m on the full table (L+1 degree rows whatever m
//   is), and on a slab whatever pair its caller put there (the m-sharded
//   transform orders each rank's ms so that the pair is (m, L-1-m) again).
//   The adjoint's blocks are the (m, 128-row pass) pairs that exist,
//   numbered pass-major (no block exits empty); on a slab, every (row, pass)
//   pair up to ceil(L / 128) passes, those past a row's triangle exiting at
//   once.  Each row's pass-0 block also writes the zeros of l < m, along l.
//   Every output is a sum in a fixed order, the same on a slab as on the
//   full table.
// What bounds them now (PERF.md section 6 has the measurements;
// chip_smoke.py --f64-parts times each part alone): no part alone.  At nr
// 65, C 16 the table stream without the products, and the products without
// the copies, each take 60-80% of the whole kernel's time (NVIDIA H100 80GB
// HBM3, 700 W); the products read their operands from shared memory, 8
// bytes a lane a load, so copies and products share its bandwidth and
// overlap only in part.  The fp64 tensor cores (DMMA), whose fragments
// read each operand once a warp, are the next step; TMA and wgmma are not
// used.
// Every launch goes to the caller's stream; each entry point returns
// cudaGetLastError() so that a refused launch reaches the wrapper.
//
// LEGENDRE_F64_PARTS (a bit set, 7 unless nvcc is given -D) keeps the table
// copies (1), the batch copies (2) and the products (4).  A build that
// leaves a part out computes a wrong result on purpose: it only serves to
// time the other parts alone.

#include <cuda_runtime.h>
#include <cstdint>

#ifndef LEGENDRE_F64_PARTS
#define LEGENDRE_F64_PARTS 7
#endif

namespace {

constexpr bool kTableCopies = LEGENDRE_F64_PARTS & 1;
constexpr bool kBatchCopies = LEGENDRE_F64_PARTS & 2;
constexpr bool kProducts = LEGENDRE_F64_PARTS & 4;

constexpr int kStages = 3;           // cp.async ring depth
constexpr int CT = 8;                // batch columns per thread
constexpr int kRingsPerThread = 2;   // synthesis: rings per thread
constexpr int kSynthMaxGroup = 256;  // synthesis: threads of a row group
constexpr int kSynthMaxGroups = 4;   // synthesis: row groups per block
constexpr int kSynthMaxThreads = 256;
constexpr int kSynthMinBlocks = 2;   // per SM: caps registers at 128
constexpr int kStageDoubles = 4096;  // synthesis table stage, ~32 KB
constexpr int kMaxStageRows = 32;    // synthesis: degree rows a stage
constexpr int kAdjRows = 32;         // adjoint: degree-row lanes
constexpr int kAdjRowsPerThread = 4;
constexpr int kAdjPass = kAdjRows * kAdjRowsPerThread;  // rows per block
constexpr int kAdjChunk = 16;        // adjoint: rings per stage, at most
constexpr int kAdjGroups = 2;        // adjoint: ring groups per block
constexpr int kAdjMinBlocks = 2;
// adjoint threads at the widest column tile, 32 columns
constexpr int kAdjMaxThreads = kAdjRows * (32 / CT) * kAdjGroups;
static_assert(kSynthMaxGroup <= kSynthMaxThreads, "a row group per block");

// the degree order of memory row i: ms[i], or i for the full table
__device__ __forceinline__ int degree(const int* ms, int i) {
  return ms ? __ldg(ms + i) : i;
}

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// the table ring
// ---------------------------------------------------------------------------

// parity of a double's address in units of 8 bytes
__device__ __forceinline__ int parity(const double* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 3) & 1;
}

// Where row k of a stage starts (in doubles, row stride RS odd): k RS, plus
// one where that parity differs from the row source's (par), so that every
// aligned pair of the source lands on an aligned pair of shared memory.
__device__ __forceinline__ int row_start(int k, int RS, int par) {
  return k * RS + (((k * RS) ^ par) & 1);
}

// The copy threads' share of a stage of rows x 16-byte units (nu units a
// row): a warp takes 32 / nu rows at a time when a row has at most 32
// units, else one row with its lanes striding over the units.  Set once per
// block, so that the copy loops divide nothing.
struct CopyLanes {
  int nu, per, sub, u0, step;
  __device__ CopyLanes(int R, int nthreads) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    nu = R / 2 + 1;  // units R doubles span, at either alignment
    per = nu <= 32 ? 32 / nu : 1;
    sub = nu <= 32 ? lane / nu : 0;
    u0 = nu <= 32 ? lane % nu : lane;
    step = (nthreads / 32) * per;
    sub += warp * per;
    if (nu <= 32 && lane >= per * nu) sub = -1;  // idle lanes of the warp
  }
};

// Rows [0, nrows) of R doubles, row k from src + k ld, into buf at
// row_start(k, RS, .); 16-byte copies for aligned pairs, 8-byte for a row's
// odd first or last element.  buf must be 16-byte aligned.
__device__ __forceinline__ void stage_rows(double* buf, const double* src,
                                           long long ld, int nrows, int R,
                                           int RS, const CopyLanes& cl) {
  if (cl.sub < 0 || R <= 0) return;
  for (int k = cl.sub; k < nrows; k += cl.step) {
    const double* s = src + k * ld;
    const int p0 = row_start(k, RS, parity(s));
    for (int u = cl.u0; u < cl.nu; u += 32) {
      const int pos = (p0 & ~1) + 2 * u;  // even: a 16-byte slot
      const int j = pos - p0;             // the element at pos, -1 .. R
      if (j >= R) break;
      if (j >= 0 && j + 1 < R) {
        cp_async16(buf + pos, s + j);
      } else if (j < 0) {
        cp_async8(buf + pos + 1, s);
      } else {
        cp_async8(buf + pos, s + j);
      }
    }
  }
}

// acc[i][j] += a[i] b[j ldb] for the thread's RT table rows and CT
// columns; b in shared memory, the same for every thread of a column group
template <int RT>
__device__ __forceinline__ void fma_rows(const double (&a)[RT],
                                         const double* b, int ldb,
                                         double (&acc)[RT][CT]) {
  if (!kProducts) {  // the table's shared-memory reads stay
    acc[0][0] += a[0];
    return;
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const double v = b[j * ldb];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i][j] = fma(a[i], v, acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// synthesis
// ---------------------------------------------------------------------------

// The synthesis plan, the same on host and device: ring tiles, the widest
// tile, ring lanes (a thread holds rings rr, rr + rh, .. of its tile), the
// threads of one row group (RT rings and 8 columns each), the row groups,
// the table stage's row stride and rows, dynamic shared memory.
struct SynthPlan {
  int ntr, rmax, rh, group, groups, rs, kl, xk, smem;
  __host__ __device__ SynthPlan(int nr, int tc) {
    const int ncg = tc / CT;
    const int lanes = (nr + kRingsPerThread - 1) / kRingsPerThread * ncg;
    ntr = (lanes + kSynthMaxGroup - 1) / kSynthMaxGroup;
    if (ntr < 1) ntr = 1;
    rmax = (nr + ntr - 1) / ntr;
    if (rmax < 1) rmax = 1;
    rh = (rmax + kRingsPerThread - 1) / kRingsPerThread;
    group = (rh * ncg + 31) / 32 * 32;
    groups = kSynthMaxThreads / group;
    groups = groups > kSynthMaxGroups ? kSynthMaxGroups : groups;
    rs = (rh * kRingsPerThread + 1) | 1;
    kl = kStageDoubles / rs;
    kl = kl < 2 ? 2 : (kl > kMaxStageRows ? kMaxStageRows : kl);
    xk = (kl + 1) | 1;
    smem = (kStages * (xk * tc + ((kl * rs + 1) & ~1)) +
            (groups - 1) * group * kRingsPerThread * CT) * 8;
  }
};

// Block (ring tile and column tile in x, row pair in y): `groups` row groups
// of `group` threads; group g multiplies the rows k = g mod groups of each
// stage, and the groups' sums meet in shared memory, in group order, at the
// end of each m.  Shared memory: per stage x [TC][XK] (XK odd: the copies,
// consecutive l, and the reads, one l, fall in distinct banks) and the rows
// [KL][RS] (RS > rh RT: a thread's last ring slot stays in its row); then
// the sums of groups 1.. [RT CT][groups - 1][group].
template <int TC>
__global__ void __launch_bounds__(kSynthMaxThreads, kSynthMinBlocks)
synth_tri_f64(const double* __restrict__ lam, const double* __restrict__ x,
              double* __restrict__ out, int L, int nr, int C, long long sxm,
              long long sxc, const int* __restrict__ ms, int M) {
  constexpr int NCG = TC / CT, RT = kRingsPerThread;
  extern __shared__ __align__(16) double smem[];
  const SynthPlan pl(nr, TC);
  const int KL = pl.kl, RS = pl.rs;
  const int TS = (KL * RS + 1) & ~1;
  const int G = pl.groups, GT = pl.group;
  const int XK = pl.xk;
  double* xbuf = smem;
  double* tbuf = smem + kStages * XK * TC;
  double* red = tbuf + kStages * TS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int grp = tid / GT, t = tid % GT;
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * TC;
  const int r_lo = tile * nr / pl.ntr;
  const int R = (tile + 1) * nr / pl.ntr - r_lo;
  // rows ia and ib of degrees ma and mb; the middle row of an odd M alone
  const int ia = blockIdx.y, ib = M - 1 - ia;
  const int ma = degree(ms, ia), mb = degree(ms, ib);
  const int na = (L - ma + KL - 1) / KL;
  const int nst = na + (ib > ia ? (L - mb + KL - 1) / KL : 0);
  const int rh = pl.rh, cg = t / rh, rr = t % rh;
  const bool active = cg < NCG && rr < R;
  const CopyLanes cl(R, nth);

  // stage q: degree rows [l0, l0 + KL) of the slab of row stage_i(q)
  auto stage_i = [&](int q) { return q < na ? ia : ib; };
  auto stage_l0 = [&](int q) {
    return q < na ? ma + q * KL : mb + (q - na) * KL;
  };
  auto issue = [&](int q) {
    if (q < nst) {
      const int ri = stage_i(q), l0 = stage_l0(q);
      const int nrows = min(KL, L - l0), s = q % kStages;
      if (kTableCopies)
        stage_rows(tbuf + s * TS,
                   lam + (static_cast<size_t>(ri) * L + l0) * nr + r_lo, nr,
                   nrows, R, RS, cl);
      // along l, x's unit stride: consecutive threads, consecutive l
      const double* xm = x + ri * sxm + l0;
      double* xs = xbuf + s * XK * TC;
      for (int i = tid; kBatchCopies && i < TC * KL; i += nth) {
        const int c = i / KL, k = i % KL;
        if (k < nrows && c0 + c < C)
          cp_async8(xs + c * XK + k, xm + (c0 + c) * sxc + k);
      }
    }
    cp_async_commit();
  };

  double acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0;

  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < nst; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the buffer of stage q - 1, which every thread has finished with
    issue(q + kStages - 1);
    const int ri = stage_i(q), l0 = stage_l0(q);
    if (active) {
      const int nrows = min(KL, L - l0), s = q % kStages;
      const double* ts = tbuf + s * TS + rr;
      const double* xs = xbuf + (s * TC + cg * CT) * XK;
      const int p0 = parity(lam + (static_cast<size_t>(ri) * L + l0) * nr +
                            r_lo);
      // four rows' loads, then their FMAs: the loads' latency overlaps
      int k = grp;
      for (; k + 3 * G < nrows; k += 4 * G) {
        double a[4][RT], v[4][CT];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ku = k + u * G;
          const double* row = ts + row_start(ku, RS, p0 ^ (ku & nr & 1));
#pragma unroll
          for (int i = 0; i < RT; ++i) a[u][i] = row[i * rh];
#pragma unroll
          for (int j = 0; j < CT; ++j) v[u][j] = xs[ku + j * XK];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (!kProducts) {
            acc[0][0] += a[u][0];
            continue;
          }
#pragma unroll
          for (int j = 0; j < CT; ++j)
#pragma unroll
            for (int i = 0; i < RT; ++i)
              acc[i][j] = fma(a[u][i], v[u][j], acc[i][j]);
        }
      }
      for (; k < nrows; k += G) {
        const double* row = ts + row_start(k, RS, p0 ^ (k & nr & 1));
        double a[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) a[i] = row[i * rh];
        fma_rows(a, xs + k, XK, acc);
      }
    }
    if (q == na - 1 || q == nst - 1) {  // the last stage of row ri's slab
      if (G > 1) {
        if (grp > 0) {
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j)
              red[((i * CT + j) * (G - 1) + grp - 1) * GT + t] = acc[i][j];
        }
        __syncthreads();
        if (grp == 0) {
          for (int h = 0; h < G - 1; ++h) {
#pragma unroll
            for (int i = 0; i < RT; ++i)
#pragma unroll
              for (int j = 0; j < CT; ++j)
                acc[i][j] += red[((i * CT + j) * (G - 1) + h) * GT + t];
          }
        }
      }
      if (active && grp == 0) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = rr + i * rh;
          if (r >= R) break;
          double* o = out + (static_cast<size_t>(ri) * nr + r_lo + r) * C;
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            const int c = c0 + cg * CT + j;
            if (c < C) o[c] = acc[i][j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.0;
    }
  }
  cp_async_wait<0>();
}

// The ring-parity synthesis (see below): synth_tri_f64's block, pipeline
// and row pairs, with nr the output's ring count and the table's nt =
// ceil(nr / 2) north rings.  Each row's stages run over the degrees l - m
// even (class 0), then l - m odd (class 1), a stage holding every other
// degree row (row stride 2 nt in the table, 2 in x), and the two classes'
// sums meet at the end of the row: north ring r takes S0 + S1, its mirror
// nr-1-r f (S0 - S1), the equator row (r = nt - 1 of an odd nr) S0 + S1
// alone.  Its own kernel, so that the dense one keeps its code.
template <int TC>
__global__ void __launch_bounds__(kSynthMaxThreads, kSynthMinBlocks)
synth_par_f64(const double* __restrict__ lam, const double* __restrict__ x,
              double* __restrict__ out, int L, int nr, int C, long long sxm,
              long long sxc, const int* __restrict__ ms, int M, double f) {
  constexpr int NCG = TC / CT, RT = kRingsPerThread;
  constexpr int DS = 2;  // degrees from one stage row to the next
  extern __shared__ __align__(16) double smem[];
  const int nt = (nr + 1) / 2;  // the table's rings
  const long long ld = static_cast<long long>(DS) * nt;  // its row stride
  const SynthPlan pl(nt, TC);
  const int KL = pl.kl, RS = pl.rs;
  const int TS = (KL * RS + 1) & ~1;
  const int G = pl.groups, GT = pl.group;
  const int XK = pl.xk;
  double* xbuf = smem;
  double* tbuf = smem + kStages * XK * TC;
  double* red = tbuf + kStages * TS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int grp = tid / GT, t = tid % GT;
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * TC;
  const int r_lo = tile * nt / pl.ntr;
  const int R = (tile + 1) * nt / pl.ntr - r_lo;
  // rows ia and ib of degrees ma and mb; the middle row of an odd M alone
  const int ia = blockIdx.y, ib = M - 1 - ia;
  const int ma = degree(ms, ia), mb = degree(ms, ib);
  // stage segments, one a (row, class): segment k (row ia's classes 0, 1,
  // then ib's) runs from stage s_k to s_(k+1), s0 = 0
  auto nstages = [&](int n) { return (n + KL - 1) / KL; };
  const int s1 = nstages((L - ma + 1) / 2);
  const int s2 = s1 + nstages((L - ma) / 2);
  const int s3 = ib > ia ? s2 + nstages((L - mb + 1) / 2) : s2;
  const int nst = ib > ia ? s3 + nstages((L - mb) / 2) : s3;
  auto seg = [&](int k) {
    return k <= 0 ? 0 : k == 1 ? s1 : k == 2 ? s2 : k == 3 ? s3 : nst;
  };
  const int rh = pl.rh, cg = t / rh, rr = t % rh;
  const bool active = cg < NCG && rr < R;
  const CopyLanes cl(R, nth);

  // stage q: the segment k, its row, first degree l0 and rows
  struct Stage { int k, ri, l0, nrows; };
  auto stage = [&](int q) {
    const int k = q < s1 ? 0 : q < s2 ? 1 : q < s3 ? 2 : 3;
    const int ri = k < 2 ? ia : ib, m = k < 2 ? ma : mb, p = k & 1;
    const int s = q - seg(k);
    return Stage{k, ri, m + p + DS * s * KL,
                 min(KL, (L - m - p + 1) / 2 - s * KL)};
  };
  auto issue = [&](int q) {
    if (q < nst) {
      const Stage st = stage(q);
      const int sl = q % kStages;
      if (kTableCopies)
        stage_rows(tbuf + sl * TS,
                   lam + (static_cast<size_t>(st.ri) * L + st.l0) * nt + r_lo,
                   ld, st.nrows, R, RS, cl);
      // along l, x's unit stride: consecutive threads, consecutive l
      const double* xm = x + st.ri * sxm + st.l0;
      double* xs = xbuf + sl * XK * TC;
      for (int i = tid; kBatchCopies && i < TC * KL; i += nth) {
        const int c = i / KL, k = i % KL;
        if (k < st.nrows && c0 + c < C)
          cp_async8(xs + c * XK + k, xm + (c0 + c) * sxc + DS * k);
      }
    }
    cp_async_commit();
  };

  double acc[RT][CT], acc0[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0;

  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < nst; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the buffer of stage q - 1, which every thread has finished with
    issue(q + kStages - 1);
    const Stage st = stage(q);
    const int ri = st.ri, l0 = st.l0;
    if (active) {
      const int nrows = st.nrows, s = q % kStages;
      const double* ts = tbuf + s * TS + rr;
      const double* xs = xbuf + (s * TC + cg * CT) * XK;
      const int p0 = parity(lam + (static_cast<size_t>(ri) * L + l0) * nt +
                            r_lo);
      // four rows' loads, then their FMAs: the loads' latency overlaps
      int k = grp;
      for (; k + 3 * G < nrows; k += 4 * G) {
        double a[4][RT], v[4][CT];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ku = k + u * G;
          // the row stride 2 nt is even: every row has the parity p0
          const double* row = ts + row_start(ku, RS, p0);
#pragma unroll
          for (int i = 0; i < RT; ++i) a[u][i] = row[i * rh];
#pragma unroll
          for (int j = 0; j < CT; ++j) v[u][j] = xs[ku + j * XK];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (!kProducts) {
            acc[0][0] += a[u][0];
            continue;
          }
#pragma unroll
          for (int j = 0; j < CT; ++j)
#pragma unroll
            for (int i = 0; i < RT; ++i)
              acc[i][j] = fma(a[u][i], v[u][j], acc[i][j]);
        }
      }
      for (; k < nrows; k += G) {
        const double* row = ts + row_start(k, RS, p0);
        double a[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) a[i] = row[i * rh];
        fma_rows(a, xs + k, XK, acc);
      }
    }
    // the last stage of a segment
    if (q == seg(st.k + 1) - 1) {
      if (G > 1) {
        if (grp > 0) {
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j)
              red[((i * CT + j) * (G - 1) + grp - 1) * GT + t] = acc[i][j];
        }
        __syncthreads();
        if (grp == 0) {
          for (int h = 0; h < G - 1; ++h) {
#pragma unroll
            for (int i = 0; i < RT; ++i)
#pragma unroll
              for (int j = 0; j < CT; ++j)
                acc[i][j] += red[((i * CT + j) * (G - 1) + h) * GT + t];
          }
        }
      }
      // class 0 ends: its sums wait for class 1's, unless class 1 is
      // empty (m = L - 1)
      if (!(st.k & 1) && seg(st.k + 2) > seg(st.k + 1)) {
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) acc0[i][j] = acc[i][j];
      } else if (active && grp == 0) {
        const bool only0 = !(st.k & 1);  // class 1 empty
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = rr + i * rh;
          if (r >= R) break;
          double* o = out + (static_cast<size_t>(ri) * nr + r_lo + r) * C;
          double* os = out + (static_cast<size_t>(ri) * nr + nr - 1 - r_lo -
                              r) * C;
          const bool south = r_lo + r < nr / 2;  // not the equator
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            const int c = c0 + cg * CT + j;
            if (c >= C) continue;
            const double s0 = only0 ? acc[i][j] : acc0[i][j];
            const double s1 = only0 ? 0.0 : acc[i][j];
            o[c] = s0 + s1;
            if (south) os[c] = f * (s0 - s1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.0;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// adjoint
// ---------------------------------------------------------------------------

// The adjoint plan: ring chunks, the widest chunk, the table stage's row
// stride, the threads of one ring group (kAdjRowsPerThread degree rows and
// 8 columns each), dynamic shared memory; par: the parity mode's second
// batch buffer (g's south rows) too.
struct AdjPlan {
  int nch, rcmax, rs, gk, group, smem;
  __host__ __device__ AdjPlan(int nr, int tc, bool par = false) {
    nch = (nr + kAdjChunk - 1) / kAdjChunk;
    if (nch < 1) nch = 1;
    rcmax = (nr + nch - 1) / nch;
    if (rcmax < 1) rcmax = 1;
    rs = (rcmax + 1) | 1;
    gk = rs;
    group = kAdjRows * (tc / CT);
    smem = (kStages * ((par ? 2 : 1) * gk * tc + ((kAdjPass * rs + 1) & ~1)) +
            (kAdjGroups - 1) * group * kAdjRowsPerThread * CT) * 8;
  }
};

// blocks: (m, pass) with pass j covering degrees [m + P j, m + P (j + 1))
// (P = kAdjPass) for every m with L - m > P j, pass-major
__host__ __device__ inline int adj_blocks(int L) {
  int n = 0;
  for (int j = 0; kAdjPass * j < L; ++j) n += L - kAdjPass * j;
  return n;
}

// Block (row, pass) in x, column tile in y: kAdjGroups ring groups; group h
// multiplies the rings k = h mod kAdjGroups of each chunk, and the groups'
// sums meet in shared memory, in group order, at the end.  Thread in a
// group: degree rows t % kAdjRows + i kAdjRows (i < kAdjRowsPerThread),
// column group t / kAdjRows.  Shared memory: per stage g [TC][GK] (GK odd)
// and the table rows [kAdjPass][RS]; then the sums of groups 1..
// [RA CT][kAdjGroups - 1][group].
template <int TC>
__global__ void __launch_bounds__(kAdjMaxThreads, kAdjMinBlocks)
adj_tri_f64(const double* __restrict__ lam, const double* __restrict__ g,
            double* __restrict__ out, int L, int nr, int C, long long sgm,
            long long sgr, long long sgc, long long som, long long soc,
            const int* __restrict__ ms, int M) {
  constexpr int G = kAdjGroups, RA = kAdjRowsPerThread;
  extern __shared__ __align__(16) double smem[];
  const AdjPlan pl(nr, TC);
  const int RS = pl.rs, RC = pl.rcmax, GK = pl.gk, nch = pl.nch;
  const int TS = (kAdjPass * RS + 1) & ~1;
  const int GT = pl.group;
  double* gbuf = smem;
  double* tbuf = smem + kStages * GK * TC;
  double* red = tbuf + kStages * TS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int grp = tid / GT, t = tid % GT;
  // (memory row i, degree m, pass): pass-major over the rows
  int i, m, pass;
  if (ms) {  // every (row, pass) pair; those past the row's triangle exit
    pass = blockIdx.x / M;
    i = blockIdx.x % M;
    m = degree(ms, i);
    if (m + kAdjPass * pass >= L) return;  // uniform across the block
  } else {  // the pairs that exist: rows m < L - P pass
    m = blockIdx.x;
    pass = 0;
    while (m >= L - kAdjPass * pass) {
      m -= L - kAdjPass * pass;
      ++pass;
    }
    i = m;
  }
  const int l_lo = m + kAdjPass * pass;
  const int nrows = min(kAdjPass, L - l_lo);
  const int c0 = blockIdx.y * TC;
  const int c1 = min(C, c0 + TC);
  double* out_m = out + i * som;

  if (pass == 0) {  // the zeros of l < m, this column tile, along l
    for (int c = c0; c < c1; ++c)
      for (int l = tid; l < m; l += nth) out_m[c * soc + l] = 0.0;
  }

  const double* lam_b = lam + (static_cast<size_t>(i) * L + l_lo) * nr;
  const double* g_m = g + i * sgm;
  const bool r_unit = sgr <= sgc;  // copy g along its unit stride
  const CopyLanes cl(RC, nth);
  auto issue = [&](int q) {
    if (q < nch) {
      const int r_lo = q * nr / nch, rc = (q + 1) * nr / nch - r_lo;
      const int s = q % kStages;
      if (kTableCopies)
        stage_rows(tbuf + s * TS, lam_b + r_lo, nr, nrows, rc, RS, cl);
      double* gs = gbuf + s * GK * TC;
      for (int i = tid; kBatchCopies && i < RC * TC; i += nth) {
        const int k = r_unit ? i % RC : i / TC;
        const int c = r_unit ? i / RC : i % TC;
        if (k < rc && c0 + c < C)
          cp_async8(gs + c * GK + k, g_m + (r_lo + k) * sgr + (c0 + c) * sgc);
      }
    }
    cp_async_commit();
  };

  const int row = t % kAdjRows, cg = t / kAdjRows;
  int prow[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i)
    prow[i] = parity(lam_b + static_cast<size_t>(row + i * kAdjRows) * nr);
  double acc[RA][CT];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0;

  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < nch; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(q + kStages - 1);
    if (row < nrows) {
      const int r_lo = q * nr / nch, rc = (q + 1) * nr / nch - r_lo;
      const int s = q % kStages;
      const double* ts[RA];
#pragma unroll
      for (int i = 0; i < RA; ++i)
        ts[i] = tbuf + s * TS +
                row_start(row + i * kAdjRows, RS, prow[i] ^ (r_lo & 1));
      const double* gs = gbuf + (s * TC + cg * CT) * GK;
#pragma unroll 2
      for (int k = grp; k < rc; k += G) {
        double a[RA];
#pragma unroll
        for (int i = 0; i < RA; ++i) a[i] = ts[i][k];
        fma_rows(a, gs + k, GK, acc);
      }
    }
  }
  cp_async_wait<0>();
  if (G > 1) {
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          red[((i * CT + j) * (G - 1) + grp - 1) * GT + t] = acc[i][j];
    }
    __syncthreads();
    if (grp == 0) {
      for (int h = 0; h < G - 1; ++h) {
#pragma unroll
        for (int i = 0; i < RA; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            acc[i][j] += red[((i * CT + j) * (G - 1) + h) * GT + t];
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int l = row + i * kAdjRows;
      if (l >= nrows) break;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = c0 + cg * CT + j;
        if (c < C) out_m[c * soc + l_lo + l] = acc[i][j];
      }
    }
  }
}

// The ring-parity adjoint (see below): adj_tri_f64's block, with the
// table's nt = ceil(nr / 2) north rings.  A block takes the degree rows
// l_lo + 2 k of one class p (l - m even or odd, row stride 2 nt in the
// table); every (row, class, pass) triple is a block, those past the
// triangle exiting at once.  Each stage also copies g's south rows nr-1-r
// (r < nr / 2; none for the equator) into a second buffer and adds them,
// times f (-1)^p, to the north rows before the products.  Its own kernel,
// so that the dense one keeps its code.
template <int TC>
__global__ void __launch_bounds__(kAdjMaxThreads, kAdjMinBlocks)
adj_par_f64(const double* __restrict__ lam, const double* __restrict__ g,
            double* __restrict__ out, int L, int nr, int C, long long sgm,
            long long sgr, long long sgc, long long som, long long soc,
            const int* __restrict__ ms, int M, double f) {
  constexpr int G = kAdjGroups, RA = kAdjRowsPerThread;
  constexpr int DS = 2;  // degrees from one row to the next
  extern __shared__ __align__(16) double smem[];
  const int nt = (nr + 1) / 2;  // the table's rings
  const long long ld = static_cast<long long>(DS) * nt;  // its row stride
  const AdjPlan pl(nt, TC, true);
  const int RS = pl.rs, RC = pl.rcmax, GK = pl.gk, nch = pl.nch;
  const int TS = (kAdjPass * RS + 1) & ~1;
  const int GT = pl.group;
  double* gbuf = smem;
  double* tbuf = smem + kStages * GK * TC;
  double* red = tbuf + kStages * TS;
  double* gbuf2 = red + (G - 1) * GT * RA * CT;  // g's south rows
  const int tid = threadIdx.x, nth = blockDim.x;
  const int grp = tid / GT, t = tid % GT;
  // (memory row i, degree m, class p, pass): pass-major over the rows
  const int pass = blockIdx.x / (2 * M);
  const int p = blockIdx.x / M % 2;
  const int i = blockIdx.x % M;
  const int m = degree(ms, i);
  if (kAdjPass * pass >= (L - m - p + 1) / 2) return;  // uniform
  const int l_lo = m + p + DS * kAdjPass * pass;
  const int nrows = min(kAdjPass, (L - l_lo + 1) / 2);
  const int c0 = blockIdx.y * TC;
  const int c1 = min(C, c0 + TC);
  double* out_m = out + i * som;

  if (pass == 0 && p == 0) {  // the zeros of l < m, this column tile, along l
    for (int c = c0; c < c1; ++c)
      for (int l = tid; l < m; l += nth) out_m[c * soc + l] = 0.0;
  }

  const double* lam_b = lam + (static_cast<size_t>(i) * L + l_lo) * nt;
  const double* g_m = g + i * sgm;
  const bool r_unit = sgr <= sgc;  // copy g along its unit stride
  const CopyLanes cl(RC, nth);
  const int ns = nr / 2;  // the north rings r < ns have a mirror
  auto issue = [&](int q) {
    if (q < nch) {
      const int r_lo = q * nt / nch, rc = (q + 1) * nt / nch - r_lo;
      const int s = q % kStages;
      if (kTableCopies)
        stage_rows(tbuf + s * TS, lam_b + r_lo, ld, nrows, rc, RS, cl);
      double* gs = gbuf + s * GK * TC;
      double* gs2 = gbuf2 + s * GK * TC;
      for (int i = tid; kBatchCopies && i < RC * TC; i += nth) {
        const int k = r_unit ? i % RC : i / TC;
        const int c = r_unit ? i / RC : i % TC;
        if (k < rc && c0 + c < C) {
          cp_async8(gs + c * GK + k, g_m + (r_lo + k) * sgr + (c0 + c) * sgc);
          if (r_lo + k < ns)
            cp_async8(gs2 + c * GK + k,
                      g_m + (nr - 1 - r_lo - k) * sgr + (c0 + c) * sgc);
        }
      }
    }
    cp_async_commit();
  };

  const int row = t % kAdjRows, cg = t / kAdjRows;
  int prow[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i)
    prow[i] = parity(lam_b + static_cast<size_t>(row + i * kAdjRows) * ld);
  double acc[RA][CT];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0;

  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < nch; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(q + kStages - 1);
    {  // g north + f (-1)^p g south, the equator row alone
      const int r_lo = q * nt / nch, rc = (q + 1) * nt / nch - r_lo;
      const double sg = p ? -f : f;
      double* gs = gbuf + (q % kStages) * GK * TC;
      const double* gs2 = gbuf2 + (q % kStages) * GK * TC;
      for (int e = tid; e < RC * TC; e += nth) {
        const int k = e % RC, c = e / RC;
        if (k < rc && r_lo + k < ns && c0 + c < C)
          gs[c * GK + k] = fma(sg, gs2[c * GK + k], gs[c * GK + k]);
      }
      __syncthreads();
    }
    if (row < nrows) {
      const int r_lo = q * nt / nch, rc = (q + 1) * nt / nch - r_lo;
      const int s = q % kStages;
      const double* ts[RA];
#pragma unroll
      for (int i = 0; i < RA; ++i)
        ts[i] = tbuf + s * TS +
                row_start(row + i * kAdjRows, RS, prow[i] ^ (r_lo & 1));
      const double* gs = gbuf + (s * TC + cg * CT) * GK;
#pragma unroll 2
      for (int k = grp; k < rc; k += G) {
        double a[RA];
#pragma unroll
        for (int i = 0; i < RA; ++i) a[i] = ts[i][k];
        fma_rows(a, gs + k, GK, acc);
      }
    }
  }
  cp_async_wait<0>();
  if (G > 1) {
    if (grp > 0) {
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          red[((i * CT + j) * (G - 1) + grp - 1) * GT + t] = acc[i][j];
    }
    __syncthreads();
    if (grp == 0) {
      for (int h = 0; h < G - 1; ++h) {
#pragma unroll
        for (int i = 0; i < RA; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            acc[i][j] += red[((i * CT + j) * (G - 1) + h) * GT + t];
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int l = row + i * kAdjRows;
      if (l >= nrows) break;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = c0 + cg * CT + j;
        if (c < C) out_m[c * soc + l_lo + DS * l] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// PAR: nr is the output's ring count, the table's ceil(nr / 2)
template <int TC, bool PAR = false>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int C, long long sxm, long long sxc, const int* ms, int M,
                 cudaStream_t stream, double f = 1.0) {
  const SynthPlan pl(PAR ? (nr + 1) / 2 : nr, TC);
  const dim3 grid(pl.ntr * ((C + TC - 1) / TC), (M + 1) / 2);
  const auto* lam_ = static_cast<const double*>(lam);
  const auto* x_ = static_cast<const double*>(x);
  auto* out_ = static_cast<double*>(out);
  if constexpr (PAR) {
    const cudaError_t e = allow_smem(synth_par_f64<TC>, pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    synth_par_f64<TC><<<grid, pl.group * pl.groups, pl.smem, stream>>>(
        lam_, x_, out_, L, nr, C, sxm, sxc, ms, M, f);
  } else {
    const cudaError_t e = allow_smem(synth_tri_f64<TC>, pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    synth_tri_f64<TC><<<grid, pl.group * pl.groups, pl.smem, stream>>>(
        lam_, x_, out_, L, nr, C, sxm, sxc, ms, M);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TC, bool PAR = false>
int launch_adj(const void* lam, const void* g, void* out, int L, int nr,
               int C, long long sgm, long long sgr, long long sgc,
               long long som, long long soc, const int* ms, int M,
               cudaStream_t stream, double f = 1.0) {
  const AdjPlan pl(PAR ? (nr + 1) / 2 : nr, TC, PAR);
  const int blocks =
      PAR ? 2 * M * (((L + 1) / 2 + kAdjPass - 1) / kAdjPass)
      : ms ? M * ((L + kAdjPass - 1) / kAdjPass) : adj_blocks(L);
  const dim3 grid(blocks, (C + TC - 1) / TC);
  const auto* lam_ = static_cast<const double*>(lam);
  const auto* g_ = static_cast<const double*>(g);
  auto* out_ = static_cast<double*>(out);
  if constexpr (PAR) {
    const cudaError_t e = allow_smem(adj_par_f64<TC>, pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    adj_par_f64<TC><<<grid, pl.group * kAdjGroups, pl.smem, stream>>>(
        lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms, M, f);
  } else {
    const cudaError_t e = allow_smem(adj_tri_f64<TC>, pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    adj_tri_f64<TC><<<grid, pl.group * kAdjGroups, pl.smem, stream>>>(
        lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms, M);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x[i, c, l] at x + i * sxm + c * sxc + l; ms: null (M = L, row i of degree
// i) or M int32 degree orders on the device
int legendre_synth_tri_f64(const void* lam, const void* x, void* out, int L,
                           int nr, int C, long long sxm, long long sxc,
                           const void* ms, int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(ms);
  if (C <= 8)
    return launch_synth<8>(lam, x, out, L, nr, C, sxm, sxc, m, M, s);
  if (C <= 16)
    return launch_synth<16>(lam, x, out, L, nr, C, sxm, sxc, m, M, s);
  return launch_synth<32>(lam, x, out, L, nr, C, sxm, sxc, m, M, s);
}

// g[i, r, c] at g + i * sgm + r * sgr + c * sgc;
// out[i, c, l] at out + i * som + c * soc + l; ms as above
int legendre_adj_tri_f64(const void* lam, const void* g, void* out, int L,
                         int nr, int C, long long sgm, long long sgr,
                         long long sgc, long long som, long long soc,
                         const void* ms, int M, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(ms);
  if (C <= 8)
    return launch_adj<8>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc, m,
                         M, s);
  if (C <= 16)
    return launch_adj<16>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc, m,
                          M, s);
  return launch_adj<32>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc, m,
                        M, s);
}

// The ring-parity modes (lam (M, L, ceil(nr / 2)), see synth_tri_f64 and
// adj_tri_f64): arguments as above, flip selecting the table's opposite
// reflection parity.
int legendre_synth_par_f64(const void* lam, const void* x, void* out, int L,
                           int nr, int C, long long sxm, long long sxc,
                           const void* ms, int M, int flip, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(ms);
  const double f = flip ? -1.0 : 1.0;
  if (C <= 8)
    return launch_synth<8, true>(lam, x, out, L, nr, C, sxm, sxc, m, M, s, f);
  if (C <= 16)
    return launch_synth<16, true>(lam, x, out, L, nr, C, sxm, sxc, m, M, s,
                                  f);
  return launch_synth<32, true>(lam, x, out, L, nr, C, sxm, sxc, m, M, s, f);
}

int legendre_adj_par_f64(const void* lam, const void* g, void* out, int L,
                         int nr, int C, long long sgm, long long sgr,
                         long long sgc, long long som, long long soc,
                         const void* ms, int M, int flip, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(ms);
  const double f = flip ? -1.0 : 1.0;
  if (C <= 8)
    return launch_adj<8, true>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc,
                               m, M, s, f);
  if (C <= 16)
    return launch_adj<16, true>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                                soc, m, M, s, f);
  return launch_adj<32, true>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc,
                              m, M, s, f);
}

// Threads per block and dynamic shared memory (bytes) of one launch at
// (nr, C): adj 0 for the synthesis, 1 for the adjoint; returns
// threads << 20 | bytes.
int legendre_tri_f64_plan(int adj, int nr, int C) {
  const int tc = C <= 8 ? 8 : (C <= 16 ? 16 : 32);
  if (adj) {
    const AdjPlan pl(nr, tc);
    return pl.group * kAdjGroups << 20 | pl.smem;
  }
  const SynthPlan pl(nr, tc);
  return pl.group * pl.groups << 20 | pl.smem;
}

}  // extern "C"
