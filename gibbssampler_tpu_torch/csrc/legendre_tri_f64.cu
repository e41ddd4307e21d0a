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
// mirrored into the south rings (synthesis) or g's south rings folded onto
// the north ones (adjoint).  Both run on the fp64 tensor cores (mma.sync
// m8n8k4) with both classes in one block: the synthesis keeps both
// classes' sums in its MMA accumulators, on stages of consecutive degree
// rows stored by class; the adjoint computes both classes of 128 rows l a
// block on a run_ring of its own, g folded into U+- once a stage.  Both are
// kernels of their own so that the dense ones keep their code.
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
// 65, C 16 the dense pair's table stream without the products, and the
// products without the copies, each take 60-80% of the whole kernel's time
// (NVIDIA H100 80GB HBM3, 700 W); their products read their operands from
// shared memory, 8 bytes a lane a load, so copies and products share its
// bandwidth and overlap only in part.  The fp64 tensor cores (DMMA), whose
// fragments read each operand once a warp, are the next step for the dense
// pair (both parity kernels take it, at 41-61% of their bound); TMA and
// wgmma are not used.
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

// 16-byte asynchronous copy of the first n (0 to 16) bytes at src, zeros
// for the rest; src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16n(void* dst, const void* src,
                                            int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(d),
               "l"(src), "r"(n));
}

// Chunk j of a row whose vb valid bytes start at p (8-byte aligned): the
// row lands in whole 16-byte chunks from p rounded down, so that byte p + d
// sits at dst + (p & 15) + d; the rest of a chunk reads as zeros, and a row
// with no valid byte reads nothing.  The bytes before p that the first
// chunk reads lie in the same allocation (CUDA allocations are aligned to
// far more than 16 bytes) and are never used.
__device__ __forceinline__ void copy_chunk(double* dst, const double* p,
                                           int vb, int j) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int sh = static_cast<int>(a & 15);
  const int n = vb > 0 ? min(max(sh + vb - 16 * j, 0), 16) : 0;
  cp_async16n(dst + 2 * j,
              reinterpret_cast<const void*>(a - sh + (n ? 16 * j : 0)), n);
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

// The ring-parity synthesis (synth_par_f64): out[i, r, c] = SE + SO and
// out[i, nr-1-r, c] = f (SE - SO) for the nt = ceil(nr / 2) north rings r
// (r < nr / 2 for the mirror: the equator row of an odd nr once), SE and SO
// the sums over l - m even and odd.  On the fp64 tensor cores:
// mma.sync.m8n8k4 with M = rings, N = columns, K = degrees.
// - A warp owns 16 rings (two m8 tiles) by the block's TC columns (TC / 8
//   n8 tiles) and keeps both classes' sums in its MMA accumulators for the
//   whole of a row: 2 x 2 x TC / 8 fragments of 2 doubles, 32 doubles a
//   thread at TC 32.  Nothing is parked and nothing spills.
// - A stage is 2 KL = 32 consecutive degree rows of the row's slab, so its
//   table span is contiguous: 16-byte cp.async where source and shared
//   memory pair up, as in stage_rows (each row shifted by its source's
//   parity; the rows of one class share it, their source stride 2 nt
//   being even).  Row l0 + j goes to slot parity_slot(j): the even l - m
//   in rows [0, KL), the odd in [KL, 2 KL), so each k4 step is of one
//   class.  x[i, c, l0 .. l0 + 2 KL) is copied contiguously along l (8
//   bytes each, no stride-2 gather) into the same slots of [TC][XS]
//   (XS = 36: the 32 lanes' B reads hit 16 bank pairs twice, the fewest).
//   Table rows have stride RS = 16 W + 8 (W warps): the lanes' A reads
//   (4 rows x 8 rings) fill 16 bank pairs twice, and a warp's 16 rings
//   stay in their row.  Rows and columns past the data are zero-filled.
// - Ring tiles: the fewest of at most par_max_warps(TC) warps, of sizes
//   that differ by at most one (257 rings: 3 tiles of 86 rings, 6 warps;
//   512 at TC 32: 6 tiles of 86, 6 warps); column tiles TC in {8, 16, 32}
//   picked from C (C > 32 walks 32-column tiles in the grid); rows i and
//   M-1-i in one pipeline, as synth_tri_f64's (L + 1 degree rows a block
//   on the full table).  At the last stage of a row each thread writes its
//   sums' fragments straight to the output, north and south, and zeroes
//   them.
// - kParStages = 2 stages of 2 KL table rows and TC x XS batch doubles
//   (one in flight while one multiplies): at nt 257, TC 32, 2 x (32 x 104
//   + 32 x 36) x 8 bytes = 70 KB and 192 threads a block, two blocks an SM;
//   at TC 16, three.  Measured on an H100 (PERF.md, kernel_ab.py
//   --variant): 2 stages of 32 rows beat 4 of 16, and 6 warps beat 4.
// What bounds it: bytes (the half table, 271 MB at L 513, nr 513); at C 32
// its 2.2 GFLOP take 0.032 ms at the 67 TFLOP/s DMMA peak.
constexpr int kParWarpRings = 16;  // rings of a warp: two m8 tiles
// warps a block at most: 6 at TC 32, so that two blocks an SM leave each
// thread 170 registers (its 32 accumulator doubles and the operands of a
// stage's k4 steps, loaded ahead; 128 spilled), else 8
__host__ __device__ constexpr int par_max_warps(int tc) {
  return tc == 32 ? 6 : 8;
}
constexpr int kParKL = 16;         // degree rows of one class a stage
constexpr int kParStages = 2;
constexpr int kParXS = 2 * kParKL + 4;

// the parity synthesis' plan, the same on host and device: ring tiles,
// warps a block, the table stage's row stride, dynamic shared memory
struct SynthParPlan {
  int ntr, warps, rs, smem;
  __host__ __device__ SynthParPlan(int nt, int tc) {
    const int wt = (nt + kParWarpRings - 1) / kParWarpRings;
    ntr = (wt + par_max_warps(tc) - 1) / par_max_warps(tc);
    if (ntr < 1) ntr = 1;
    warps = (wt + ntr - 1) / ntr;
    if (warps < 1) warps = 1;
    rs = kParWarpRings * warps + 8;
    smem = kParStages * (2 * kParKL * rs + tc * kParXS) * 8;
  }
};

__device__ __forceinline__ void cp_async8z(double* dst, const double* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" :: "r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

// d += a b, an 8 x 8 x 4 fp64 MMA: a = A[gid][tig], b = B[tig][gid],
// d = D[gid][2 tig + (0, 1)] (gid = lane / 4, tig = lane % 4)
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// grid (ring tile and column tile in x, row pair in y); blockDim 32 warps
template <int TC>
__global__ void __launch_bounds__(32 * par_max_warps(TC), 2)
synth_par_f64(const double* __restrict__ lam, const double* __restrict__ x,
              double* __restrict__ out, int L, int nr, int C, long long sxm,
              long long sxc, const int* __restrict__ ms, int M, double f) {
  constexpr int NT = TC / 8, KL = kParKL, XS = kParXS;
  extern __shared__ __align__(16) double smem[];
  const int nt = (nr + 1) / 2;  // the table's rings
  const SynthParPlan pl(nt, TC);
  const int RS = pl.rs, TS = 2 * KL * RS;
  double* tbuf = smem;
  double* xbuf = smem + kParStages * TS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * TC;
  const int r_lo = tile * nt / pl.ntr;
  const int R = (tile + 1) * nt / pl.ntr - r_lo;
  const int wr0 = warp * kParWarpRings;  // the warp's first ring in the tile
  // rows ia and ib of degrees ma and mb; the middle row of an odd M alone
  const int ia = blockIdx.y, ib = M - 1 - ia;
  const int ma = degree(ms, ia), mb = degree(ms, ib);
  const int na = (L - ma + 2 * KL - 1) / (2 * KL);
  const int nst = na + (ib > ia ? (L - mb + 2 * KL - 1) / (2 * KL) : 0);
  const CopyLanes cl(R, nth);

  // stage q: degree rows l0 .. l0 + nrows of row ri's slab
  struct Stage { int ri, l0, nrows; };
  auto stage = [&](int q) {
    const int ri = q < na ? ia : ib;
    const int l0 = q < na ? ma + 2 * KL * q : mb + 2 * KL * (q - na);
    return Stage{ri, l0, min(2 * KL, L - l0)};
  };
  auto issue = [&](int q) {
    if (q < nst) {
      const Stage st = stage(q);
      double* tb = tbuf + (q % kParStages) * TS;
      const double* src =
          lam + (static_cast<size_t>(st.ri) * L + st.l0) * nt + r_lo;
      if (kTableCopies && cl.sub >= 0) {
        // row j to slot parity_slot(j), shifted by its source's parity
        for (int j = cl.sub; j < 2 * KL; j += cl.step) {
          const double* s = src + static_cast<size_t>(j) * nt;
          const int d = ((j & 1) * KL + (j >> 1)) * RS + parity(s);
          const bool ok = j < st.nrows;
          for (int u = cl.u0; u < cl.nu; u += 32) {
            const int pos = (d & ~1) + 2 * u;  // even: a 16-byte slot
            const int e = pos - d;             // the element at pos, -1 .. R
            if (e >= R) break;
            if (!ok) {  // past the slab: zeros
              tb[pos] = 0.0;
              tb[pos + 1] = 0.0;
            } else if (e >= 0 && e + 1 < R) {
              cp_async16(tb + pos, s + e);
            } else if (e < 0) {
              cp_async8(tb + pos + 1, s);
            } else {
              cp_async8(tb + pos, s + e);
            }
          }
        }
      }
      // along l, x's unit stride: consecutive threads, consecutive l
      const double* xm = x + st.ri * sxm + st.l0;
      double* xb = xbuf + (q % kParStages) * TC * XS;
      for (int e = tid; kBatchCopies && e < TC * 2 * KL; e += nth) {
        const int c = e / (2 * KL), j = e % (2 * KL);
        const bool ok = j < st.nrows && c0 + c < C;
        cp_async8z(xb + c * XS + (j & 1) * KL + (j >> 1),
                   ok ? xm + (c0 + c) * sxc + j : xm, ok);
      }
    }
    cp_async_commit();
  };

  double acc[2][2][NT][2];  // [class][m8 tile][n8 tile][fragment]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n) acc[p][mt][n][0] = acc[p][mt][n][1] = 0.0;

  for (int q = 0; q < kParStages - 1; ++q) issue(q);
  for (int q = 0; q < nst; ++q) {
    cp_async_wait<kParStages - 2>();
    __syncthreads();
    // the buffer of stage q - 1, which every thread has finished with
    issue(q + kParStages - 1);
    const Stage st = stage(q);
    if (wr0 < R) {  // uniform across the warp
      const double* tb = tbuf + (q % kParStages) * TS;
      const double* xb = xbuf + (q % kParStages) * TC * XS;
      // class 0's rows have the parity of row l0's source, class 1's that
      // of row l0 + 1's
      const int p0 = parity(lam + (static_cast<size_t>(st.ri) * L + st.l0) *
                                      nt + r_lo);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const double* ta = tb + p * KL * RS + (p0 ^ (p & nt & 1)) + wr0 +
                           gid + tig * RS;
        const double* xa = xb + gid * XS + p * KL + tig;
        const int steps = ((st.nrows + 1 - p) / 2 + 3) / 4;  // k4 steps
#pragma unroll
        for (int kk = 0; kk < KL / 4; ++kk) {
          if (kk >= steps) break;
          const double a0 = ta[4 * kk * RS], a1 = ta[4 * kk * RS + 8];
          double b[NT];
#pragma unroll
          for (int n = 0; n < NT; ++n) b[n] = xa[n * 8 * XS + 4 * kk];
          if (!kProducts) {  // the shared-memory reads stay
            acc[p][0][0][0] += a0 + a1 + b[0];
            continue;
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            dmma(acc[p][0][n], a0, b[n]);
            dmma(acc[p][1][n], a1, b[n]);
          }
        }
      }
    }
    if (q == na - 1 || q == nst - 1) {  // the last stage of row ri's slab
      if (wr0 < R) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wr0 + mt * 8 + gid;
          if (r < R) {
            const int rr = r_lo + r;
            double* o = out + (static_cast<size_t>(st.ri) * nr + rr) * C;
            double* os = out + (static_cast<size_t>(st.ri) * nr + nr - 1 -
                                rr) * C;
            const bool south = rr < nr / 2;  // not the equator
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = c0 + n * 8 + 2 * tig + h;
                if (c < C) {
                  const double se = acc[0][mt][n][h], so = acc[1][mt][n][h];
                  o[c] = se + so;
                  if (south) os[c] = f * (se - so);
                }
              }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            acc[p][mt][n][0] = acc[p][mt][n][1] = 0.0;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// adjoint
// ---------------------------------------------------------------------------

// The adjoint plan: ring chunks, the widest chunk, the table stage's row
// stride, the threads of one ring group (kAdjRowsPerThread degree rows and
// 8 columns each), dynamic shared memory.
struct AdjPlan {
  int nch, rcmax, rs, gk, group, smem;
  __host__ __device__ AdjPlan(int nr, int tc) {
    nch = (nr + kAdjChunk - 1) / kAdjChunk;
    if (nch < 1) nch = 1;
    rcmax = (nr + nch - 1) / nch;
    if (rcmax < 1) rcmax = 1;
    rs = (rcmax + 1) | 1;
    gk = rs;
    group = kAdjRows * (tc / CT);
    smem = (kStages * (gk * tc + ((kAdjPass * rs + 1) & ~1)) +
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

// The ring-parity adjoint (adj_par_f64): out[i, c, l] = sum_{r < nt}
// lam[i, l, r] U_p(l)[r, c], U+- = g[r] +- f g[nr-1-r] (r < nr / 2; the
// equator ring of an odd nr alone), p(l) = (l - m) mod 2 choosing the sign;
// zero for l < m.  On the fp64 tensor cores: mma.sync.m8n8k4 with M = rows
// l, N = columns, K = rings.
// - A block computes both classes of the rows l = l0 .. l0 + 2 BM (BM of
//   each) for a tile of TC columns, so g's north and south rings are staged
//   once for both, and streams k = r over the nt north rings in stages of
//   KC rings through a run_ring of its own (copies DEPTH stages ahead, a
//   staging pass, the products).
// - The rows of one class are 2 nt doubles apart and share one 16-byte
//   alignment: the table tile of class p goes by 16-byte cp.async straight
//   into its slot (no staging pass), over the rings k0 - sh_p .. k0 - sh_p +
//   KC (sh_p = 1 where row l0 + p starts at an odd double; its ring -1,
//   which belongs to the row before, lands as zero).  Rows RS = KC + 4
//   doubles apart: the lanes' A reads (8 rows x 4 rings) fill 16 bank pairs
//   twice, the fewest.
// - g lands in whole 16-byte chunks along its unit stride (north rings k0 -
//   1 .. k0 + KC - 1 and their south mirrors); the staging pass forms U+-
//   in fp64 (exact products, one rounding, as the plain version) once a
//   stage for both classes, over the rings of each class's table tile, so
//   that the k axes agree: U_p [c][j] at ring k0 - sh_p + j, RS apart too.
// - Warps: four a class, each 16 rows (two m8 tiles) by all TC columns, so
//   each k4 step loads 2 + TC / 8 operands for 2 TC / 8 DMMAs and each
//   operand is read once a warp.
// - 16 rings a stage, two in flight: 74.0 / 88.0 KB at 16 / 32 columns, two
//   blocks an SM.  Measured and slower (PERF.md): 32-ring stages (256-byte
//   row pieces, one block an SM), 32-row classes.
// - The epilogue writes the rows of both classes as one run of l a column
//   (through shared memory, each column shifted to its run's 16-byte
//   alignment), a warp a column, in 16-byte stores; the row tile that
//   starts at l = m writes each column's zeros of l < m right before its
//   run, so that the column's row l = 0 .. l0 + 2 BM is one sweep.
constexpr int kAdjParRows = 64;   // rows of each class a block
constexpr int kAdjParRings = 16;  // rings a stage
constexpr int kAdjParWarps = 8;   // four a class
constexpr int kAdjParDepth = 2;   // stages in flight

// dst[j] = src[shift(dst) + j] for j < n (src 16-byte aligned in shared
// memory), or 0 where src is null, by one warp: 16-byte stores along the
// run, 8-byte ones at its two ends
__device__ __forceinline__ void store_run(double* dst, const double* src,
                                          int n, int lane) {
  const int s = parity(dst);
  double* base = dst - s;  // 16-byte aligned
  for (int q = lane; 2 * q < s + n; q += 32) {
    const double2 v = src ? *reinterpret_cast<const double2*>(src + 2 * q)
                          : make_double2(0.0, 0.0);
    const int j = 2 * q - s;  // the run's element at base[2 q]
    if (j >= 0 && j + 2 <= n) {
      *reinterpret_cast<double2*>(base + 2 * q) = v;
    } else {
      if (j >= 0 && j < n) base[2 * q] = v.x;
      if (j + 1 >= 0 && j + 1 < n) base[2 * q + 1] = v.y;
    }
  }
}

// the ring of AdjParF64: stage s's copies (K::issue) go K::DEPTH stages
// ahead; once they have landed, the staging pass (K::stage) forms the
// stage's U+- and the products (K::mma) read them.  The first barrier of a
// stage sees its copies landed and the products of the stage before done
// (U+- free), the second U+- written (g's landing slot free again).
template <class K>
__device__ __forceinline__ void run_ring(K& k, int KT) {
#pragma unroll
  for (int s = 0; s < K::DEPTH; ++s) {
    if (s < KT) k.issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<K::DEPTH - 1>();  // stage kt has landed (this thread's copies) ...
    __syncthreads();                // ... and everyone's
    k.stage(kt);
    __syncthreads();
    if (kt + K::DEPTH < KT) k.issue(kt + K::DEPTH);
    cp_async_commit();
    k.mma(kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// KUNIT: g with unit stride on r (else on c)
template <int TC, bool KUNIT>
struct AdjParF64 {
  static constexpr int BM = kAdjParRows, KC = kAdjParRings;
  static constexpr int DEPTH = kAdjParDepth, THREADS = 32 * kAdjParWarps;
  static constexpr int WR = 2 * BM / kAdjParWarps;  // rows of a warp
  static constexpr int MT = WR / 8, NT = TC / 8;
  static constexpr int RS = KC + 4;             // table [p BM + i'][ring]
  static constexpr int T_SLOT = 2 * BM * RS;    // doubles; DEPTH + 1 slots
  static constexpr int GR = KC + 1;             // landed rings k0 - 1 ..
  static constexpr int GW = KUNIT ? GR + 1 : TC + 2;  // doubles a landed g row
  static constexpr int GCH = GW / 2;            // [c][ring] (KUNIT) : [ring][c]
  static constexpr int G_TILE = (KUNIT ? TC : GR) * GW;  // north, south
  static constexpr int G_OFF = (DEPTH + 1) * T_SLOT;
  static constexpr int U_OFF = G_OFF + DEPTH * 2 * G_TILE;
  static constexpr int MAIN = U_OFF + 2 * TC * RS;  // U_p [c][ring]
  static constexpr int SO = 2 * BM + 4;         // epilogue [c][l - l0]
  static constexpr int SMEM = 8 * (MAIN > TC * SO ? MAIN : TC * SO);
  static constexpr int MIN_BLOCKS = SMEM <= 113 * 1024 ? 2 : 1;
  static_assert(RS % 16 == 4 && GW % 2 == 0 && G_TILE % 2 == 0 &&
                KC % 4 == 0 && WR % 8 == 0,
                "conflict-free fragment reads; 16-byte chunks; k4 steps");

  double* sm;
  const double* tab;          // lam[i, l0, 0]
  const double* gp;           // g[i, 0, c0]
  long long rowd, sgr, sgc;   // doubles from one table row to the next; g's strides
  int nh, nr, cv, iv0, iv1;   // iv0 / iv1: rows of even / odd l - m
  int sh0, sh1, gs0;          // the classes' ring shifts; gp's address in doubles mod 2
  double f;
  int tid, lane, cls, wr0;    // the warp's class and first row in it
  double acc[MT][NT][2];

  // where a landed g row starts (doubles): from element e of column c
  // (KUNIT), or of ring e (unit stride on c)
  __device__ __forceinline__ int gshift(int c, int e) const {
    return KUNIT ? (gs0 + (c & 1) * static_cast<int>(sgc & 1) + e) & 1
                 : (gs0 + (e & 1) * static_cast<int>(sgr & 1)) & 1;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n) acc[mt][n][0] = acc[mt][n][1] = 0.0;
  }

  // each class's table rows over its rings k0 - sh_p ..; north g[r, c] and
  // south g[nr - 1 - r, c] for r = k0 - 1 .. k0 + KC - 1 (KUNIT: each
  // column's memory rings, the south ones in reverse)
  __device__ __forceinline__ void issue(int s) {
    const int k0 = s * KC;
    if (kTableCopies) {
      double* T = sm + (s % (DEPTH + 1)) * T_SLOT;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ivp = p ? iv1 : iv0, shp = p ? sh1 : sh0;
        for (int e = tid; e < BM * KC / 2; e += THREADS) {
          const int ip = e / (KC / 2), w = e % (KC / 2);
          const int r = k0 - shp + 2 * w;  // the pair's first ring
          const double* src = tab + (p + 2LL * ip) * rowd + r;
          double* dst = T + (p * BM + ip) * RS + 2 * w;
          if (ip >= ivp || r >= nh) {  // zeros, from an aligned address
            cp_async16n(dst, tab - parity(tab), 0);
          } else if (r < 0) {  // ring -1 is the row before's: a zero
            cp_async8z(dst, src, false);
            cp_async8z(dst + 1, src + 1, true);
          } else {
            cp_async16n(dst, src, r + 1 < nh ? 16 : 8);
          }
        }
      }
    }
    if (kBatchCopies) {
      double* gn = sm + G_OFF + (s % DEPTH) * 2 * G_TILE;
      double* gs = gn + G_TILE;
      if constexpr (KUNIT) {
        const int nlo = max(k0 - 1, 0), nv = max(min(nh, k0 + KC) - nlo, 0);
        const int slo = max(nr - k0 - KC, 0);
        const int sv = min(nr - k0, nr - 1) + 1 - slo;
        for (int e = tid; e < TC * GCH; e += THREADS) {
          const int c = e / GCH, j = e - c * GCH;
          const double* col = gp + c * sgc;
          copy_chunk(gn + c * GW, col + nlo, c < cv ? 8 * nv : 0, j);
          copy_chunk(gs + c * GW, col + slo, c < cv ? 8 * sv : 0, j);
        }
      } else {
        for (int e = tid; e < GR * GCH; e += THREADS) {
          const int t = e / GCH, j = e - t * GCH, r = k0 - 1 + t;
          copy_chunk(gn + t * GW, gp + r * sgr,
                     r >= 0 && r < nh ? 8 * cv : 0, j);
          copy_chunk(gs + t * GW, gp + (nr - 1 - r) * sgr,
                     r >= 0 && r < nr / 2 ? 8 * cv : 0, j);
        }
      }
    }
  }

  // U_p[c][j] = g_n + sg_p g_s at ring k0 - sh_p + j, sg_p = f for even
  // l - m, -f for odd; zero past the rings
  __device__ __forceinline__ void stage(int s) {
    const double* gn = sm + G_OFF + (s % DEPTH) * 2 * G_TILE;
    const double* gs = gn + G_TILE;
    const int k0 = s * KC;
    const int nlo = max(k0 - 1, 0), slo = max(nr - k0 - KC, 0);
    for (int e = tid; e < TC * KC / 2; e += THREADS) {
      const int c = e / (KC / 2), q = e % (KC / 2);
      // rings k0 - 1 + 2 q + d
      double vn[3], vs[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int t = 2 * q + d, r = k0 - 1 + t;
        if constexpr (KUNIT) {
          vn[d] = r >= 0 ? gn[c * GW + gshift(c, nlo) + r - nlo] : 0.0;
          vs[d] = r >= 0 && r < nr / 2
                      ? gs[c * GW + gshift(c, slo) + nr - 1 - r - slo]
                      : 0.0;
        } else {
          vn[d] = gn[t * GW + gshift(0, r) + c];
          vs[d] = gs[t * GW + gshift(0, nr - 1 - r) + c];
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const double sg = p ? -f : f;
        const int o = (p ? sh1 : sh0) ? 0 : 1;  // ring k0 - sh_p + 2 q at d = o
        *reinterpret_cast<double2*>(sm + U_OFF + (p * TC + c) * RS + 2 * q) =
            make_double2(vn[o] + sg * vs[o], vn[o + 1] + sg * vs[o + 1]);
      }
    }
  }

  // the k4 steps that hold rings, for the warp's rows (rows past iv_p and
  // columns past cv hold zeros)
  __device__ __forceinline__ void mma(int s) {
    if (wr0 >= (cls ? iv1 : iv0)) return;  // uniform across the warp
    const double* T =
        sm + (s % (DEPTH + 1)) * T_SLOT + (cls * BM + wr0) * RS;
    const double* U = sm + U_OFF + cls * TC * RS;
    const int r0 = s * KC - (cls ? sh1 : sh0);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KC / 4; ++kk) {
      if (r0 + 4 * kk >= nh) break;  // uniform across the warp
      double a[MT], b[NT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a[mt] = T[(mt * 8 + gid) * RS + 4 * kk + tig];
#pragma unroll
      for (int n = 0; n < NT; ++n) b[n] = U[(n * 8 + gid) * RS + 4 * kk + tig];
      if (!kProducts) {  // the shared-memory reads stay
        acc[0][0][0] += a[0] + b[0];
        continue;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n) dmma(acc[mt][n], a[mt], b[n]);
    }
  }

  // out[c * soc + l - l0] for c < cv, l - l0 < lv, through shared memory
  // [c][l - l0] (each column shifted to its run's 16-byte alignment), then
  // whole runs along l, a warp a column, each right after the column's
  // zeros at out[c * soc - zeros ..]
  __device__ __forceinline__ void finish(double* out, long long soc, int lv,
                                         int zeros) {
    const int gid = lane >> 2, tig = lane & 3;
    // d[h] = D[gid][2 tig + h]: row wr0 + 8 mt + gid of class cls, column
    // 8 n + 2 tig + h
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = cls + 2 * (wr0 + 8 * mt + gid), c = 8 * n + 2 * tig + h;
          sm[c * SO + parity(out + c * soc) + l] = acc[mt][n][h];
        }
    __syncthreads();
    for (int c = tid >> 5; c < cv; c += THREADS / 32) {
      if (zeros > 0) store_run(out + c * soc - zeros, nullptr, zeros, lane);
      store_run(out + c * soc, sm + c * SO, min(2 * BM, lv), lane);
    }
  }
};

// grid (c tiles of TC, ceil(L / 2 BM), row i): tile y computes the rows l0
// = m + 2 BM y .. l0 + 2 BM; tile 0 also writes the zeros of l < m; tiles
// past the row's triangle return at once
template <int TC, bool KUNIT>
__global__ void __launch_bounds__(AdjParF64<TC, KUNIT>::THREADS,
                                  AdjParF64<TC, KUNIT>::MIN_BLOCKS)
adj_par_f64(const double* __restrict__ lam, const double* __restrict__ g,
            double* __restrict__ out, int L, int nr, int C, long long sgm,
            long long sgr, long long sgc, long long som, long long soc,
            const int* __restrict__ ms, double f) {
  using K = AdjParF64<TC, KUNIT>;
  extern __shared__ __align__(16) double smem[];
  const int i = blockIdx.z, m = degree(ms, i);
  const int nh = (nr + 1) / 2;  // the table's rings
  const int c0 = blockIdx.x * TC;
  const int l0 = m + static_cast<int>(blockIdx.y) * 2 * K::BM;
  if (l0 >= L) return;  // uniform across the block
  const int warp = threadIdx.x >> 5;
  K k;
  k.sm = smem;
  k.tab = lam + (static_cast<long long>(i) * L + l0) * nh;              // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                                        // g[i, 0, c0]
  k.rowd = nh;
  k.sgr = sgr;
  k.sgc = sgc;
  k.nh = nh;
  k.nr = nr;
  k.cv = min(TC, C - c0);
  k.iv0 = min(K::BM, (L - l0 + 1) / 2);  // rows l0 + 2 i' < L
  k.iv1 = min(K::BM, (L - l0) / 2);      // rows l0 + 1 + 2 i' < L
  k.sh0 = parity(k.tab);
  k.sh1 = parity(k.tab + nh);
  k.gs0 = parity(k.gp);
  k.f = f;
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.cls = warp / (kAdjParWarps / 2);
  k.wr0 = warp % (kAdjParWarps / 2) * K::WR;
  k.zero();
  run_ring(k, (nh + K::KC) / K::KC);  // rings -1 .. nh - 1
  k.finish(out + i * som + c0 * soc + l0, soc, L - l0,
           blockIdx.y == 0 ? m : 0);
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

template <int TC>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int C, long long sxm, long long sxc, const int* ms, int M,
                 cudaStream_t stream) {
  const SynthPlan pl(nr, TC);
  const dim3 grid(pl.ntr * ((C + TC - 1) / TC), (M + 1) / 2);
  const cudaError_t e = allow_smem(synth_tri_f64<TC>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  synth_tri_f64<TC><<<grid, pl.group * pl.groups, pl.smem, stream>>>(
      static_cast<const double*>(lam), static_cast<const double*>(x),
      static_cast<double*>(out), L, nr, C, sxm, sxc, ms, M);
  return static_cast<int>(cudaGetLastError());
}

// nr is the output's ring count, the table's ceil(nr / 2)
template <int TC>
int launch_synth_par(const void* lam, const void* x, void* out, int L,
                     int nr, int C, long long sxm, long long sxc,
                     const int* ms, int M, cudaStream_t stream, double f) {
  const SynthParPlan pl((nr + 1) / 2, TC);
  const dim3 grid(pl.ntr * ((C + TC - 1) / TC), (M + 1) / 2);
  const cudaError_t e = allow_smem(synth_par_f64<TC>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  synth_par_f64<TC><<<grid, 32 * pl.warps, pl.smem, stream>>>(
      static_cast<const double*>(lam), static_cast<const double*>(x),
      static_cast<double*>(out), L, nr, C, sxm, sxc, ms, M, f);
  return static_cast<int>(cudaGetLastError());
}

// resident blocks an SM of the parity synthesis at (nt, TC) on the current
// card; -1 where the runtime refuses the query
template <int TC>
int synth_par_blocks(int nt) {
  const SynthParPlan pl(nt, TC);
  int n = 0;
  if (allow_smem(synth_par_f64<TC>, pl.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, synth_par_f64<TC>, 32 * pl.warps, pl.smem) != cudaSuccess)
    return -1;
  return n;
}

template <int TC>
int launch_adj(const void* lam, const void* g, void* out, int L, int nr,
               int C, long long sgm, long long sgr, long long sgc,
               long long som, long long soc, const int* ms, int M,
               cudaStream_t stream) {
  const AdjPlan pl(nr, TC);
  const int blocks = ms ? M * ((L + kAdjPass - 1) / kAdjPass) : adj_blocks(L);
  const dim3 grid(blocks, (C + TC - 1) / TC);
  const cudaError_t e = allow_smem(adj_tri_f64<TC>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  adj_tri_f64<TC><<<grid, pl.group * kAdjGroups, pl.smem, stream>>>(
      static_cast<const double*>(lam), static_cast<const double*>(g),
      static_cast<double*>(out), L, nr, C, sgm, sgr, sgc, som, soc, ms, M);
  return static_cast<int>(cudaGetLastError());
}

// nr is g's ring count, the table's ceil(nr / 2)
template <int TC, bool KUNIT>
int launch_adj_par(const void* lam, const void* g, void* out, int L, int nr,
                   int C, long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* ms, int M,
                   cudaStream_t stream, double f) {
  using K = AdjParF64<TC, KUNIT>;
  const dim3 grid((C + TC - 1) / TC, (L + 2 * K::BM - 1) / (2 * K::BM), M);
  const cudaError_t e = allow_smem(adj_par_f64<TC, KUNIT>, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  adj_par_f64<TC, KUNIT><<<grid, K::THREADS, K::SMEM, stream>>>(
      static_cast<const double*>(lam), static_cast<const double*>(g),
      static_cast<double*>(out), L, nr, C, sgm, sgr, sgc, som, soc, ms, f);
  return static_cast<int>(cudaGetLastError());
}

template <int TC>
int launch_adj_par(const void* lam, const void* g, void* out, int L, int nr,
                   int C, long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* ms, int M,
                   cudaStream_t stream, double f) {
  if (sgr == 1)
    return launch_adj_par<TC, true>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                    som, soc, ms, M, stream, f);
  if (sgc == 1)
    return launch_adj_par<TC, false>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                     som, soc, ms, M, stream, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// resident blocks an SM of the parity adjoint (g with unit stride on r) at
// TC on the current card; -1 where the runtime refuses the query
template <int TC>
int adj_par_blocks() {
  using K = AdjParF64<TC, true>;
  int n = 0;
  if (allow_smem(adj_par_f64<TC, true>, K::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, adj_par_f64<TC, true>, K::THREADS, K::SMEM) != cudaSuccess)
    return -1;
  return n;
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
    return launch_synth_par<8>(lam, x, out, L, nr, C, sxm, sxc, m, M, s, f);
  if (C <= 16)
    return launch_synth_par<16>(lam, x, out, L, nr, C, sxm, sxc, m, M, s, f);
  return launch_synth_par<32>(lam, x, out, L, nr, C, sxm, sxc, m, M, s, f);
}

// g with unit stride on r (sgr 1) or on c (sgc 1)
int legendre_adj_par_f64(const void* lam, const void* g, void* out, int L,
                         int nr, int C, long long sgm, long long sgr,
                         long long sgc, long long som, long long soc,
                         const void* ms, int M, int flip, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(ms);
  const double f = flip ? -1.0 : 1.0;
  if (C <= 8)
    return launch_adj_par<8>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc,
                             m, M, s, f);
  if (C <= 16)
    return launch_adj_par<16>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc,
                              m, M, s, f);
  return launch_adj_par<32>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc,
                            m, M, s, f);
}

// Threads per block and dynamic shared memory (bytes) of one launch at
// (nr, C), as threads << 20 | bytes: kind 0 the synthesis, 1 the adjoint,
// 2 the parity synthesis, 4 the parity adjoint with g's unit stride on r
// (nr the output's or g's rings); the resident blocks an SM on the current
// card (-1 if refused) of the parity synthesis (kind 3) and the parity
// adjoint (kind 5).
int legendre_tri_f64_plan(int kind, int nr, int C) {
  const int tc = C <= 8 ? 8 : (C <= 16 ? 16 : 32);
  if (kind == 1) {
    const AdjPlan pl(nr, tc);
    return pl.group * kAdjGroups << 20 | pl.smem;
  }
  if (kind == 2) {
    const SynthParPlan pl((nr + 1) / 2, tc);
    return 32 * pl.warps << 20 | pl.smem;
  }
  if (kind == 3)
    return tc == 8 ? synth_par_blocks<8>((nr + 1) / 2)
           : tc == 16 ? synth_par_blocks<16>((nr + 1) / 2)
                      : synth_par_blocks<32>((nr + 1) / 2);
  if (kind == 4)
    return tc == 8 ? AdjParF64<8, true>::THREADS << 20 | AdjParF64<8, true>::SMEM
           : tc == 16
               ? AdjParF64<16, true>::THREADS << 20 | AdjParF64<16, true>::SMEM
               : AdjParF64<32, true>::THREADS << 20 | AdjParF64<32, true>::SMEM;
  if (kind == 5)
    return tc == 8 ? adj_par_blocks<8>()
           : tc == 16 ? adj_par_blocks<16>() : adj_par_blocks<32>();
  const SynthPlan pl(nr, tc);
  return pl.group * pl.groups << 20 | pl.smem;
}

}  // extern "C"
