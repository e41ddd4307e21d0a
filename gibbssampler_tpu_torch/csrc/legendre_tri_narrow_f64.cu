// Triangular Legendre contractions of a narrow table (bfloat16 or float32)
// with a float64 batch, for Hopper (sm_90a): the table read in its own
// dtype and widened in registers, the batch rounded to the table dtype,
// the exact products summed in float64.  Plain C interface, loaded with
// ctypes.
//
// Replaces, for a bfloat16 or float32 table under float64 compute, the
// Pallas TPU kernels of gibbssampler_tpu/sht/pallas_legendre.py:
//   legendre_synth_tri (:52, _synth_kernel, pallas_call :76)
//       out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
//   legendre_adj_tri   (:106, _adj_kernel, pallas_call :121)
//       out[m, c, l] = sum_r lam[m, l, r] g[m, r, c],  0 for l < m
// which the JAX package runs, in this mode, as the einsums of its
// sht/lcore.py (einsum(lam, b.astype(table_dtype),
// preferred_element_type=float64)).  Layouts, the m-slab form (ms, M) and
// the ring-parity mode (a table over the ceil(nr / 2) north rings, the sums
// over even and odd l - m kept apart and mirrored into the south rings, or
// g's south rings folded onto the north ones) are those of
// legendre_tri_f64.cu: lam (M, L, nt) row-major, zero for l < m; x (M, C,
// L) with unit stride on l; g (M, nr, C) with unit stride on r or on c;
// synthesis out (M, nr, C) row-major; adjoint out (M, C, L) with unit
// stride on l, every element written (the zeros of l < m too).
//
// The rounding is the JAX package's: a batch value bound for bfloat16 goes
// float64 -> float32 (__double2float_rn) -> bfloat16 (__float2bfloat16_rn),
// never in one step, as XLA's and torch's conversions do (one rounding
// would differ at values such as 1 + 2^-8 + 2^-30); the parity adjoint folds
// g[r] + f (-1)^(l+m) g[nr-1-r] in float64 and rounds the fold (JAX's
// U = (Gn + Gs).astype(table_dtype)).  The product of two rounded values is
// exact in float64, so every output is a float64 sum of exact products; only
// the order of the sums differs from the plain version's.
//
// What bounds them: bytes, once the products run on the fp64 tensor cores.
// At the CG family's C = 16 columns (8 chains x Re/Im), L 513, nr 513, one
// dense call does 2 nr C L(L+1)/2 = 2.16 GFLOP: 0.032 ms at the 67 TFLOP/s
// of DMMA and 0.065 ms at the 33.5 TFLOP/s of the FMA pipes, against
// 0.0555 ms (bfloat16) and 0.0958 ms (float32) for its bytes at 3.35 TB/s.
// So the dense pair multiplies on DMMA, in the m16n8k8 shape: an H100 issues
// mma.sync.m8n8k4.f64 at half the rate (33 against 67 TFLOP/s, measured with
// registers only), which is as slow as the FMA pipes.  The parity pair,
// still on the FMA pipes, cannot reach its bfloat16 bound.
//
// Design of the dense pair (synth_narrow, adj_narrow; the fp64 parity
// kernels of legendre_tri_f64.cu are the model).
// - The table stays narrow in shared memory.  Each row's piece of a stage
//   lands by 16-byte cp.async from its start rounded down to 16 bytes, at
//   its own byte shift (a bfloat16 row at odd nr starts at any even byte of
//   a chunk), and each lane widens its A element to float64 as it loads it,
//   at its row's shift: no realignment pass.  Why rows and not the stage's
//   one contiguous span: in a span the rows of an MMA step are nr es bytes
//   apart, which puts the four rows a warp reads on the same banks (4-way at
//   nr 65 in bfloat16), and ring tiles (nr 513) cut the span anyway.  Row
//   slots are 32 bytes apart mod 128 in the synthesis (a warp's A read of 4
//   rows x 16 or 32 bytes: conflict-free in bfloat16, at most 2-way in
//   float32) and 80 bytes in the adjoint (8 rows x 8 or 16 bytes: at most
//   2-way).
// - The batch lands beside each stage in 16-byte chunks along its unit
//   stride and is rounded once a stage, in a staging pass, into a [c][k]
//   tile of doubles (B, the adjoint's U) that every warp reads, its rows
//   k + 4 doubles long so that a warp's B fragment fills 16 bank pairs
//   twice, the fewest.
// - Stages go through run_ring: copies DEPTH = 2 stages ahead, then the
//   staging pass, then the products; DEPTH + 1 table slots, DEPTH landing
//   slots for the batch, one B tile.
// - Synthesis: M = rings, N = columns, K = degrees.  A warp owns 16 rings
//   (one m16 tile) while one block of at most 8 such warps holds every
//   ring, else 32 (two m16 tiles: half the B reads a product and half the
//   ring tiles, each of which stages the batch again), x TC columns (TC in
//   {8, 16, 32} from C, so the table is read once at every C <= 32; C > 32
//   walks 32-column tiles in the grid), and keeps its sums in its MMA
//   accumulators for a whole row.  Ring tiles: the fewest of at most 8
//   warps, of sizes that differ by at most one ring (nr 65: one tile on 5
//   warps of 16 rings; 513: 3 tiles of 171 rings on 6 warps of 32).  Rows
//   i and M-1-i run in one pipeline (L + 1 degree rows a block on the full
//   table; on a slab the pair its caller put there).  A stage is 32 degree
//   rows (rows 8 apart share a shift, so a lane's two rows of each k8 step
//   keep theirs over the stage).  At the last stage of a row each lane
//   writes its sums straight to the output.
// - Adjoint: M = rows l, N = columns, K = rings.  A block computes BM = 256
//   rows l (8 warps of 32 rows, two m16 tiles) x TC columns and streams the
//   nt rings in stages of 64 bytes of each row (KC = 32 bfloat16 or 16
//   float32 rings), so each row keeps its byte shift from stage to stage
//   and a lane computes its rows' offsets once.  Blocks are the (m, row tile) pairs
//   that exist, numbered pass-major, as adj_tri_f64's (no block exits
//   empty; on a slab every (row, tile) pair, those past a row's triangle
//   exiting at once).  The epilogue writes each column's run of l through
//   shared memory in 16-byte stores (store_run), a warp a column, and the
//   row tile that starts at l = m writes each column's zeros of l < m right
//   before its run: an H100 writes a (C, M, L) output near its memset rate
//   only in whole-row sweeps (PERF.md).
// Design of the parity pair (first version, simple and right, one stage in
// flight).
// - Synthesis: a thread a ring (a block one ring tile of at most 128 rings
//   of one row i, of sizes that differ by at most one tile of 32), a block
//   NC = 16 batch columns.  Each thread streams its ring's column of the
//   table straight from global memory into registers, KL = 32 degree rows
//   a stage, the next stage's loads issued before the current stage's
//   products.  The stage's batch values x[i, c, l0:l0+KL], rounded, sit in
//   shared memory, read by every thread at once (broadcast).  Two sums a
//   column: a stage starts at an even l - m, so the class of each unrolled
//   step is known at compile time.
// - Adjoint: a thread a degree row (a block 128 rows of one row i), a block
//   NC columns.  Each stage stages a 128 x KR (32 rings) table tile in
//   shared memory in the table dtype, by coalesced loads along r, rows at an
//   odd word stride, and the folds U and V of the KR x NC batch tile,
//   rounded.  Each warp holds rows of one class of l - m (threads 0-63 the
//   even class, 64-127 the odd one), so that a warp reads one of U and V.
// Every launch goes to the caller's stream; each entry point returns
// cudaGetLastError() so that a refused launch reaches the wrapper.
//
// LEGENDRE_NARROW_PARTS (a bit set, 15 unless nvcc is given -D) keeps the
// dense pair's copies (1), staging pass (2), products (4) and stores (8).
// A build that leaves a part out computes a wrong result on purpose: it only
// serves to time the other parts alone (kernel_ab.py --variant).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#ifndef LEGENDRE_NARROW_PARTS
#define LEGENDRE_NARROW_PARTS 15
#endif

namespace {

constexpr bool kCopies = LEGENDRE_NARROW_PARTS & 1;
constexpr bool kStaging = LEGENDRE_NARROW_PARTS & 2;
constexpr bool kProducts = LEGENDRE_NARROW_PARTS & 4;
constexpr bool kStores = LEGENDRE_NARROW_PARTS & 8;

// the parity pair
constexpr int NC = 16;            // batch columns a block
constexpr int KL = 32;            // synthesis: degree rows a stage
constexpr int kMaxRingTile = 128;  // synthesis: threads (rings) a block
constexpr int KR = 32;            // adjoint: rings a stage
constexpr int LT = 128;           // adjoint: threads (degree rows) a block
static_assert(KL % 2 == 0, "a stage starts at an even l - m");

// the degree order of memory row i: ms[i], or i for the full table
__device__ __forceinline__ int degree(const int* ms, int i) {
  return ms ? __ldg(ms + i) : i;
}

template <typename T>
struct Narrow;

template <>
struct Narrow<__nv_bfloat16> {
  // parity adjoint table tile rows: 34 elements, an odd number (17) of words
  static constexpr int kTileStride = KR + 2;
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ double round(double v) {
    return static_cast<double>(
        __bfloat162float(__float2bfloat16_rn(__double2float_rn(v))));
  }
};

template <>
struct Narrow<float> {
  // parity adjoint table tile rows: 33 words
  static constexpr int kTileStride = KR + 1;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ double round(double v) {
    return static_cast<double>(__double2float_rn(v));
  }
};

// the table element of type T at byte address p (shared memory), in float64
template <typename T>
__device__ __forceinline__ double wide(const unsigned char* p) {
  return static_cast<double>(
      Narrow<T>::widen(*reinterpret_cast<const T*>(p)));
}

// ---------------------------------------------------------------------------
// PTX helpers (as legendre_tri_f64.cu's)
// ---------------------------------------------------------------------------

// 16-byte asynchronous copy of the first n (0 to 16) bytes at src, zeros
// for the rest; src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16n(void* dst, const void* src,
                                            int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// byte address of p mod 16
__device__ __forceinline__ int shift16(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// parity of a double's address in units of 8 bytes
__device__ __forceinline__ int parity(const double* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 3) & 1;
}

// Chunk j of a run of vb valid bytes from p (any alignment): the run lands
// in whole 16-byte chunks from p rounded down, so that byte p + d sits at
// dst + (p & 15) + d (dst 16-byte aligned); the rest of a chunk reads as
// zeros, and a run with no valid byte reads nothing (the caller then passes
// a p it holds valid).  The bytes before p that the first chunk reads lie
// in the same allocation (CUDA allocations are aligned to far more than 16
// bytes) and are never used.
__device__ __forceinline__ void copy_chunk(void* dst, const void* p, int vb,
                                           int j) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int sh = static_cast<int>(a & 15);
  const int n = vb > 0 ? min(max(sh + vb - 16 * j, 0), 16) : 0;
  cp_async16n(static_cast<unsigned char*>(dst) + 16 * j,
              reinterpret_cast<const void*>(a - sh + (n ? 16 * j : 0)), n);
}

// d += a b, a 16 x 8 x 8 fp64 MMA (sm_90; twice the rate of m8n8k4 on an
// H100, which issues m8n8k4 at half the fp64 tensor-core peak):
// a = A[gid][tig], A[gid + 8][tig], A[gid][tig + 4], A[gid + 8][tig + 4];
// b = B[tig][gid], B[tig + 4][gid]; d = D[gid][2 tig + (0, 1)],
// D[gid + 8][2 tig + (0, 1)] (gid = lane / 4, tig = lane % 4)
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[4],
                                       double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// dst[j] = src[parity(dst) + j] for j < n (src 16-byte aligned in shared
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

// The ring: stage s's copies (K::issue) go K::DEPTH stages ahead; once they
// have landed, the staging pass (K::stage) rounds the stage's batch and the
// products (K::mma) read it.  The first barrier of a stage sees its copies
// landed and the products of the stage before done (the rounded tile
// free), the second the rounded tile written (the batch's landing slot
// free again).
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

// A build without the stores (LEGENDRE_NARROW_PARTS) still uses every sum,
// so that the compiler keeps the products: a store that no sum triggers.
template <int N>
__device__ __forceinline__ void keep_live(const double (&acc)[N][4],
                                          double* out) {
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  if (s == 1.2345e-300) out[0] = s;
}

// ---------------------------------------------------------------------------
// dense synthesis: grid (ring tile and column tile in x, row pair in y)
// ---------------------------------------------------------------------------

constexpr int kSynMaxWarps = 8;
constexpr int kSynRows = 32;     // degree rows a stage
constexpr int kSynDepth = 2;     // stages in flight

// The dense synthesis' plan, the same on host and device: m16 tiles a warp
// (one, 16 rings, while one block of at most 8 warps holds every ring; else
// two: half the B reads a product, half the ring tiles, each of which
// stages the batch again), ring tiles, warps a block, the bytes from one
// table row's slot to the next (at least the warps' rings and a chunk, 32
// mod 128), dynamic shared memory: DEPTH + 1 table stages, DEPTH landed x
// tiles [tc][kSynRows + 2] and B [tc][kSynRows + 4].
struct SynthNarrowPlan {
  int mt, ntr, warps, rs, smem;
  __host__ __device__ SynthNarrowPlan(int nr, int tc, int es) {
    mt = nr <= 16 * kSynMaxWarps ? 1 : 2;
    const int wt = (nr + 16 * mt - 1) / (16 * mt);
    ntr = (wt + kSynMaxWarps - 1) / kSynMaxWarps;
    if (ntr < 1) ntr = 1;
    warps = (wt + ntr - 1) / ntr;
    if (warps < 1) warps = 1;
    const int span = 16 * mt * warps * es + 16;
    rs = (span + 95) / 128 * 128 + 32;
    smem = (kSynDepth + 1) * kSynRows * rs +
           (kSynDepth * (kSynRows + 2) + kSynRows + 4) * tc * 8;
  }
};

template <typename T, int TC, int MT_>
struct SynthNarrow {
  static constexpr int ES = sizeof(T), MT = MT_, NT = TC / 8;
  static constexpr int KS = kSynRows, DEPTH = kSynDepth;
  static constexpr int XL = KS + 2;  // doubles a landed x row: its shift, its chunks
  static constexpr int XS = KS + 4;  // doubles a B row
  static constexpr int THREADS = 32 * kSynMaxWarps;
  static_assert(KS % 8 == 0 && XL % 2 == 0 && XS % 16 == 4,
                "k8 steps, a row's shift the same 8 rows on; 16-byte landing "
                "rows; B fragment banks");

  unsigned char* tb;    // table slots [DEPTH + 1][KS][rs bytes]
  double* xl;           // landed x [DEPTH][TC][XL]
  double* xb;           // B: x rounded [TC][XS]
  const T* lam;         // lam[0, 0, r_lo]
  const double* x;      // x[0, c0, 0]
  double* out;          // out[0, r_lo, c0]
  long long sxm, sxc;
  int L, nr, C, rs, nch, R, cv;  // nch: chunks a table row
  int ia, ib, ma, mb, na, nst;   // the row pair, row ia's stages, all stages
  int tid, nth, lane, wr0;       // wr0: the warp's first ring in the tile
  double acc[MT][NT][4];         // [m16 tile][n8 tile][fragment]

  struct Stage { int ri, l0, nrows; };
  // stage q: degree rows l0 .. l0 + nrows of row ri's slab
  __device__ __forceinline__ Stage stage_at(int q) const {
    const int ri = q < na ? ia : ib;
    const int l0 = q < na ? ma + KS * q : mb + KS * (q - na);
    return Stage{ri, l0, min(KS, L - l0)};
  }
  __device__ __forceinline__ const T* row0(const Stage& st) const {
    return lam + (static_cast<long long>(st.ri) * L + st.l0) * nr;
  }
  __device__ __forceinline__ const double* xrow(const Stage& st) const {
    return x + st.ri * sxm + st.l0;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mt][n][h] = 0.0;
  }

  // the tile's pieces of table rows l0 .. l0 + KS (past the slab: zeros),
  // each into its slot from its start rounded down to 16 bytes; x[ri, c,
  // l0 ..] for the tile's columns, along l
  __device__ __forceinline__ void issue(int q) {
    if (!kCopies) return;
    const Stage st = stage_at(q);
    unsigned char* ts = tb + (q % (DEPTH + 1)) * KS * rs;
    const T* src = row0(st);
    for (int e = tid; e < KS * nch; e += nth) {
      const int k = e / nch, j = e - k * nch;
      const bool ok = k < st.nrows;
      copy_chunk(ts + k * rs, ok ? src + static_cast<long long>(k) * nr : src,
                 ok ? R * ES : 0, j);
    }
    double* xs = xl + (q % DEPTH) * TC * XL;
    const double* xm = xrow(st);
    for (int e = tid; e < TC * (XL / 2); e += nth) {
      const int c = e / (XL / 2), j = e - c * (XL / 2);
      const bool ok = c < cv;
      copy_chunk(xs + c * XL, ok ? xm + c * sxc : xm, ok ? 8 * st.nrows : 0,
                 j);
    }
  }

  // B[c][k] = x rounded, zero past the slab and the columns
  __device__ __forceinline__ void stage(int q) {
    if (!kStaging) return;
    const Stage st = stage_at(q);
    const double* xs = xl + (q % DEPTH) * TC * XL;
    const double* xm = xrow(st);
    for (int e = tid; e < TC * KS; e += nth) {
      const int c = e / KS, k = e % KS;
      double v = 0.0;
      if (c < cv && k < st.nrows)
        v = Narrow<T>::round(xs[c * XL + parity(xm + c * sxc) + k]);
      xb[c * XS + k] = v;
    }
  }

  // the k8 steps that hold rows; then, at the last stage of a row, its sums
  // to the output.  Row k of the slot sits at k rs + its source's shift,
  // which is that of row k + 8 too (8 nr es is a multiple of 16): a lane's
  // rows tig and tig + 4 keep their shifts over the stage.
  __device__ __forceinline__ void mma(int q) {
    const Stage st = stage_at(q);
    const int gid = lane >> 2, tig = lane & 3;
    if (wr0 < R) {  // uniform across the warp
      const unsigned char* ts =
          tb + (q % (DEPTH + 1)) * KS * rs + (wr0 + gid) * ES;
      const int s0 = shift16(row0(st));
      const unsigned char* p0 =
          ts + tig * rs + ((s0 + tig * nr * ES) & 15);
      const unsigned char* p4 =
          ts + (tig + 4) * rs + ((s0 + (tig + 4) * nr * ES) & 15);
      const double* xs = xb + gid * XS + tig;
      const int steps = (st.nrows + 7) / 8;
#pragma unroll
      for (int kk = 0; kk < KS / 8; ++kk) {
        if (kk >= steps) break;
        // rings 16 mt + gid, + 8 at degrees tig, tig + 4 of the step
        double a[MT][4], b[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int o = 8 * kk * rs + 16 * mt * ES;
          a[mt][0] = wide<T>(p0 + o);
          a[mt][1] = wide<T>(p0 + o + 8 * ES);
          a[mt][2] = wide<T>(p4 + o);
          a[mt][3] = wide<T>(p4 + o + 8 * ES);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          b[n][0] = xs[n * 8 * XS + 8 * kk];
          b[n][1] = xs[n * 8 * XS + 8 * kk + 4];
        }
        if (!kProducts) {  // the shared-memory reads stay
          acc[0][0][0] += a[0][0] + a[0][1] + a[0][2] + a[0][3] + b[0][0] +
                          b[0][1];
          continue;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            dmma16(acc[mt][n], a[mt], b[n][0], b[n][1]);
      }
    }
    if (q != na - 1 && q != nst - 1) return;
    if (!kStores) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) keep_live(acc[mt], out);
    }
    if (kStores && wr0 < R) {
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {  // rings 16 mt + gid, + 8
        const int mt = i >> 1, h = i & 1;
        const int r = wr0 + 16 * mt + 8 * h + gid;
        if (r >= R) continue;
        double* o = out + (static_cast<long long>(st.ri) * nr + r) * C;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = n * 8 + 2 * tig;
          const double v0 = acc[mt][n][2 * h], v1 = acc[mt][n][2 * h + 1];
          if (c + 1 < cv && shift16(o + c) == 0) {
            *reinterpret_cast<double2*>(o + c) = make_double2(v0, v1);
          } else {
            if (c < cv) o[c] = v0;
            if (c + 1 < cv) o[c + 1] = v1;
          }
        }
      }
    }
    zero();
  }
};

template <typename T, int TC, int MT>
__global__ void __launch_bounds__(SynthNarrow<T, TC, MT>::THREADS, 2)
    synth_narrow(const T* __restrict__ lam, const double* __restrict__ x,
                 double* __restrict__ out, int L, int nr, int C,
                 long long sxm, long long sxc, const int* __restrict__ ms,
                 int M) {
  using K = SynthNarrow<T, TC, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const SynthNarrowPlan pl(nr, TC, K::ES);
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * TC;
  const int r_lo = tile * nr / pl.ntr;
  K k;
  k.R = (tile + 1) * nr / pl.ntr - r_lo;
  k.rs = pl.rs;
  k.nch = (k.R * K::ES + 30) / 16;  // chunks of the row at any shift
  k.tb = smem;
  k.xl = reinterpret_cast<double*>(smem + (K::DEPTH + 1) * K::KS * pl.rs);
  k.xb = k.xl + K::DEPTH * TC * K::XL;
  k.lam = lam + r_lo;
  k.x = x + c0 * sxc;
  k.out = out + static_cast<long long>(r_lo) * C + c0;
  k.sxm = sxm;
  k.sxc = sxc;
  k.L = L;
  k.nr = nr;
  k.C = C;
  k.cv = min(TC, C - c0);
  // rows ia and ib of degrees ma and mb; the middle row of an odd M alone
  k.ia = blockIdx.y;
  k.ib = M - 1 - k.ia;
  k.ma = degree(ms, k.ia);
  k.mb = degree(ms, k.ib);
  k.na = (L - k.ma + K::KS - 1) / K::KS;
  k.nst = k.na + (k.ib > k.ia ? (L - k.mb + K::KS - 1) / K::KS : 0);
  k.tid = threadIdx.x;
  k.nth = blockDim.x;
  k.lane = threadIdx.x & 31;
  k.wr0 = (threadIdx.x >> 5) * 16 * MT;
  k.zero();
  run_ring(k, k.nst);
}

// ---------------------------------------------------------------------------
// dense adjoint: grid ((m, row tile) pairs in x, column tiles in y)
// ---------------------------------------------------------------------------

constexpr int kAdjRows = 256;   // rows l a block
constexpr int kAdjWarps = 8;    // 32 rows each: two m16 tiles
constexpr int kAdjPiece = 64;   // bytes of a row's piece of a stage
constexpr int kAdjDepth = 2;    // stages in flight

// KUNIT: g with unit stride on r (else on c)
template <typename T, int TC, bool KUNIT>
struct AdjNarrow {
  static constexpr int ES = sizeof(T);
  static constexpr int BM = kAdjRows, KC = kAdjPiece / ES, DEPTH = kAdjDepth;
  static constexpr int THREADS = 32 * kAdjWarps, WR = BM / kAdjWarps;
  static constexpr int MT = WR / 16, NT = TC / 8;
  static constexpr int TW = KC * ES + 16;  // bytes a landed table row
  static constexpr int TCH = TW / 16;      // its chunks
  static constexpr int T_SLOT = BM * TW;   // bytes; DEPTH + 1 slots
  static constexpr int GW = KUNIT ? KC + 2 : TC + 2;  // doubles a landed g row
  static constexpr int GCH = GW / 2;       // [c][ring] (KUNIT) : [ring][c]
  static constexpr int G_TILE = (KUNIT ? TC : KC) * GW;  // doubles
  static constexpr int US = KC + 4;        // doubles a U row
  static constexpr int G_OFF = (DEPTH + 1) * T_SLOT;     // bytes
  static constexpr int U_OFF = G_OFF + DEPTH * G_TILE * 8;
  static constexpr int MAIN = U_OFF + TC * US * 8;
  static constexpr int SO = BM + 4;        // epilogue [c][l - l0] doubles
  static constexpr int SMEM = MAIN > TC * SO * 8 ? MAIN : TC * SO * 8;
  static_assert((KC * ES) % 16 == 0 && KC % 8 == 0 && WR % 16 == 0 &&
                    GW % 2 == 0 && US % 16 == 4,
                "a row keeps its shift; k8 steps; 16-byte rows; banks");

  unsigned char* sm;
  const T* tab;         // lam[i, l0, 0]
  const double* gp;     // g[i, 0, c0]
  long long sgr, sgc;   // g's strides
  int nt, iv, cv, gs0;  // iv: rows l0 + row < L; gs0: gp's address in doubles mod 2
  int tid, lane, wr0;   // wr0: the warp's first row
  int ta[MT][2];        // this lane's rows gid, gid + 8 of each m16 tile in
                        // a slot (bytes), at ring tig
  double acc[MT][NT][4];

  // where a landed g row starts (doubles): from element e of column c
  // (KUNIT), or of ring e (unit stride on c)
  __device__ __forceinline__ int gshift(int c, int e) const {
    return KUNIT ? (gs0 + (c & 1) * static_cast<int>(sgc & 1) + e) & 1
                 : (gs0 + (e & 1) * static_cast<int>(sgr & 1)) & 1;
  }

  // the lane's rows wr0 + 16 mt + gid (+ 8) at ring tig: row slot, the
  // row's shift (the same at every stage: a stage is KC es = 64 bytes)
  __device__ __forceinline__ void init() {
    const int gid = lane >> 2, tig = lane & 3;
    const int sh0 = shift16(tab);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wr0 + 16 * mt + 8 * h + gid;
        ta[mt][h] = row * TW + ((sh0 + row * nt * ES) & 15) + tig * ES;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mt][n][h] = 0.0;
    }
  }

  // the rows' pieces of rings k0 .. k0 + KC (rows past the slab: none);
  // g[r, c] for those rings (KUNIT: each column's run of rings)
  __device__ __forceinline__ void issue(int s) {
    if (!kCopies) return;
    const int k0 = s * KC;
    unsigned char* ts = sm + (s % (DEPTH + 1)) * T_SLOT;
    const int vb = min(KC, nt - k0) * ES;
    for (int e = tid; e < iv * TCH; e += THREADS) {
      const int row = e / TCH, j = e - row * TCH;
      copy_chunk(ts + row * TW, tab + static_cast<long long>(row) * nt + k0,
                 vb, j);
    }
    double* gn = reinterpret_cast<double*>(sm + G_OFF) + (s % DEPTH) * G_TILE;
    if constexpr (KUNIT) {
      const int nv = min(nt, k0 + KC) - k0;
      for (int e = tid; e < TC * GCH; e += THREADS) {
        const int c = e / GCH, j = e - c * GCH;
        const bool ok = c < cv;
        copy_chunk(gn + c * GW, ok ? gp + c * sgc + k0 : gp, ok ? 8 * nv : 0,
                   j);
      }
    } else {
      for (int e = tid; e < KC * GCH; e += THREADS) {
        const int t = e / GCH, j = e - t * GCH, r = k0 + t;
        const bool ok = r < nt;
        copy_chunk(gn + t * GW, ok ? gp + r * sgr : gp, ok ? 8 * cv : 0, j);
      }
    }
  }

  // U[c][j] = g[k0 + j, c] rounded, zero past the rings and the columns
  __device__ __forceinline__ void stage(int s) {
    if (!kStaging) return;
    const double* gn =
        reinterpret_cast<const double*>(sm + G_OFF) + (s % DEPTH) * G_TILE;
    double* U = reinterpret_cast<double*>(sm + U_OFF);
    const int k0 = s * KC;
    for (int e = tid; e < TC * KC; e += THREADS) {
      const int c = e / KC, j = e % KC, r = k0 + j;
      double v = 0.0;
      if (c < cv && r < nt)
        v = KUNIT ? gn[c * GW + gshift(c, k0) + j]
                  : gn[j * GW + gshift(0, r) + c];
      U[c * US + j] = Narrow<T>::round(v);
    }
  }

  // the k8 steps that hold rings, for the warp's rows (rows past iv read
  // stale bytes: their sums are never stored)
  __device__ __forceinline__ void mma(int s) {
    if (wr0 >= iv) return;  // uniform across the warp
    const unsigned char* ts = sm + (s % (DEPTH + 1)) * T_SLOT;
    const int gid = lane >> 2, tig = lane & 3;
    const double* U =
        reinterpret_cast<const double*>(sm + U_OFF) + gid * US + tig;
    const int steps = (min(KC, nt - s * KC) + 7) / 8;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      if (kk >= steps) break;  // uniform across the warp
      // rows gid, gid + 8 of each m16 tile at rings tig, tig + 4 of the step
      double a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* r0 = ts + ta[mt][0] + 8 * kk * ES;
        const unsigned char* r8 = ts + ta[mt][1] + 8 * kk * ES;
        a[mt][0] = wide<T>(r0);
        a[mt][1] = wide<T>(r8);
        a[mt][2] = wide<T>(r0 + 4 * ES);
        a[mt][3] = wide<T>(r8 + 4 * ES);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        b[n][0] = U[n * 8 * US + 8 * kk];
        b[n][1] = U[n * 8 * US + 8 * kk + 4];
      }
      if (!kProducts) {  // the shared-memory reads stay
        acc[0][0][0] += a[0][0] + a[0][1] + a[0][2] + a[0][3] + b[0][0] +
                        b[0][1];
        continue;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          dmma16(acc[mt][n], a[mt], b[n][0], b[n][1]);
    }
  }

  // out[c * soc + l - l0] for c < cv, l - l0 < min(BM, lv), through shared
  // memory [c][l - l0] (each column shifted to its run's 16-byte
  // alignment), then whole runs along l, a warp a column, each right after
  // the column's zeros at out[c * soc - zeros ..]
  __device__ __forceinline__ void finish(double* out, long long soc, int lv,
                                         int zeros) {
    if (!kStores) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) keep_live(acc[mt], out);
      return;
    }
    double* so = reinterpret_cast<double*>(sm);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int l = wr0 + 16 * mt + 8 * (h >> 1) + gid;
          const int c = 8 * n + 2 * tig + (h & 1);
          so[c * SO + parity(out + c * soc) + l] = acc[mt][n][h];
        }
    __syncthreads();
    for (int c = tid >> 5; c < cv; c += THREADS / 32) {
      if (zeros > 0) store_run(out + c * soc - zeros, nullptr, zeros, lane);
      store_run(out + c * soc, so + c * SO, min(BM, lv), lane);
    }
  }
};

// blocks: (m, row tile) with tile j covering degrees [m + P j, m + P (j + 1))
// for every m with L - m > P j, tile-major
__host__ __device__ inline int adj_pairs(int L, int P) {
  int n = 0;
  for (int j = 0; P * j < L; ++j) n += L - P * j;
  return n;
}

template <typename T, int TC, bool KUNIT>
__global__ void __launch_bounds__(AdjNarrow<T, TC, KUNIT>::THREADS, 2)
    adj_narrow(const T* __restrict__ lam, const double* __restrict__ g,
               double* __restrict__ out, int L, int nr, int C, long long sgm,
               long long sgr, long long sgc, long long som, long long soc,
               const int* __restrict__ ms, int M) {
  using K = AdjNarrow<T, TC, KUNIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  // (memory row i, degree m, row tile): tile-major over the rows
  int i, m, tile;
  if (ms) {  // every (row, tile) pair; those past the row's triangle exit
    tile = blockIdx.x / M;
    i = blockIdx.x % M;
    m = degree(ms, i);
    if (m + K::BM * tile >= L) return;  // uniform across the block
  } else {  // the pairs that exist: rows m < L - BM tile
    m = blockIdx.x;
    tile = 0;
    while (m >= L - K::BM * tile) {
      m -= L - K::BM * tile;
      ++tile;
    }
    i = m;
  }
  const int l0 = m + K::BM * tile;
  const int c0 = blockIdx.y * TC;
  K k;
  k.sm = smem;
  k.tab = lam + (static_cast<long long>(i) * L + l0) * nr;  // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                              // g[i, 0, c0]
  k.sgr = sgr;
  k.sgc = sgc;
  k.nt = nr;
  k.iv = min(K::BM, L - l0);
  k.cv = min(TC, C - c0);
  k.gs0 = parity(k.gp);
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.wr0 = (threadIdx.x >> 5) * K::WR;
  k.init();
  run_ring(k, (nr + K::KC - 1) / K::KC);
  k.finish(out + i * som + c0 * soc + l0, soc, L - l0, tile == 0 ? m : 0);
}

// ---------------------------------------------------------------------------
// parity synthesis (first version): grid (ceil(C / NC), ring tiles, M), a
// thread a ring
// ---------------------------------------------------------------------------

// this thread's ring column of table rows l0 .. l0 + KL - 1 (zero past L)
template <typename T>
__device__ __forceinline__ void load_rows(float (&t)[KL], const T* col,
                                          int l0, int L, int nt, bool live) {
#pragma unroll
  for (int k = 0; k < KL; ++k)
    t[k] = (live && l0 + k < L)
               ? Narrow<T>::widen(col[static_cast<long long>(l0 + k) * nt])
               : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kMaxRingTile)
    synth_par_narrow(const T* __restrict__ lam, const double* __restrict__ x,
                     double* __restrict__ out, int L, int nr, int nt, int C,
                     long long sxm, long long sxc, const int* __restrict__ ms,
                     double f) {
  __shared__ __align__(16) double xs[NC][KL];
  const int i = blockIdx.z;
  const int m = degree(ms, i);
  const int c0 = blockIdx.x * NC;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = r < nt;
  const T* col = lam + static_cast<long long>(i) * L * nt + (live ? r : 0);
  const double* xi = x + i * sxm;
  double se[NC], so[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) se[c] = so[c] = 0.0;
  float t[KL];
  load_rows(t, col, m, L, nt, live);
  for (int l0 = m; l0 < L; l0 += KL) {
    __syncthreads();  // the previous stage's reads of xs are done
    for (int e = threadIdx.x; e < NC * KL; e += blockDim.x) {
      const int c = e / KL, k = e % KL;
      xs[c][k] = (c0 + c < C && l0 + k < L)
                     ? Narrow<T>::round(xi[(c0 + c) * sxc + l0 + k])
                     : 0.0;
    }
    __syncthreads();
    float tn[KL];
    load_rows(tn, col, l0 + KL, L, nt, live && l0 + KL < L);
#pragma unroll
    for (int k = 0; k < KL; k += 2) {
      const double t0 = t[k], t1 = t[k + 1];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const double2 v = *reinterpret_cast<const double2*>(&xs[c][k]);
        se[c] = fma(t0, v.x, se[c]);
        so[c] = fma(t1, v.y, so[c]);
      }
    }
#pragma unroll
    for (int k = 0; k < KL; ++k) t[k] = tn[k];
  }
  if (!live) return;
  double* north = out + (static_cast<long long>(i) * nr + r) * C;
  double* south = out + (static_cast<long long>(i) * nr + nr - 1 - r) * C;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c0 + c >= C) break;
    north[c0 + c] = se[c] + so[c];
    if (r < nr - nt) south[c0 + c] = f * (se[c] - so[c]);
  }
}

// ---------------------------------------------------------------------------
// parity adjoint (first version): grid (ceil(C / NC), ceil(L / LT), M), a
// thread a degree row
// ---------------------------------------------------------------------------

// the degree row of thread / tile row j of the block at lb: the rows of
// even l - m on j < 64 and odd ones on j >= 64
__device__ __forceinline__ int adj_row(int j, int lb, int m) {
  const int p = j / (LT / 2), q = j % (LT / 2);
  return lb + 2 * q + ((p + m + lb) & 1);
}

template <typename T>
__global__ void __launch_bounds__(LT)
    adj_par_narrow(const T* __restrict__ lam, const double* __restrict__ g,
                   double* __restrict__ out, int L, int nr, int nt, int C,
                   long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* __restrict__ ms,
                   double f) {
  constexpr int TS = Narrow<T>::kTileStride;
  __shared__ T tab[LT * TS];
  __shared__ __align__(16) double us[KR][NC];
  __shared__ __align__(16) double vs[KR][NC];
  const int i = blockIdx.z;
  const int m = degree(ms, i);
  const int c0 = blockIdx.x * NC;
  const int lb = blockIdx.y * LT;
  const int j = threadIdx.x;
  const int l = adj_row(j, lb, m);
  const T* lami = lam + static_cast<long long>(i) * L * nt;
  const double* gi = g + i * sgm;
  const bool r_unit = sgr == 1;
  double acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0;
  // rows of class (l - m) odd read V; a warp's rows are of one class
  const double(*src)[NC] = ((l - m) & 1) ? vs : us;
  if (lb + LT > m) {
    for (int r0 = 0; r0 < nt; r0 += KR) {
      __syncthreads();  // the previous stage's reads are done
      // the table tile: a warp reads KR consecutive rings of one row
      for (int e = j; e < LT * KR; e += LT) {
        const int row = e / KR, k = e % KR;
        const int lr = adj_row(row, lb, m);
        tab[row * TS + k] =
            (lr >= m && lr < L && r0 + k < nt)
                ? lami[static_cast<long long>(lr) * nt + r0 + k]
                : Narrow<T>::zero();
      }
      // the batch tile's folds U and V, rounded, read along g's unit stride
      for (int e = j; e < KR * NC; e += LT) {
        const int k = r_unit ? e % KR : e / NC;
        const int c = r_unit ? e / KR : e % NC;
        const int rr = r0 + k;
        double u = 0.0, v = 0.0;
        if (rr < nt && c0 + c < C) {
          const double gn = gi[rr * sgr + (c0 + c) * sgc];
          const double gs =
              rr < nr - nt ? f * gi[(nr - 1 - rr) * sgr + (c0 + c) * sgc]
                           : 0.0;
          u = Narrow<T>::round(gn + gs);
          v = Narrow<T>::round(gn - gs);
        }
        us[k][c] = u;
        vs[k][c] = v;
      }
      __syncthreads();
      const T* trow = tab + j * TS;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const double tk = Narrow<T>::widen(trow[k]);
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const double2 v = *reinterpret_cast<const double2*>(&src[k][c]);
          acc[c] = fma(tk, v.x, acc[c]);
          acc[c + 1] = fma(tk, v.y, acc[c + 1]);
        }
      }
    }
  }
  if (l >= L) return;
  double* oi = out + i * som + l;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c0 + c >= C) break;
    oi[(c0 + c) * soc] = l >= m ? acc[c] : 0.0;
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

// the column tile of a call at C columns
inline int col_tile(int C) { return C <= 8 ? 8 : (C <= 16 ? 16 : 32); }

template <typename T, int TC, int MT>
int launch_synth(const SynthNarrowPlan& pl, const void* lam, const void* x,
                 void* out, int L, int nr, int C, long long sxm,
                 long long sxc, const int* ms, int M, cudaStream_t s) {
  const dim3 grid(pl.ntr * ((C + TC - 1) / TC), (M + 1) / 2);
  const cudaError_t e = allow_smem(synth_narrow<T, TC, MT>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  synth_narrow<T, TC, MT><<<grid, 32 * pl.warps, pl.smem, s>>>(
      static_cast<const T*>(lam), static_cast<const double*>(x),
      static_cast<double*>(out), L, nr, C, sxm, sxc, ms, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TC>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int C, long long sxm, long long sxc, const int* ms, int M,
                 cudaStream_t s) {
  const SynthNarrowPlan pl(nr, TC, sizeof(T));
  if (pl.mt == 1)
    return launch_synth<T, TC, 1>(pl, lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                  s);
  return launch_synth<T, TC, 2>(pl, lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                s);
}

template <typename T>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int C, long long sxm, long long sxc, const int* ms, int M,
                 cudaStream_t s) {
  switch (col_tile(C)) {
    case 8:
      return launch_synth<T, 8>(lam, x, out, L, nr, C, sxm, sxc, ms, M, s);
    case 16:
      return launch_synth<T, 16>(lam, x, out, L, nr, C, sxm, sxc, ms, M, s);
    default:
      return launch_synth<T, 32>(lam, x, out, L, nr, C, sxm, sxc, ms, M, s);
  }
}

template <typename T, int TC, bool KUNIT>
int launch_adj(const void* lam, const void* g, void* out, int L, int nr,
               int C, long long sgm, long long sgr, long long sgc,
               long long som, long long soc, const int* ms, int M,
               cudaStream_t s) {
  using K = AdjNarrow<T, TC, KUNIT>;
  const int blocks =
      ms ? M * ((L + K::BM - 1) / K::BM) : adj_pairs(L, K::BM);
  const dim3 grid(blocks, (C + TC - 1) / TC);
  const cudaError_t e = allow_smem(adj_narrow<T, TC, KUNIT>, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  adj_narrow<T, TC, KUNIT><<<grid, K::THREADS, K::SMEM, s>>>(
      static_cast<const T*>(lam), static_cast<const double*>(g),
      static_cast<double*>(out), L, nr, C, sgm, sgr, sgc, som, soc, ms, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TC>
int launch_adj(const void* lam, const void* g, void* out, int L, int nr,
               int C, long long sgm, long long sgr, long long sgc,
               long long som, long long soc, const int* ms, int M,
               cudaStream_t s) {
  if (sgr == 1)
    return launch_adj<T, TC, true>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                                   soc, ms, M, s);
  if (sgc == 1)
    return launch_adj<T, TC, false>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                    som, soc, ms, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_adj(const void* lam, const void* g, void* out, int L, int nr,
               int C, long long sgm, long long sgr, long long sgc,
               long long som, long long soc, const int* ms, int M,
               cudaStream_t s) {
  switch (col_tile(C)) {
    case 8:
      return launch_adj<T, 8>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc,
                              ms, M, s);
    case 16:
      return launch_adj<T, 16>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                               soc, ms, M, s);
    default:
      return launch_adj<T, 32>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                               soc, ms, M, s);
  }
}

// nr is the output's ring count, the table's ceil(nr / 2)
template <typename T>
int launch_synth_par(const void* lam, const void* x, void* out, int L,
                     int nr, int C, long long sxm, long long sxc,
                     const int* ms, int M, cudaStream_t s, double f) {
  const int nt = (nr + 1) / 2;
  // the fewest ring tiles of at most kMaxRingTile rings, of even sizes
  const int tiles = (nt + kMaxRingTile - 1) / kMaxRingTile;
  const int per = (nt + tiles - 1) / tiles;
  const int threads = (per + 31) / 32 * 32;
  const dim3 grid((C + NC - 1) / NC, (nt + threads - 1) / threads, M);
  synth_par_narrow<T><<<grid, threads, 0, s>>>(
      static_cast<const T*>(lam), static_cast<const double*>(x),
      static_cast<double*>(out), L, nr, nt, C, sxm, sxc, ms, f);
  return static_cast<int>(cudaGetLastError());
}

// nr is g's ring count, the table's ceil(nr / 2)
template <typename T>
int launch_adj_par(const void* lam, const void* g, void* out, int L, int nr,
                   int C, long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* ms, int M,
                   cudaStream_t s, double f) {
  const dim3 grid((C + NC - 1) / NC, (L + LT - 1) / LT, M);
  adj_par_narrow<T><<<grid, LT, 0, s>>>(
      static_cast<const T*>(lam), static_cast<const double*>(g),
      static_cast<double*>(out), L, nr, (nr + 1) / 2, C, sgm, sgr, sgc, som,
      soc, ms, f);
  return static_cast<int>(cudaGetLastError());
}

// resident blocks an SM of a kernel at its threads and dynamic shared
// memory on the current card; -1 where the runtime refuses the query
template <typename K>
int blocks_per_sm(K kernel, int threads, int bytes) {
  int n = 0;
  if (allow_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    bytes) != cudaSuccess)
    return -1;
  return n;
}

// the dense pair's plan at (nr, C): kind 0 the synthesis' threads << 20 |
// dynamic shared memory (bytes), 1 its resident blocks an SM, 2 its ring
// tiles, 5 its rings a warp; 3 the adjoint's (g with unit stride on r)
// threads << 20 | bytes, 4 its resident blocks an SM
template <typename T, int TC>
int plan(int kind, int nr) {
  const SynthNarrowPlan pl(nr, TC, sizeof(T));
  using A = AdjNarrow<T, TC, true>;
  switch (kind) {
    case 0:
      return 32 * pl.warps << 20 | pl.smem;
    case 1:
      return pl.mt == 1 ? blocks_per_sm(synth_narrow<T, TC, 1>,
                                         32 * pl.warps, pl.smem)
                        : blocks_per_sm(synth_narrow<T, TC, 2>,
                                        32 * pl.warps, pl.smem);
    case 2:
      return pl.ntr;
    case 3:
      return A::THREADS << 20 | A::SMEM;
    case 4:
      return blocks_per_sm(adj_narrow<T, TC, true>, A::THREADS, A::SMEM);
    default:
      return 16 * pl.mt;
  }
}

template <typename T>
int plan(int kind, int nr, int C) {
  switch (col_tile(C)) {
    case 8:
      return plan<T, 8>(kind, nr);
    case 16:
      return plan<T, 16>(kind, nr);
    default:
      return plan<T, 32>(kind, nr);
  }
}

}  // namespace

// The entry points, one set per table dtype (suffix bf16f64: bfloat16,
// f32f64: float32), with the arguments of legendre_tri_f64.cu's:
// x[i, c, l] at x + i * sxm + c * sxc + l; g[i, r, c] at g + i * sgm + r *
// sgr + c * sgc (unit stride on r or on c); out[i, c, l] at out + i * som +
// c * soc + l; ms null (M = L, row i of degree i) or M int32 degree orders
// on the device; nr the dense table's rings, or in the parity mode the
// output's (synthesis) or g's (adjoint) rings, of which the table holds
// ceil(nr / 2); flip the table's opposite reflection parity.
#define NARROW_F64_ENTRY_POINTS(SFX, T)                                      \
  int legendre_synth_tri_##SFX(const void* lam, const void* x, void* out,   \
                               int L, int nr, int C, long long sxm,         \
                               long long sxc, const void* ms, int M,        \
                               void* stream) {                              \
    return launch_synth<T>(lam, x, out, L, nr, C, sxm, sxc,                  \
                           static_cast<const int*>(ms), M,                   \
                           static_cast<cudaStream_t>(stream));               \
  }                                                                          \
  int legendre_adj_tri_##SFX(const void* lam, const void* g, void* out,     \
                             int L, int nr, int C, long long sgm,           \
                             long long sgr, long long sgc, long long som,   \
                             long long soc, const void* ms, int M,          \
                             void* stream) {                                \
    return launch_adj<T>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc,     \
                         static_cast<const int*>(ms), M,                     \
                         static_cast<cudaStream_t>(stream));                 \
  }                                                                          \
  int legendre_synth_par_##SFX(const void* lam, const void* x, void* out,   \
                               int L, int nr, int C, long long sxm,         \
                               long long sxc, const void* ms, int M,        \
                               int flip, void* stream) {                    \
    return launch_synth_par<T>(lam, x, out, L, nr, C, sxm, sxc,              \
                               static_cast<const int*>(ms), M,               \
                               static_cast<cudaStream_t>(stream),            \
                               flip ? -1.0 : 1.0);                           \
  }                                                                          \
  int legendre_adj_par_##SFX(const void* lam, const void* g, void* out,     \
                             int L, int nr, int C, long long sgm,           \
                             long long sgr, long long sgc, long long som,   \
                             long long soc, const void* ms, int M, int flip,\
                             void* stream) {                                \
    return launch_adj_par<T>(lam, g, out, L, nr, C, sgm, sgr, sgc, som, soc, \
                             static_cast<const int*>(ms), M,                 \
                             static_cast<cudaStream_t>(stream),              \
                             flip ? -1.0 : 1.0);                             \
  }

extern "C" {
NARROW_F64_ENTRY_POINTS(bf16f64, __nv_bfloat16)
NARROW_F64_ENTRY_POINTS(f32f64, float)

// The dense pair's plan at (nr, C) for a table of es bytes an element (2:
// bfloat16, 4: float32): kind 0 the synthesis' threads << 20 | dynamic
// shared memory (bytes), 1 its resident blocks an SM on the current card
// (-1 if refused), 2 its ring tiles, 5 its rings a warp; 3 the adjoint's (g
// with unit stride on r) threads << 20 | bytes, 4 its resident blocks an
// SM.
int legendre_tri_narrow_f64_plan(int kind, int es, int nr, int C) {
  return es == 2 ? plan<__nv_bfloat16>(kind, nr, C) : plan<float>(kind, nr, C);
}
}  // extern "C"
