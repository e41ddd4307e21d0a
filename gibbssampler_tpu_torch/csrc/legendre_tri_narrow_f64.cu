// Triangular Legendre contractions of a table in another dtype than its
// batch, for Hopper (sm_90a): a narrow table (bfloat16, float16 or
// float32) with a float64 batch, or a float64 table with a float32 batch;
// the table read in its own dtype and widened in registers, the products
// summed in float64 on the fp64 tensor cores.  Plain C interface, loaded
// with ctypes.
//
// Replaces, for a bfloat16, float16 or float32 table under float64
// compute and a float64 table under float32 compute, the Pallas TPU
// kernels of gibbssampler_tpu/sht/pallas_legendre.py:
//   legendre_synth_tri (:52, _synth_kernel, pallas_call :76)
//       out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
//   legendre_adj_tri   (:106, _adj_kernel, pallas_call :121)
//       out[m, c, l] = sum_r lam[m, l, r] g[m, r, c],  0 for l < m
// which the JAX package runs, in these modes, as the einsums of its
// sht/lcore.py (einsum(lam, b.astype(table_dtype),
// preferred_element_type=compute dtype)).  Layouts, the m-slab form (ms, M)
// and the ring-parity mode (a table over the ceil(nr / 2) north rings, the
// sums over even and odd l - m kept apart and mirrored into the south
// rings, or g's south rings folded onto the north ones) are those of
// legendre_tri_f64.cu: lam (M, L, nt) row-major, zero for l < m; x (M, C,
// L) with unit stride on l; g (M, nr, C) with unit stride on r or on c;
// synthesis out (M, nr, C) row-major; adjoint out (M, C, L) with unit
// stride on l, every element written (the zeros of l < m too); the batch
// and the output in the batch's type (Narrow<T>::B).
//
// The rounding is the JAX package's (Narrow<T>::round): a float64 batch
// value bound for bfloat16 goes float64 -> float32 (__double2float_rn) ->
// bfloat16 (__float2bfloat16_rn), never in one step, as XLA's and torch's
// conversions do (one rounding would differ at values such as 1 + 2^-8 +
// 2^-30); one bound for float16 is rounded once (cvt.rn.f16.f64), as XLA
// and numpy convert it (two would differ at 1 + 2^-11 + 2^-40); a float32
// batch value bound for the float64 table is widened exactly.  The parity
// adjoint folds g[r] + f (-1)^(l+m) g[nr-1-r] in the batch's type and then
// rounds (widens) the fold (JAX's U = (Gn + Gs).astype(table_dtype)).  The
// product of two rounded values is exact in float64, so every output of a
// narrow table is a float64 sum of exact products; only the order of the
// sums differs from the plain version's.  With the float64 table each
// float64 sum is rounded once to float32 as it is stored; the parity
// synthesis rounds its two classes' sums to float32 each and forms north
// SE + SO and south f (SE - SO) in float32, the JAX package's split
// synthesis' order.
//
// What bounds them: bytes, once the products run on the fp64 tensor cores.
// At the CG family's C = 16 columns (8 chains x Re/Im), L 513, nr 513, one
// dense call does 2 nr C L(L+1)/2 = 2.16 GFLOP: 0.032 ms at the 67 TFLOP/s
// of DMMA and 0.065 ms at the 33.5 TFLOP/s of the FMA pipes, against
// 0.0555 ms (bfloat16) and 0.0958 ms (float32) for its bytes at 3.35 TB/s.
// A parity call at nr 513, C 32 does 2 nh C L(L+1)/2 = 2.17 GFLOP on the
// half table (nh 257): 0.065 ms on the FMA pipes, above its bfloat16 bound
// of 0.0504 ms.  So all four multiply on DMMA, in the m16n8k8 shape: an
// H100 issues mma.sync.m8n8k4.f64 at half the rate (33 against 67 TFLOP/s,
// measured with registers only), which is as slow as the FMA pipes.  What
// bounds them on DMMA (PERF.md section 6, kernel_ab.py --variant
// narrow-*-only, narrow-par-*-only at nr 513): no part alone.  Copies alone
// take 38-85% of a kernel's time (the float32 adjoints' the most), the
// products alone 28-57%, the staging pass 16-32%, the stores 15-27%; they
// overlap only in part.
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
// Design of the parity pair (synth_par_narrow, adj_par_narrow): the dense
// pair's blocks with both classes of l - m in one block, as the fp64 parity
// kernels of legendre_tri_f64.cu keep them.
// - Synthesis: as the dense one, M = north rings, N = columns, K = degrees,
//   rows i and M-1-i in one pipeline, each warp's sums in its accumulators
//   for a whole row, now both classes' (SE over even l - m, SO over odd).
//   A stage is 2 KL consecutive degree rows (64 in bfloat16, 32 in
//   float32), put into its slot by class (row k at slot row (k & 1) KL + k / 2, each at its own byte shift:
//   the rows of one class are 2 nt es bytes apart, so at nt 257 their
//   shifts repeat every 4 rows in bfloat16 and every 2 in float32); a
//   lane's rows tig and tig + 4 of a class's k8 step are 8 degrees apart
//   and share one shift.  x lands beside the stage and is rounded once a
//   stage into B [c][class KL + k].  A warp holds 16 rings at 32 columns
//   (its 2 x 4 x 4 accumulator doubles of both classes; two m16 tiles would
//   take 128 registers of sums) and while one block of at most 6 warps
//   holds every north ring, else 32; the fewest ring tiles, of sizes that
//   differ by at most one ring, so only a block's last warp has idle lanes
//   (nh 257: 3 tiles of 86 rings on 6 warps at 32 columns, 2 of 129 / 128
//   on 5 warps of 32 below).  At most 6 warps, two blocks an SM: 170
//   registers a thread, so that no tile spills.  At the last stage of a row each lane writes
//   north SE + SO and, for the rings r < nr - nh that have a mirror, south
//   f (SE - SO) from its fragments.
// - Adjoint: as the dense one, M = rows l, N = columns, K = north rings in
//   stages of 64 bytes of each row (KC = 32 bfloat16 or 16 float32 rings),
//   but a block computes both classes of 2 BM = 256 rows l (BM = 128 of
//   each: rows l0 + 2 i' + p at slot row p BM + i', each at its own shift;
//   4 warps a class, 32 rows each) for a tile of TC columns, so that g's
//   north rings and their south mirrors land once for both.  The staging
//   pass forms U = round(g_n + f g_s) and V = round(g_n - f g_s) in float64
//   over the stage's rings and stores them as the classes' B tiles; each
//   warp reads its class's.  Blocks are the (m, 256-row tile) pairs that
//   exist, as the dense adjoint's; the epilogue writes both classes as one
//   run of l a column through shared memory (store_run), after the zeros
//   of l < m in the tile that starts at l = m.  112 KB of shared memory at
//   32 columns in bfloat16, two blocks an SM.
// Design of the float64 table's dense pair (synth_wide, adj_wide; a
// float32 batch and output).  The narrow dense pair's 32-column tiles read
// an 8-byte table once per tile: at the main path's C = 256 (128 chains x
// Re/Im) the SMs took the table 8 times (4.3 GB at nr 513) and its copies
// alone took 52-89% of each kernel (PERF.md section 6).  What bounds the
// pair: at (nr, C) = (513, 256) one call does 2 nr C L(L+1)/2 = 34.6 GFLOP,
// 0.517 ms at DMMA's 67 TFLOP/s against 0.28 ms for its 945 MB; at (65,
// 256) the bytes, 0.071 ms (synthesis) and 0.111 ms (adjoint: its (C, M, L)
// output alone is 270 MB).  Both reach 29-40% of that (PERF.md section 6):
// their copies do not overlap their products.
// - Every table double lands by its own 8-byte cp.async at 8 r of its
//   row's slot, so that rows sit aligned whatever nr's parity, and a lane
//   reads two fragment values in one 16-byte load.  Copies go DEPTH = 2
//   stages ahead into DEPTH + 1 table slots.
// - Synthesis: M = rings, N = columns, K = degrees.  A warp holds 16 rings
//   x 64 columns (32 at C <= 32; 64 accumulator doubles, 128 registers a
//   thread); fragment rows gid and gid + 8 are its rings 2 gid and 2 gid +
//   1.  A block has up to 4 column warps, so that at C = 256 the table
//   enters the SMs once, and ring warps up to 16 warps in all (one block an
//   SM); the fewest ring tiles (nr 65: 2 of 3 and 2 warps; 513: 9 of 4),
//   each of which takes the batch again.  x lands in 16-byte chunks at each
//   column's shift (8 columns apart share one) and B is read from it in
//   float32 and widened as it is loaded: no staging pass, one barrier a
//   stage of 32 degree rows, whose k8 steps are not unrolled (unrolled, the
//   loads of the next step spill).
// - Adjoint: M = rows l, N = columns, K = rings.  A block computes 128 rows
//   l (4 warps of 32) x 128 columns (16 warps, one block an SM; 64 at C <=
//   64, 32 at C <= 32), in stages of 24 rings (3 k8
//   steps, rows of 192 bytes: 64 mod 128, so the 16-byte reads of rows gid
//   and gid + 1 meet no bank twice); the k8 step's degrees tig and tig + 4
//   are its rings 2 tig and 2 tig + 1, read with U's in one 16-byte load.
//   The staging pass widens g into U, a thread a column's run of rings.
//   Blocks are the (m, row tile) pairs m-major, each pair's column tiles
//   next to each other, so that a pair's table rows and g's row m leave
//   device memory once; the epilogue is the narrow adjoint's.
// Design of the float64 table's parity pair (synth_par_wide,
// adj_par_wide): the wide dense pair's blocks with both classes of l - m in
// one block.  The narrow parity pair's design fed an 8-byte table took the
// 271 MB half table (nh 257) into the SMs once per 32-column tile, 8 times
// at C = 256, and the adjoint's copies alone took 86% of its time (PERF.md
// section 6).  What bounds the pair: at (nh, C) = (257, 256) one call does 2
// nh C L(L+1)/2 = 17.3 GFLOP, 0.259 ms at DMMA's 67 TFLOP/s, against
// 0.20-0.24 ms for its bytes: the two weigh nearly equal.  On an H100 (700
// W) both reach 26% of that (PERF.md section 6): their copies, products and
// stores add up rather than overlap, in every block shape tried.
// - Synthesis: M = north rings, N = columns, K = degrees, as synth_wide's
//   (16 rings x 64 columns a warp, every table double by an 8-byte cp.async,
//   rows i and M-1-i in one pipeline, B widened from the landed float32 x,
//   one barrier a stage).  Both classes' sums of 16 x 64 would take 64
//   accumulator doubles a lane, more than the 128 registers a thread of 16
//   warps hold, so each warp holds one class' (SE over even l - m, SO over
//   odd) and a warp of each class covers the same 16 rings x 64 columns:
//   up to 4 column warps (all of C = 256 a block: the half table enters the
//   SMs once) x 2 classes x 2 ring warps at C 256 (32 rings, 9 ring tiles
//   at nh 257, each of which takes x again, mostly from L2).  A stage is 32
//   degree rows, 16 of each class, put into its slots by class (row k at
//   slot row (k & 1) 16 + k / 2); a class' k8 step reads its x rows 2 j +
//   cls from the landed stage.  At the last stage of a row the odd warp
//   writes its sums, rounded to float32, to shared memory lane by lane (its
//   partner holds the same fragments), one barrier, and the even warp
//   writes north SE + SO and, for the rings with a mirror, south f (SE -
//   SO) from its fragments.
// - Adjoint: M = rows l, N = columns, K = north rings, as adj_wide's (128
//   rows l x 128 columns a block above C 64, 64 or 32 below: the table
//   enters the SMs twice at C 256; 24-ring stages of 192-byte row pieces;
//   fragment pairs and U's in 16-byte loads), with both classes: rows l0 +
//   2 i' + p at slot row p 64 + i', 2 warps of 32 rows a class, g's north
//   rings and their south mirrors landed once for both and folded in the
//   staging pass into U = widen(g_n + f g_s) and V = widen(g_n - f g_s),
//   each warp reading its class'.  Blocks are adj_wide's (m, 128-row tile)
//   pairs; the epilogue writes both classes as one run of l a column, after
//   the zeros of l < m in the tile that starts at l = m.
// Every launch goes to the caller's stream; each entry point returns
// cudaGetLastError() so that a refused launch reaches the wrapper.
//
// LEGENDRE_NARROW_PARTS (a bit set, 15 unless nvcc is given -D) keeps the
// copies (1), staging pass (2), products (4) and stores (8) of every
// kernel (the wide syntheses have no staging pass).
// A build that leaves a part out computes a wrong result on purpose: it only
// serves to time the other parts alone (kernel_ab.py --variant).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// the degree order of memory row i: ms[i], or i for the full table
__device__ __forceinline__ int degree(const int* ms, int i) {
  return ms ? __ldg(ms + i) : i;
}

// Table type T: widen, a table value in float64; round, a batch value (B:
// float64 for a narrow table, float32 for the float64 one) as the JAX
// package's astype(T) makes it, in float64.
template <typename T>
struct Narrow;

template <>
struct Narrow<__nv_bfloat16> {
  using B = double;
  static __device__ __forceinline__ double widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // through float32, as XLA and torch convert float64 to bfloat16
  static __device__ __forceinline__ double round(double v) {
    return static_cast<double>(
        __bfloat162float(__float2bfloat16_rn(__double2float_rn(v))));
  }
};

template <>
struct Narrow<__half> {
  using B = double;
  static __device__ __forceinline__ double widen(__half v) {
    return __half2float(v);
  }
  // one rounding, as XLA (and numpy) convert float64 to float16
  static __device__ __forceinline__ double round(double v) {
    unsigned short h;
    asm("cvt.rn.f16.f64 %0, %1;\n" : "=h"(h) : "d"(v));
    return __half2float(__ushort_as_half(h));
  }
};

template <>
struct Narrow<float> {
  using B = double;
  static __device__ __forceinline__ double widen(float v) { return v; }
  static __device__ __forceinline__ double round(double v) {
    return static_cast<double>(__double2float_rn(v));
  }
};

// the wide table: a float32 batch, widened exactly (its kernels, synth_wide
// and the others below, read it as it is)
template <>
struct Narrow<double> {
  using B = float;
};

// the table element of type T at byte address p (shared memory), in float64
template <typename T>
__device__ __forceinline__ double wide(const unsigned char* p) {
  return Narrow<T>::widen(*reinterpret_cast<const T*>(p));
}

// the batch element of type B at byte address p (shared memory)
template <typename B>
__device__ __forceinline__ B ld(const unsigned char* p) {
  return *reinterpret_cast<const B*>(p);
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

// 8-byte asynchronous copy of the double at src, or 8 zero bytes where n
// is 0 (src then any valid address); src and dst 8-byte aligned
__device__ __forceinline__ void cp_async8n(void* dst, const void* src,
                                           int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" :: "r"(d),
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

// the elements of type B from the 16-byte boundary below p to p
template <typename B>
__device__ __forceinline__ int eshift(const B* p) {
  return shift16(p) / static_cast<int>(sizeof(B));
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

// dst[j] = src[eshift(dst) + j] for j < n (src 16-byte aligned in shared
// memory), or 0 where src is null, by one warp: 16-byte stores along the
// run, element stores at its two ends
template <typename B>
__device__ __forceinline__ void store_run(B* dst, const B* src, int n,
                                          int lane) {
  constexpr int W = 16 / sizeof(B);  // elements a 16-byte store
  const int s = eshift(dst);
  B* base = dst - s;  // 16-byte aligned
  for (int q = lane; W * q < s + n; q += 32) {
    const int j = W * q - s;  // the run's element at base[W q]
    if (j >= 0 && j + W <= n) {
      *reinterpret_cast<uint4*>(base + W * q) =
          src ? *reinterpret_cast<const uint4*>(src + W * q)
              : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (j + e >= 0 && j + e < n) base[W * q + e] = src ? src[W * q + e] : B(0);
    }
  }
}

// o[c], o[c + 1] = v0, v1 where c, c + 1 < cv: one store of both where the
// pair is aligned to its size
__device__ __forceinline__ void store_pair(double* o, int c, int cv,
                                           double v0, double v1) {
  if (c + 1 < cv && shift16(o + c) == 0) {
    *reinterpret_cast<double2*>(o + c) = make_double2(v0, v1);
  } else {
    if (c < cv) o[c] = v0;
    if (c + 1 < cv) o[c + 1] = v1;
  }
}

__device__ __forceinline__ void store_pair(float* o, int c, int cv,
                                           float v0, float v1) {
  if (c + 1 < cv && (shift16(o + c) & 7) == 0) {
    *reinterpret_cast<float2*>(o + c) = make_float2(v0, v1);
  } else {
    if (c < cv) o[c] = v0;
    if (c + 1 < cv) o[c + 1] = v1;
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
template <int N, typename B>
__device__ __forceinline__ void keep_live(const double (&acc)[N][4], B* out) {
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  if (s == 1.2345e-300) out[0] = static_cast<B>(s);
}

// ---------------------------------------------------------------------------
// dense synthesis: grid (ring tile and column tile in x, row pair in y)
// ---------------------------------------------------------------------------

constexpr int kSynMaxWarps = 8;
constexpr int kSynDepth = 2;     // stages in flight
constexpr int kSynRows = 32;     // degree rows a stage

// The dense synthesis' plan, the same on host and device: m16 tiles a warp
// (one, 16 rings, while one block of at most 8 warps holds every ring; else
// two: half the B reads a product, half the ring tiles, each of which
// stages the batch again), ring tiles, warps a block, the bytes from one
// table row's slot to the next (at least the warps' rings and a chunk, 32
// mod 128), dynamic shared memory: DEPTH + 1 table stages, DEPTH landed x
// tiles [tc][rows eb + 16 bytes] and B [tc][rows + 4] doubles (es, eb: the
// table's and the batch's bytes an element).
struct SynthNarrowPlan {
  int mt, ntr, warps, rs, smem;
  __host__ __device__ SynthNarrowPlan(int nr, int tc, int es, int eb) {
    mt = nr <= 16 * kSynMaxWarps ? 1 : 2;
    const int wt = (nr + 16 * mt - 1) / (16 * mt);
    ntr = (wt + kSynMaxWarps - 1) / kSynMaxWarps;
    if (ntr < 1) ntr = 1;
    warps = (wt + ntr - 1) / ntr;
    if (warps < 1) warps = 1;
    const int span = 16 * mt * warps * es + 16;
    rs = (span + 95) / 128 * 128 + 32;
    smem = (kSynDepth + 1) * kSynRows * rs +
           kSynDepth * tc * (kSynRows * eb + 16) + (kSynRows + 4) * tc * 8;
  }
};

template <typename T, int TC, int MT_>
struct SynthNarrow {
  using B = typename Narrow<T>::B;  // the batch's and the output's type
  static constexpr int ES = sizeof(T), EB = sizeof(B), MT = MT_, NT = TC / 8;
  static constexpr int KS = kSynRows, DEPTH = kSynDepth;
  static constexpr int XL = KS * EB + 16;  // bytes a landed x row: its shift, its chunks
  static constexpr int XS = KS + 4;  // doubles a B row
  static constexpr int THREADS = 32 * kSynMaxWarps;
  static_assert(KS % 8 == 0 && XL % 16 == 0 && XS % 16 == 4,
                "k8 steps, a row's shift the same 8 rows on; 16-byte landing "
                "rows; B fragment banks");

  unsigned char* tb;    // table slots [DEPTH + 1][KS][rs bytes]
  unsigned char* xl;    // landed x [DEPTH][TC][XL bytes]
  double* xb;           // B: x rounded [TC][XS]
  const T* lam;         // lam[0, 0, r_lo]
  const B* x;           // x[0, c0, 0]
  B* out;               // out[0, r_lo, c0]
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
  __device__ __forceinline__ const B* xrow(const Stage& st) const {
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
    unsigned char* xs = xl + (q % DEPTH) * TC * XL;
    const B* xm = xrow(st);
    for (int e = tid; e < TC * (XL / 16); e += nth) {
      const int c = e / (XL / 16), j = e - c * (XL / 16);
      const bool ok = c < cv;
      copy_chunk(xs + c * XL, ok ? xm + c * sxc : xm, ok ? EB * st.nrows : 0,
                 j);
    }
  }

  // B[c][k] = x rounded (widened), zero past the slab and the columns
  __device__ __forceinline__ void stage(int q) {
    if (!kStaging) return;
    const Stage st = stage_at(q);
    const unsigned char* xs = xl + (q % DEPTH) * TC * XL;
    const B* xm = xrow(st);
    for (int e = tid; e < TC * KS; e += nth) {
      const int c = e / KS, k = e % KS;
      double v = 0.0;
      if (c < cv && k < st.nrows)
        v = Narrow<T>::round(
            ld<B>(xs + c * XL + shift16(xm + c * sxc) + k * EB));
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
        B* o = out + (static_cast<long long>(st.ri) * nr + r) * C;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          store_pair(o, n * 8 + 2 * tig, cv, static_cast<B>(acc[mt][n][2 * h]),
                     static_cast<B>(acc[mt][n][2 * h + 1]));
      }
    }
    zero();
  }
};

template <typename T, int TC, int MT>
__global__ void __launch_bounds__(SynthNarrow<T, TC, MT>::THREADS, 2)
    synth_narrow(const T* __restrict__ lam,
                 const typename Narrow<T>::B* __restrict__ x,
                 typename Narrow<T>::B* __restrict__ out, int L, int nr,
                 int C, long long sxm, long long sxc,
                 const int* __restrict__ ms, int M) {
  using K = SynthNarrow<T, TC, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const SynthNarrowPlan pl(nr, TC, K::ES, K::EB);
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * TC;
  const int r_lo = tile * nr / pl.ntr;
  K k;
  k.R = (tile + 1) * nr / pl.ntr - r_lo;
  k.rs = pl.rs;
  k.nch = (k.R * K::ES + 30) / 16;  // chunks of the row at any shift
  k.tb = smem;
  k.xl = smem + (K::DEPTH + 1) * K::KS * pl.rs;
  k.xb = reinterpret_cast<double*>(k.xl + K::DEPTH * TC * K::XL);
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
  using B = typename Narrow<T>::B;  // g's and the output's type
  static constexpr int ES = sizeof(T), EB = sizeof(B);
  static constexpr int BM = kAdjRows, KC = kAdjPiece / ES, DEPTH = kAdjDepth;
  static constexpr int THREADS = 32 * kAdjWarps, WR = BM / kAdjWarps;
  static constexpr int MT = WR / 16, NT = TC / 8;
  static constexpr int TW = KC * ES + 16;  // bytes a landed table row
  static constexpr int TCH = TW / 16;      // its chunks
  static constexpr int T_SLOT = BM * TW;   // bytes; DEPTH + 1 slots
  // bytes a landed g row, [c][ring] (KUNIT) : [ring][c], and its chunks
  static constexpr int GW = (KUNIT ? KC : TC) * EB + 16;
  static constexpr int GCH = GW / 16;
  static constexpr int G_TILE = (KUNIT ? TC : KC) * GW;  // bytes
  // doubles a U row: KC and the padding to 4 mod 16 (B fragment banks)
  static constexpr int US = (KC + 11) / 16 * 16 + 4;
  static constexpr int G_OFF = (DEPTH + 1) * T_SLOT;     // bytes
  static constexpr int U_OFF = G_OFF + DEPTH * G_TILE;
  static constexpr int MAIN = U_OFF + TC * US * 8;
  static constexpr int SO = BM + 4;        // epilogue [c][l - l0] elements
  static constexpr int SMEM = MAIN > TC * SO * EB ? MAIN : TC * SO * EB;
  static_assert((KC * ES) % 16 == 0 && KC % 8 == 0 && WR % 16 == 0 &&
                    GW % 16 == 0 && US % 16 == 4,
                "a row keeps its shift; k8 steps; 16-byte rows; banks");

  unsigned char* sm;
  const T* tab;         // lam[i, l0, 0]
  const B* gp;          // g[i, 0, c0]
  long long sgr, sgc;   // g's strides
  int nt, iv, cv;       // iv: rows l0 + row < L
  int tid, lane, wr0;   // wr0: the warp's first row
  int ta[MT][2];        // this lane's rows gid, gid + 8 of each m16 tile in
                        // a slot (bytes), at ring tig
  double acc[MT][NT][4];

  // the byte shift of a landed g row: of element e of column c (KUNIT), or
  // of ring e (unit stride on c)
  __device__ __forceinline__ int gshift(int c, int e) const {
    return KUNIT ? shift16(gp + c * sgc + e) : shift16(gp + e * sgr);
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
    unsigned char* gn = sm + G_OFF + (s % DEPTH) * G_TILE;
    if constexpr (KUNIT) {
      const int nv = min(nt, k0 + KC) - k0;
      for (int e = tid; e < TC * GCH; e += THREADS) {
        const int c = e / GCH, j = e - c * GCH;
        const bool ok = c < cv;
        copy_chunk(gn + c * GW, ok ? gp + c * sgc + k0 : gp, ok ? EB * nv : 0,
                   j);
      }
    } else {
      for (int e = tid; e < KC * GCH; e += THREADS) {
        const int t = e / GCH, j = e - t * GCH, r = k0 + t;
        const bool ok = r < nt;
        copy_chunk(gn + t * GW, ok ? gp + r * sgr : gp, ok ? EB * cv : 0, j);
      }
    }
  }

  // U[c][j] = g[k0 + j, c] rounded (widened), zero past the rings and the
  // columns
  __device__ __forceinline__ void stage(int s) {
    if (!kStaging) return;
    const unsigned char* gn = sm + G_OFF + (s % DEPTH) * G_TILE;
    double* U = reinterpret_cast<double*>(sm + U_OFF);
    const int k0 = s * KC;
    for (int e = tid; e < TC * KC; e += THREADS) {
      const int c = e / KC, j = e % KC, r = k0 + j;
      B v = 0;
      if (c < cv && r < nt)
        v = KUNIT ? ld<B>(gn + c * GW + gshift(c, k0) + j * EB)
                  : ld<B>(gn + j * GW + gshift(0, r) + c * EB);
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
  __device__ __forceinline__ void finish(B* out, long long soc, int lv,
                                         int zeros) {
    if (!kStores) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) keep_live(acc[mt], out);
      return;
    }
    B* so = reinterpret_cast<B*>(sm);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int l = wr0 + 16 * mt + 8 * (h >> 1) + gid;
          const int c = 8 * n + 2 * tig + (h & 1);
          so[c * SO + eshift(out + c * soc) + l] =
              static_cast<B>(acc[mt][n][h]);
        }
    __syncthreads();
    for (int c = tid >> 5; c < cv; c += THREADS / 32) {
      if (zeros > 0) store_run<B>(out + c * soc - zeros, nullptr, zeros, lane);
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
    adj_narrow(const T* __restrict__ lam,
               const typename Narrow<T>::B* __restrict__ g,
               typename Narrow<T>::B* __restrict__ out, int L, int nr, int C,
               long long sgm, long long sgr, long long sgc, long long som,
               long long soc, const int* __restrict__ ms, int M) {
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
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.wr0 = (threadIdx.x >> 5) * K::WR;
  k.init();
  run_ring(k, (nr + K::KC - 1) / K::KC);
  k.finish(out + i * som + c0 * soc + l0, soc, L - l0, tile == 0 ? m : 0);
}

// ---------------------------------------------------------------------------
// the float64 table's dense pair (Narrow<double>: a float32 batch and
// output): wide column tiles, every table double by its own 8-byte cp.async
// ---------------------------------------------------------------------------

constexpr int kWideDepth = 2;      // stages in flight
// synthesis warps a block at most (16 rings x 64 columns each: 128
// registers a thread)
constexpr int kWideSynWarps = 16;
constexpr int kWideSynRows = 32;   // synthesis degree rows a stage
constexpr int kWideColWarps = 4;   // synthesis column warps a block at most

// The ring of the wide synthesis, one barrier a stage (it has no staging
// pass): stage s's copies go DEPTH stages ahead into slot s % (DEPTH + 1)
// of the table and of x; the barrier of stage kt sees its copies landed
// and every warp's products of stage kt - 1 done, whose slots the copies
// of stage kt + DEPTH then take.
template <class K>
__device__ __forceinline__ void run_ring1(K& k, int KT) {
#pragma unroll
  for (int s = 0; s < K::DEPTH; ++s) {
    if (s < KT) k.issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<K::DEPTH - 1>();
    __syncthreads();
    if (kt + K::DEPTH < KT) k.issue(kt + K::DEPTH);
    cp_async_commit();
    k.mma(kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The wide synthesis' plan, the same on host and device (and in
// legendre_kernels.wide_synth_plan): n8 tiles a warp (4 at C <= 32, else
// 8: 64 columns), column warps (enough for C, at most kWideColWarps), ring
// warps of 16 rings (at most kWideSynWarps in all), the fewest ring tiles
// of sizes that differ by at most one ring, the ring warps the largest
// needs, column tiles, the columns a block, the
// bytes from one degree row's slot to the next (a multiple of 128 and 32: a
// lane's 16-byte read of rings 2 gid, 2 gid + 1 at degrees tig meets no
// bank twice), and dynamic shared memory: DEPTH + 1 table stages and DEPTH
// + 1 landed x tiles [tc][32 rows 4 bytes + 16].
struct SynthWidePlan {
  int nt, wn, wr, ntr, nct, tc, rs, smem;
  __host__ __device__ SynthWidePlan(int nr, int C) {
    nt = C <= 32 ? 4 : 8;
    wn = (C + 8 * nt - 1) / (8 * nt);
    if (wn > kWideColWarps) wn = kWideColWarps;
    if (wn < 1) wn = 1;
    const int wmax = kWideSynWarps / wn;
    ntr = ((nr + 15) / 16 + wmax - 1) / wmax;
    if (ntr < 1) ntr = 1;
    wr = ((nr + ntr - 1) / ntr + 15) / 16;
    if (wr < 1) wr = 1;
    tc = 8 * nt * wn;
    nct = (C + tc - 1) / tc;
    rs = (128 * wr + 63) / 128 * 128 + 32;
    smem = (kWideDepth + 1) *
           (kWideSynRows * rs + tc * (kWideSynRows * 4 + 16));
  }
};

template <int NT>
struct SynthWide {
  static constexpr int KS = kWideSynRows, DEPTH = kWideDepth, CW = 8 * NT;
  // bytes a landed x column: its shift, its chunks; 4 mod 32 words, so that
  // the lanes' B reads meet a bank at most twice
  static constexpr int XL = KS * 4 + 16, XCH = XL / 16;
  static_assert(KS % 8 == 0 && (KS * 4) % 16 == 0,
                "k8 steps; a column keeps its shift from stage to stage");

  unsigned char* tb;    // table slots [DEPTH + 1][KS][rs bytes], ring r at 8 r
  unsigned char* xl;    // landed x [DEPTH + 1][tc][XL bytes]
  const double* lam;    // lam[0, 0, r_lo]
  const float* x;       // x[0, c0, 0]
  float* out;           // out[0, r_lo, c0]
  long long sxm, sxc;
  int L, nr, C, rs, tc, R, cv;   // cv: the block's columns < C
  int ia, ib, ma, mb, na, nst;   // the row pair, row ia's stages, all stages
  int wr0, wc0;                  // the warp's first ring and first column
  double acc[NT][4];             // [n8 tile][fragment]

  struct Stage { int ri, l0, nrows; };
  // stage q: degree rows l0 .. l0 + nrows of row ri's slab
  __device__ __forceinline__ Stage stage_at(int q) const {
    const int ri = q < na ? ia : ib;
    const int l0 = q < na ? ma + KS * q : mb + KS * (q - na);
    return Stage{ri, l0, min(KS, L - l0)};
  }
  __device__ __forceinline__ const double* row0(const Stage& st) const {
    return lam + (static_cast<long long>(st.ri) * L + st.l0) * nr;
  }
  __device__ __forceinline__ const float* xrow(const Stage& st) const {
    return x + st.ri * sxm + st.l0;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[n][h] = 0.0;
  }

  // the tile's R rings of table rows l0 .. l0 + KS (past the slab: zeros),
  // a warp a row, each double at 8 r of its row's slot; x[ri, c, l0 ..] for
  // the block's columns, along l, from each column's start rounded down to
  // 16 bytes
  __device__ __forceinline__ void issue(int q) {
    if (!kCopies) return;
    const Stage st = stage_at(q);
    unsigned char* ts = tb + (q % (DEPTH + 1)) * KS * rs;
    const double* src = row0(st);
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int k = threadIdx.x >> 5; k < KS; k += nw) {
      const bool ok = k < st.nrows;
      const double* row = ok ? src + static_cast<long long>(k) * nr : src;
      for (int r = lane; r < R; r += 32)
        cp_async8n(ts + k * rs + 8 * r, ok ? row + r : src, ok ? 8 : 0);
    }
    unsigned char* xs = xl + (q % (DEPTH + 1)) * tc * XL;
    const float* xm = xrow(st);
    for (int e = threadIdx.x; e < tc * XCH; e += blockDim.x) {
      const int c = e / XCH, j = e - c * XCH;
      const bool ok = c < cv;
      copy_chunk(xs + c * XL, ok ? xm + c * sxc : xm, ok ? 4 * st.nrows : 0,
                 j);
    }
  }

  // The k8 steps that hold rows, the warp's 16 rings x CW columns; then, at
  // the last stage of a row, its sums to the output.  Fragment rows gid and
  // gid + 8 are rings 2 gid and 2 gid + 1 of the warp's, so that a lane
  // reads both at a degree in one 16-byte load; B is read from the landed
  // float32 x and widened as it is loaded.  The lane's columns wc0 + 8 n +
  // gid share one shift (8 columns are 32 sxc bytes apart).  The k8 steps
  // are not unrolled: unrolled, the next step's loads spill.
  __device__ __forceinline__ void mma(int q) {
    const Stage st = stage_at(q);
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    if (wr0 < R && wc0 < cv) {  // uniform across the warp
      const unsigned char* pa = tb + (q % (DEPTH + 1)) * KS * rs + tig * rs +
                                8 * (wr0 + 2 * gid);
      const float* xm = xrow(st) + static_cast<long long>(wc0 + gid) * sxc;
      const float* xs = reinterpret_cast<const float*>(
          xl + (q % (DEPTH + 1)) * tc * XL + (wc0 + gid) * XL +
          shift16(xm)) + tig;
      const int steps = (st.nrows + 7) / 8;
#pragma unroll 1
      for (int kk = 0; kk < KS / 8; ++kk) {
        if (kk >= steps) break;  // uniform across the warp
        // rings 2 gid, 2 gid + 1 at degrees tig, tig + 4 of the step
        const double2 lo = *reinterpret_cast<const double2*>(pa + 8 * kk * rs);
        const double2 hi =
            *reinterpret_cast<const double2*>(pa + (8 * kk + 4) * rs);
        const double a[4] = {lo.x, lo.y, hi.x, hi.y};
        if (!kProducts) {  // the shared-memory reads stay
          acc[0][0] += a[0] + a[1] + a[2] + a[3] + xs[8 * kk];
          continue;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* b = xs + n * 8 * (XL / 4) + 8 * kk;
          dmma16(acc[n], a, b[0], b[4]);
        }
      }
    }
    if (q != na - 1 && q != nst - 1) return;
    if (!kStores) {
      keep_live(acc, out);
    } else if (wr0 < R && wc0 < cv) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rings 2 gid, 2 gid + 1
        const int r = wr0 + 2 * gid + h;
        if (r >= R) continue;
        float* o = out + (static_cast<long long>(st.ri) * nr + r) * C;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          store_pair(o, wc0 + 8 * n + 2 * tig, cv,
                     static_cast<float>(acc[n][2 * h]),
                     static_cast<float>(acc[n][2 * h + 1]));
      }
    }
    zero();
  }
};

template <int NT>
__global__ void __launch_bounds__(32 * kWideSynWarps, 1)
    synth_wide(const double* __restrict__ lam, const float* __restrict__ x,
               float* __restrict__ out, int L, int nr, int C, long long sxm,
               long long sxc, const int* __restrict__ ms, int M) {
  using K = SynthWide<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const SynthWidePlan pl(nr, C);
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * pl.tc;
  const int r_lo = tile * nr / pl.ntr;
  K k;
  k.R = (tile + 1) * nr / pl.ntr - r_lo;
  k.rs = pl.rs;
  k.tc = pl.tc;
  k.tb = smem;
  k.xl = smem + (K::DEPTH + 1) * K::KS * pl.rs;
  k.lam = lam + r_lo;
  k.x = x + c0 * sxc;
  k.out = out + static_cast<long long>(r_lo) * C + c0;
  k.sxm = sxm;
  k.sxc = sxc;
  k.L = L;
  k.nr = nr;
  k.C = C;
  k.cv = min(pl.tc, C - c0);
  // rows ia and ib of degrees ma and mb; the middle row of an odd M alone
  k.ia = blockIdx.y;
  k.ib = M - 1 - k.ia;
  k.ma = degree(ms, k.ia);
  k.mb = degree(ms, k.ib);
  k.na = (L - k.ma + K::KS - 1) / K::KS;
  k.nst = k.na + (k.ib > k.ia ? (L - k.mb + K::KS - 1) / K::KS : 0);
  const int warp = threadIdx.x >> 5;
  k.wr0 = warp % pl.wr * 16;
  k.wc0 = warp / pl.wr * K::CW;
  k.zero();
  run_ring1(k, k.nst);
}

constexpr int kWideAdjRows = 128;  // adjoint rows l a block: warps of 32
constexpr int kWideAdjRings = 24;  // rings a stage: 192 bytes of each row

// the wide adjoint's columns a block / 32 at C columns: 128 columns a block
// (one block an SM) above 64
__host__ __device__ inline int adj_wide_c32(int C) {
  return C <= 32 ? 1 : (C <= 64 ? 2 : 4);
}

// C32: column warps of 32 columns a block; KUNIT: g with unit stride on r
// (else on c)
template <int C32, bool KUNIT>
struct AdjWide {
  static constexpr int BM = kWideAdjRows, KC = kWideAdjRings;
  static constexpr int DEPTH = kWideDepth, MT = 2, NT = 4, TC = 32 * C32;
  static constexpr int THREADS = 32 * (BM / 32) * C32;
  static constexpr int TPC = THREADS / TC;  // staging threads a column
  static constexpr int JT = KC / TPC;       // ... and rings a thread
  static constexpr int TW = KC * 8;         // bytes a table row's piece
  static constexpr int T_SLOT = BM * TW;    // bytes; DEPTH + 1 slots
  // bytes a landed g row, [c][ring] (KUNIT) : [ring][c], and its chunks
  static constexpr int GW = (KUNIT ? KC : TC) * 4 + 16;
  static constexpr int GCH = GW / 16;
  static constexpr int G_TILE = (KUNIT ? TC : KC) * GW;  // bytes
  static constexpr int US = KC;             // doubles a U row
  static constexpr int G_OFF = (DEPTH + 1) * T_SLOT;     // bytes
  static constexpr int U_OFF = G_OFF + DEPTH * G_TILE;
  static constexpr int MAIN = U_OFF + TC * US * 8;
  static constexpr int SO = BM + 4;         // epilogue [c][l - l0] floats
  static constexpr int SMEM = MAIN > TC * SO * 4 ? MAIN : TC * SO * 4;
  static_assert(KC % 8 == 0 && (KC * 4) % 16 == 0 && TW % 128 == 64 &&
                    (US * 8) % 128 == 64 && GW % 16 == 0 &&
                    KC % TPC == 0 && JT % 2 == 0,
                "k8 steps; a g column keeps its shift; 16-byte A and B "
                "reads of rows 64 mod 128 bytes apart meet no bank twice; "
                "the staging pass' rings a thread in pairs");

  unsigned char* sm;
  const double* tab;    // lam[i, l0, 0]
  const float* gp;      // g[i, 0, c0]
  long long sgr, sgc;   // g's strides
  int nt, iv, cv;       // iv: rows l0 + row < L
  int tid, lane, wr0, wc0;  // the warp's first row and first column
  int gsh;              // KUNIT: the byte shift of the thread's column tid / TPC
  double acc[MT][NT][4];

  // the byte shift of a landed g row: of element e of column c (KUNIT), or
  // of ring e (unit stride on c)
  __device__ __forceinline__ int gshift(int c, int e) const {
    return KUNIT ? shift16(gp + c * sgc + e) : shift16(gp + e * sgr);
  }

  __device__ __forceinline__ void init() {
    gsh = KUNIT ? gshift(tid / TPC, 0) : 0;  // the same at every stage
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mt][n][h] = 0.0;
  }

  // the rows' rings k0 .. k0 + KC (past nt: zeros; rows past the slab:
  // none), each double at 8 j of its row's slot; g[r, c] for those rings
  // (KUNIT: each column's run of rings)
  __device__ __forceinline__ void issue(int s) {
    if (!kCopies) return;
    const int k0 = s * KC;
    unsigned char* ts = sm + (s % (DEPTH + 1)) * T_SLOT;
    const int kv = min(KC, nt - k0);
    for (int e = tid; e < iv * KC; e += THREADS) {
      const int row = e / KC, j = e - row * KC;
      const double* src = tab + static_cast<long long>(row) * nt + k0;
      cp_async8n(ts + row * TW + 8 * j, j < kv ? src + j : src,
                 j < kv ? 8 : 0);
    }
    unsigned char* gn = sm + G_OFF + (s % DEPTH) * G_TILE;
    if constexpr (KUNIT) {
      for (int e = tid; e < TC * GCH; e += THREADS) {
        const int c = e / GCH, j = e - c * GCH;
        const bool ok = c < cv;
        copy_chunk(gn + c * GW, ok ? gp + c * sgc + k0 : gp, ok ? 4 * kv : 0,
                   j);
      }
    } else {
      for (int e = tid; e < KC * GCH; e += THREADS) {
        const int t = e / GCH, j = e - t * GCH, r = k0 + t;
        const bool ok = r < nt;
        copy_chunk(gn + t * GW, ok ? gp + r * sgr : gp, ok ? 4 * cv : 0, j);
      }
    }
  }

  // U[c][j] = g[k0 + j, c] widened, zero past the rings and the columns:
  // a thread its column c = tid / TPC and JT of the stage's rings
  __device__ __forceinline__ void stage(int s) {
    if (!kStaging) return;
    const unsigned char* gn = sm + G_OFF + (s % DEPTH) * G_TILE;
    const int k0 = s * KC, c = tid / TPC, j0 = tid % TPC * JT;
    double* U = reinterpret_cast<double*>(sm + U_OFF) + c * US;
#pragma unroll
    for (int j = j0; j < j0 + JT; j += 2) {
      float v[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (c < cv && k0 + j + h < nt)
          v[h] = KUNIT ? ld<float>(gn + c * GW + gsh + (j + h) * 4)
                       : ld<float>(gn + (j + h) * GW + gshift(0, k0 + j + h) +
                                   c * 4);
      *reinterpret_cast<double2*>(U + j) = make_double2(v[0], v[1]);
    }
  }

  // The k8 steps that hold rings, for the warp's 32 rows x 32 columns (rows
  // past iv read stale bytes: their sums are never stored).  The step's
  // logical degrees tig and tig + 4 are its rings 2 tig and 2 tig + 1, so
  // that a lane reads both of a row, and both of U's, in one 16-byte load.
  __device__ __forceinline__ void mma(int s) {
    if (wr0 >= iv || wc0 >= cv) return;  // uniform across the warp
    const int gid = lane >> 2, tig = lane & 3;
    const unsigned char* ts =
        sm + (s % (DEPTH + 1)) * T_SLOT + (wr0 + gid) * TW + 16 * tig;
    const double* U = reinterpret_cast<const double*>(sm + U_OFF) +
                      (wc0 + gid) * US + 2 * tig;
    const int steps = (min(KC, nt - s * KC) + 7) / 8;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      if (kk >= steps) break;  // uniform across the warp
      double a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const double2 r0 = *reinterpret_cast<const double2*>(
            ts + 16 * mt * TW + 64 * kk);
        const double2 r8 = *reinterpret_cast<const double2*>(
            ts + (16 * mt + 8) * TW + 64 * kk);
        a[mt][0] = r0.x;
        a[mt][1] = r8.x;
        a[mt][2] = r0.y;
        a[mt][3] = r8.y;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {  // B of the warp's n8 column tile n
        const double2 u =
            *reinterpret_cast<const double2*>(U + n * 8 * US + 8 * kk);
        if (!kProducts) {  // the shared-memory reads stay
          acc[0][n][0] += a[0][0] + a[0][1] + a[0][2] + a[0][3] + a[1][0] +
                          a[1][1] + a[1][2] + a[1][3] + u.x + u.y;
          continue;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) dmma16(acc[mt][n], a[mt], u.x, u.y);
      }
    }
  }

  // out[c * soc + l - l0] for c < cv, l - l0 < min(BM, lv), through shared
  // memory [c][l - l0] (each column shifted to its run's 16-byte
  // alignment), then whole runs along l, a warp a column, each right after
  // the column's zeros at out[c * soc - zeros ..]
  __device__ __forceinline__ void finish(float* out, long long soc, int lv,
                                         int zeros) {
    if (!kStores) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) keep_live(acc[mt], out);
      return;
    }
    float* so = reinterpret_cast<float*>(sm);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int l = wr0 + 16 * mt + 8 * (h >> 1) + gid;
          const int c = wc0 + 8 * n + 2 * tig + (h & 1);
          so[c * SO + eshift(out + c * soc) + l] =
              static_cast<float>(acc[mt][n][h]);
        }
    __syncthreads();
    for (int c = tid >> 5; c < cv; c += THREADS / 32) {
      if (zeros > 0) store_run<float>(out + c * soc - zeros, nullptr, zeros, lane);
      store_run(out + c * soc, so + c * SO, min(BM, lv), lane);
    }
  }
};

// sum over u = 1 .. n of ceil(u / P)
__device__ __forceinline__ int ceil_sum(int n, int P) {
  const int q = n / P, r = n - q * P;
  return P * q * (q + 1) / 2 + r * (q + 1);
}

// Block b of the (m, row tile of P rows l) pairs, m-major (full table: those
// that exist; slab: every (row, tile)), each pair's nct column tiles next to
// each other, so that the table's rows and g's row m leave device memory
// once: memory row i, degree m, row tile and column tile; false for a slab
// pair past its row's triangle (the block exits at once).
__device__ __forceinline__ bool wide_block(int b, int L, int P, int nct,
                                           const int* ms, int& i, int& m,
                                           int& tile, int& ct) {
  ct = b % nct;
  const int p = b / nct;
  if (ms) {
    const int T = (L + P - 1) / P;
    i = p / T;
    tile = p % T;
    m = degree(ms, i);
    return m + P * tile < L;
  }
  // the largest m whose pairs start at or before p
  const int all = ceil_sum(L, P);
  int lo = 0, hi = L - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (all - ceil_sum(L - mid, P) <= p) lo = mid; else hi = mid - 1;
  }
  m = i = lo;
  tile = p - (all - ceil_sum(L - m, P));
  return true;
}

template <int C32, bool KUNIT>
__global__ void __launch_bounds__(AdjWide<C32, KUNIT>::THREADS,
                                  512 / AdjWide<C32, KUNIT>::THREADS)
    adj_wide(const double* __restrict__ lam, const float* __restrict__ g,
             float* __restrict__ out, int L, int nr, int C, long long sgm,
             long long sgr, long long sgc, long long som, long long soc,
             const int* __restrict__ ms, int M) {
  using K = AdjWide<C32, KUNIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int i, m, tile, ct;
  if (!wide_block(blockIdx.x, L, K::BM, (C + K::TC - 1) / K::TC, ms, i, m,
                  tile, ct))
    return;  // uniform across the block
  const int l0 = m + K::BM * tile;
  const int c0 = ct * K::TC;
  K k;
  k.sm = smem;
  k.tab = lam + (static_cast<long long>(i) * L + l0) * nr;  // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                              // g[i, 0, c0]
  k.sgr = sgr;
  k.sgc = sgc;
  k.nt = nr;
  k.iv = min(K::BM, L - l0);
  k.cv = min(K::TC, C - c0);
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  k.wr0 = warp % (K::BM / 32) * 32;
  k.wc0 = warp / (K::BM / 32) * 32;
  k.init();
  run_ring(k, (nr + K::KC - 1) / K::KC);
  k.finish(out + i * som + c0 * soc + l0, soc, L - l0, tile == 0 ? m : 0);
}

// ---------------------------------------------------------------------------
// parity synthesis: grid (ring tile and column tile in x, row pair in y)
// ---------------------------------------------------------------------------

// degree rows of one class a stage: 32 in bfloat16 (its 64-row stages took
// 0.91x the time of 32-row ones at nr 513, C 16 and 32) and float16, 16 in
// float32 (whose 64-row stages need 128-151 KB there: one block an SM,
// 1.41-1.45x the time)
__host__ __device__ constexpr int par_kl(int es) { return es == 2 ? 32 : 16; }
constexpr int kParDepth = 2;   // stages in flight
// warps a block at most: two blocks an SM leave each thread 170 registers,
// which hold both classes' 32 accumulator doubles and a stage's operands
// without a spill (at 8 warps and 128 registers both spilled)
constexpr int kParMaxWarps = 6;

// The parity synthesis' plan, the same on host and device (and in
// legendre_kernels.narrow_par_synth_plan): m16 tiles a warp (one at 32
// columns, where two would hold 128 registers of sums, and while one block
// of at most kParMaxWarps warps holds every north ring; else two), ring
// tiles, warps a block, the bytes from one table row's slot to the next (at
// least the warps' rings and a chunk, 32 mod 128), dynamic shared memory:
// DEPTH + 1 table stages, DEPTH landed x tiles [tc][2 KL eb + 16 bytes] and
// B [tc][2 KL + 4] doubles.
struct SynthParNarrowPlan {
  int mt, ntr, warps, rs, smem;
  __host__ __device__ SynthParNarrowPlan(int nt, int tc, int es, int eb) {
    mt = tc == 32 || nt <= 16 * kParMaxWarps ? 1 : 2;
    const int wt = (nt + 16 * mt - 1) / (16 * mt);
    ntr = (wt + kParMaxWarps - 1) / kParMaxWarps;
    if (ntr < 1) ntr = 1;
    warps = (wt + ntr - 1) / ntr;
    if (warps < 1) warps = 1;
    const int span = 16 * mt * warps * es + 16;
    rs = (span + 95) / 128 * 128 + 32;
    const int kl = par_kl(es);
    smem = (kParDepth + 1) * 2 * kl * rs + kParDepth * tc * (2 * kl * eb + 16) +
           (2 * kl + 4) * tc * 8;
  }
};

template <typename T, int TC, int MT_>
struct SynthParNarrow {
  using B = typename Narrow<T>::B;  // the batch's and the output's type
  static constexpr int ES = sizeof(T), EB = sizeof(B), MT = MT_, NT = TC / 8;
  static constexpr int KL = par_kl(ES), KS = 2 * KL, DEPTH = kParDepth;
  static constexpr int XL = KS * EB + 16;  // bytes a landed x row: its shift, its chunks
  static constexpr int XS = KS + 4;  // doubles a B row: class 0's KL, class 1's
  static constexpr int THREADS = 32 * kParMaxWarps;
  static_assert(KL % 8 == 0 && XL % 16 == 0 && XS % 16 == 4,
                "k8 steps, a stage keeps each class's shifts; 16-byte "
                "landing rows; B fragment banks");

  unsigned char* tb;    // table slots [DEPTH + 1][KS][rs bytes], by class
  unsigned char* xl;    // landed x [DEPTH][TC][XL bytes]
  double* xb;           // B: x rounded [TC][XS]
  const T* lam;         // lam[0, 0, r_lo]
  const B* x;           // x[0, c0, 0]
  B* out;               // out[0, 0, c0]
  long long sxm, sxc;
  double f;
  int L, nt, nr, C, rs, nch, r_lo, R, cv;  // nch: chunks a table row
  int ia, ib, ma, mb, na, nst;   // the row pair, row ia's stages, all stages
  int tid, nth, lane, wr0;       // wr0: the warp's first ring in the tile
  double acc[2][MT][NT][4];      // [class][m16 tile][n8 tile][fragment]

  struct Stage { int ri, l0, nrows; };
  // stage q: degree rows l0 .. l0 + nrows of row ri's slab (l0 - m even)
  __device__ __forceinline__ Stage stage_at(int q) const {
    const int ri = q < na ? ia : ib;
    const int l0 = q < na ? ma + KS * q : mb + KS * (q - na);
    return Stage{ri, l0, min(KS, L - l0)};
  }
  __device__ __forceinline__ const T* row0(const Stage& st) const {
    return lam + (static_cast<long long>(st.ri) * L + st.l0) * nt;
  }
  __device__ __forceinline__ const B* xrow(const Stage& st) const {
    return x + st.ri * sxm + st.l0;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[p][mt][n][h] = 0.0;
  }

  // the tile's pieces of table rows l0 .. l0 + KS (past the slab: zeros),
  // row k into slot (k & 1) KL + k / 2 from its start rounded down to 16
  // bytes; x[ri, c, l0 ..] for the tile's columns, along l
  __device__ __forceinline__ void issue(int q) {
    if (!kCopies) return;
    const Stage st = stage_at(q);
    unsigned char* ts = tb + (q % (DEPTH + 1)) * KS * rs;
    const T* src = row0(st);
    for (int e = tid; e < KS * nch; e += nth) {
      const int k = e / nch, j = e - k * nch;
      const bool ok = k < st.nrows;
      copy_chunk(ts + ((k & 1) * KL + (k >> 1)) * rs,
                 ok ? src + static_cast<long long>(k) * nt : src,
                 ok ? R * ES : 0, j);
    }
    unsigned char* xs = xl + (q % DEPTH) * TC * XL;
    const B* xm = xrow(st);
    for (int e = tid; e < TC * (XL / 16); e += nth) {
      const int c = e / (XL / 16), j = e - c * (XL / 16);
      const bool ok = c < cv;
      copy_chunk(xs + c * XL, ok ? xm + c * sxc : xm, ok ? EB * st.nrows : 0,
                 j);
    }
  }

  // B[c][p KL + k] = x[ri, c, l0 + 2 k + p] rounded (widened), zero past
  // the slab and the columns
  __device__ __forceinline__ void stage(int q) {
    if (!kStaging) return;
    const Stage st = stage_at(q);
    const unsigned char* xs = xl + (q % DEPTH) * TC * XL;
    const B* xm = xrow(st);
    for (int e = tid; e < TC * KS; e += nth) {
      const int c = e / KS, k = e % KS;
      double v = 0.0;
      if (c < cv && k < st.nrows)
        v = Narrow<T>::round(
            ld<B>(xs + c * XL + shift16(xm + c * sxc) + k * EB));
      xb[c * XS + (k & 1) * KL + (k >> 1)] = v;
    }
  }

  // each class's k8 steps that hold rows; then, at the last stage of a row,
  // north SE + SO and south f (SE - SO) to the output.  Slot row j of class
  // p is the stage's row 2 j + p, at j rs + its source's shift, which is
  // that of slot rows j + 4 and j + 8 too (rows 8 and 16 apart: 8 nt es is
  // a multiple of 16): a lane's rows tig and tig + 4 of every k8 step keep
  // one shift over the stage.
  __device__ __forceinline__ void mma(int q) {
    const Stage st = stage_at(q);
    const int gid = lane >> 2, tig = lane & 3;
    if (wr0 < R) {  // uniform across the warp
      const unsigned char* ts =
          tb + (q % (DEPTH + 1)) * KS * rs + (wr0 + gid) * ES;
      const int s0 = shift16(row0(st));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const unsigned char* pa =
            ts + (p * KL + tig) * rs + ((s0 + (2 * tig + p) * nt * ES) & 15);
        const double* xs = xb + gid * XS + p * KL + tig;
        const int steps = ((st.nrows + 1 - p) / 2 + 7) / 8;
#pragma unroll
        for (int kk = 0; kk < KL / 8; ++kk) {
          if (kk >= steps) break;
          // rings 16 mt + gid, + 8 at class rows tig, tig + 4 of the step
          double a[MT][4], b[NT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const unsigned char* r0 = pa + 8 * kk * rs + 16 * mt * ES;
            const unsigned char* r4 = r0 + 4 * rs;
            a[mt][0] = wide<T>(r0);
            a[mt][1] = wide<T>(r0 + 8 * ES);
            a[mt][2] = wide<T>(r4);
            a[mt][3] = wide<T>(r4 + 8 * ES);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            b[n][0] = xs[n * 8 * XS + 8 * kk];
            b[n][1] = xs[n * 8 * XS + 8 * kk + 4];
          }
          if (!kProducts) {  // the shared-memory reads stay
            acc[p][0][0][0] += a[0][0] + a[0][1] + a[0][2] + a[0][3] +
                               b[0][0] + b[0][1];
            continue;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < NT; ++n)
              dmma16(acc[p][mt][n], a[mt], b[n][0], b[n][1]);
        }
      }
    }
    if (q != na - 1 && q != nst - 1) return;
    if (!kStores) {
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) keep_live(acc[p][mt], out);
    }
    if (kStores && wr0 < R) {
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {  // rings 16 mt + gid, + 8
        const int mt = i >> 1, h = i & 1;
        const int r = wr0 + 16 * mt + 8 * h + gid;
        if (r >= R) continue;
        const int rn = r_lo + r;
        B* on = out + (static_cast<long long>(st.ri) * nr + rn) * C;
        B* os = out + (static_cast<long long>(st.ri) * nr + nr - 1 - rn) * C;
        const bool south = rn < nr - nt;  // not the equator
        const B fb = static_cast<B>(f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // each class's sums in B, then combined in B (the JAX package's
          // split synthesis rounds E and O to the compute dtype first)
          const int c = n * 8 + 2 * tig;
          const B e0 = static_cast<B>(acc[0][mt][n][2 * h]);
          const B e1 = static_cast<B>(acc[0][mt][n][2 * h + 1]);
          const B o0 = static_cast<B>(acc[1][mt][n][2 * h]);
          const B o1 = static_cast<B>(acc[1][mt][n][2 * h + 1]);
          store_pair(on, c, cv, e0 + o0, e1 + o1);
          if (south) store_pair(os, c, cv, fb * (e0 - o0), fb * (e1 - o1));
        }
      }
    }
    zero();
  }
};

template <typename T, int TC, int MT>
__global__ void __launch_bounds__(SynthParNarrow<T, TC, MT>::THREADS, 2)
    synth_par_narrow(const T* __restrict__ lam,
                     const typename Narrow<T>::B* __restrict__ x,
                     typename Narrow<T>::B* __restrict__ out, int L, int nr,
                     int C, long long sxm, long long sxc,
                     const int* __restrict__ ms, int M, double f) {
  using K = SynthParNarrow<T, TC, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = (nr + 1) / 2;  // the table's rings
  const SynthParNarrowPlan pl(nt, TC, K::ES, K::EB);
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * TC;
  K k;
  k.r_lo = tile * nt / pl.ntr;
  k.R = (tile + 1) * nt / pl.ntr - k.r_lo;
  k.rs = pl.rs;
  k.nch = (k.R * K::ES + 30) / 16;  // chunks of the row at any shift
  k.tb = smem;
  k.xl = smem + (K::DEPTH + 1) * K::KS * pl.rs;
  k.xb = reinterpret_cast<double*>(k.xl + K::DEPTH * TC * K::XL);
  k.lam = lam + k.r_lo;
  k.x = x + c0 * sxc;
  k.out = out + c0;
  k.sxm = sxm;
  k.sxc = sxc;
  k.f = f;
  k.L = L;
  k.nt = nt;
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
// parity adjoint: grid ((m, row tile) pairs in x, column tiles in y)
// ---------------------------------------------------------------------------

constexpr int kAdjParRows = 128;  // rows l of each class a block

// KUNIT: g with unit stride on r (else on c)
template <typename T, int TC, bool KUNIT>
struct AdjParNarrow {
  using B = typename Narrow<T>::B;  // g's and the output's type
  static constexpr int ES = sizeof(T), EB = sizeof(B);
  static constexpr int BM = kAdjParRows, KC = kAdjPiece / ES, DEPTH = kAdjDepth;
  static constexpr int THREADS = 32 * kAdjWarps;
  static constexpr int WR = 2 * BM / kAdjWarps;  // rows of a warp, one class
  static constexpr int MT = WR / 16, NT = TC / 8;
  static constexpr int TW = KC * ES + 16;  // bytes a landed table row
  static constexpr int TCH = TW / 16;      // its chunks
  static constexpr int T_SLOT = 2 * BM * TW;  // bytes; DEPTH + 1 slots
  // bytes a landed g row, [c][ring] (KUNIT) : [ring][c], and its chunks
  static constexpr int GW = (KUNIT ? KC : TC) * EB + 16;
  static constexpr int GCH = GW / 16;
  static constexpr int G_TILE = (KUNIT ? TC : KC) * GW;  // bytes: north, south
  // doubles a U row: KC and the padding to 4 mod 16 (B fragment banks)
  static constexpr int US = (KC + 11) / 16 * 16 + 4;
  static constexpr int G_OFF = (DEPTH + 1) * T_SLOT;     // bytes
  static constexpr int U_OFF = G_OFF + DEPTH * 2 * G_TILE;
  static constexpr int MAIN = U_OFF + 2 * TC * US * 8;   // U_p [p][c][ring]
  static constexpr int SO = 2 * BM + 4;    // epilogue [c][l - l0] elements
  static constexpr int SMEM = MAIN > TC * SO * EB ? MAIN : TC * SO * EB;
  static_assert((KC * ES) % 16 == 0 && KC % 8 == 0 && WR % 16 == 0 &&
                    GW % 16 == 0 && US % 16 == 4 &&
                    kAdjWarps % 2 == 0 && SMEM <= 113 * 1024,
                "a row keeps its shift; k8 steps; 16-byte rows; banks; "
                "warps by class; two blocks an SM");

  unsigned char* sm;
  const T* tab;         // lam[i, l0, 0]
  const B* gp;          // g[i, 0, c0]
  long long sgr, sgc;   // g's strides
  double f;
  int nt, nr, nv, cv;   // nv: rows l0 + j < L
  int tid, lane, cls, wr0;  // the warp's class and first row in it
  int ta[MT][2];        // this lane's rows gid, gid + 8 of each m16 tile in
                        // a slot (bytes), at ring tig
  double acc[MT][NT][4];

  // the byte shift of a landed g row: of element e of column c (KUNIT), or
  // of ring e (unit stride on c)
  __device__ __forceinline__ int gshift(int c, int e) const {
    return KUNIT ? shift16(gp + c * sgc + e) : shift16(gp + e * sgr);
  }

  // the lane's rows l0 + 2 (wr0 + 16 mt + gid (+ 8)) + cls at ring tig:
  // slot row cls BM + i', the row's shift (the same at every stage: a stage
  // is KC es = 64 bytes)
  __device__ __forceinline__ void init() {
    const int gid = lane >> 2, tig = lane & 3;
    const int sh0 = shift16(tab);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ip = wr0 + 16 * mt + 8 * h + gid;
        const int j = 2 * ip + cls;
        ta[mt][h] = (cls * BM + ip) * TW + ((sh0 + j * nt * ES) & 15) + tig * ES;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mt][n][h] = 0.0;
    }
  }

  // rings with a south mirror: r < nr - nt (the equator of an odd nr has
  // none); the south rows that a stage at k0 lands: nr - k0 - sv ..
  __device__ __forceinline__ int south_rings(int k0) const {
    return max(min(nr - nt, k0 + KC) - k0, 0);
  }

  // the rows' pieces of rings k0 .. k0 + KC (rows past L: none), row l0 + j
  // into slot (j & 1) BM + j / 2; g[r, c] and g[nr - 1 - r, c] for those
  // rings (KUNIT: each column's run of north rings and of their mirrors)
  __device__ __forceinline__ void issue(int s) {
    if (!kCopies) return;
    const int k0 = s * KC;
    unsigned char* ts = sm + (s % (DEPTH + 1)) * T_SLOT;
    const int vb = min(KC, nt - k0) * ES;
    for (int e = tid; e < nv * TCH; e += THREADS) {
      const int j = e / TCH, ch = e - j * TCH;
      copy_chunk(ts + ((j & 1) * BM + (j >> 1)) * TW,
                 tab + static_cast<long long>(j) * nt + k0, vb, ch);
    }
    unsigned char* gn = sm + G_OFF + (s % DEPTH) * 2 * G_TILE;
    unsigned char* gs = gn + G_TILE;
    const int sv = south_rings(k0);
    if constexpr (KUNIT) {
      const int vn = min(nt, k0 + KC) - k0;
      const int slo = nr - k0 - sv;
      for (int e = tid; e < TC * GCH; e += THREADS) {
        const int c = e / GCH, j = e - c * GCH;
        const bool ok = c < cv;
        const B* col = ok ? gp + c * sgc : gp;
        copy_chunk(gn + c * GW, col + (ok ? k0 : 0), ok ? EB * vn : 0, j);
        copy_chunk(gs + c * GW, col + (ok && sv ? slo : 0),
                   ok ? EB * sv : 0, j);
      }
    } else {
      for (int e = tid; e < KC * GCH; e += THREADS) {
        const int t = e / GCH, j = e - t * GCH, r = k0 + t;
        copy_chunk(gn + t * GW, r < nt ? gp + r * sgr : gp,
                   r < nt ? EB * cv : 0, j);
        copy_chunk(gs + t * GW, t < sv ? gp + (nr - 1 - r) * sgr : gp,
                   t < sv ? EB * cv : 0, j);
      }
    }
  }

  // U_p[c][j] = round(g_n + sg_p g_s) at ring k0 + j, sg_p = f for even
  // l - m, -f for odd (the fold formed in g's type, then rounded or
  // widened once); zero past the rings and the columns
  __device__ __forceinline__ void stage(int s) {
    if (!kStaging) return;
    const unsigned char* gn = sm + G_OFF + (s % DEPTH) * 2 * G_TILE;
    const unsigned char* gs = gn + G_TILE;
    double* U = reinterpret_cast<double*>(sm + U_OFF);
    const int k0 = s * KC, sv = south_rings(k0), slo = nr - k0 - sv;
    for (int e = tid; e < TC * KC; e += THREADS) {
      const int c = e / KC, j = e % KC, r = k0 + j;
      double u = 0.0, v = 0.0;
      if (c < cv && r < nt) {
        B a, b = 0;
        if constexpr (KUNIT) {
          a = ld<B>(gn + c * GW + gshift(c, k0) + j * EB);
          if (j < sv)
            b = ld<B>(gs + c * GW + gshift(c, slo) + (nr - 1 - r - slo) * EB);
        } else {
          a = ld<B>(gn + j * GW + gshift(0, r) + c * EB);
          if (j < sv) b = ld<B>(gs + j * GW + gshift(0, nr - 1 - r) + c * EB);
        }
        b *= static_cast<B>(f);
        u = Narrow<T>::round(static_cast<B>(a + b));
        v = Narrow<T>::round(static_cast<B>(a - b));
      }
      U[c * US + j] = u;
      U[(TC + c) * US + j] = v;
    }
  }

  // the k8 steps that hold rings, for the warp's rows of its class (rows
  // past L read stale bytes: their sums are never stored)
  __device__ __forceinline__ void mma(int s) {
    if (wr0 >= (nv + 1 - cls) / 2) return;  // uniform across the warp
    const unsigned char* ts = sm + (s % (DEPTH + 1)) * T_SLOT;
    const int gid = lane >> 2, tig = lane & 3;
    const double* U = reinterpret_cast<const double*>(sm + U_OFF) +
                      (cls * TC + gid) * US + tig;
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

  // out[c * soc + l - l0] for c < cv, l - l0 < nv, both classes through
  // shared memory [c][l - l0] (each column shifted to its run's 16-byte
  // alignment), then whole runs along l, a warp a column, each right after
  // the column's zeros at out[c * soc - zeros ..]
  __device__ __forceinline__ void finish(B* out, long long soc, int zeros) {
    if (!kStores) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) keep_live(acc[mt], out);
      return;
    }
    B* so = reinterpret_cast<B*>(sm);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int l = 2 * (wr0 + 16 * mt + 8 * (h >> 1) + gid) + cls;
          const int c = 8 * n + 2 * tig + (h & 1);
          so[c * SO + eshift(out + c * soc) + l] =
              static_cast<B>(acc[mt][n][h]);
        }
    __syncthreads();
    for (int c = tid >> 5; c < cv; c += THREADS / 32) {
      if (zeros > 0) store_run<B>(out + c * soc - zeros, nullptr, zeros, lane);
      store_run(out + c * soc, so + c * SO, nv, lane);
    }
  }
};

template <typename T, int TC, bool KUNIT>
__global__ void __launch_bounds__(AdjParNarrow<T, TC, KUNIT>::THREADS, 2)
    adj_par_narrow(const T* __restrict__ lam,
                   const typename Narrow<T>::B* __restrict__ g,
                   typename Narrow<T>::B* __restrict__ out, int L, int nr,
                   int C, long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* __restrict__ ms,
                   int M, double f) {
  using K = AdjParNarrow<T, TC, KUNIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = 2 * K::BM;  // rows l a tile
  const int nt = (nr + 1) / 2;  // the table's rings
  // (memory row i, degree m, row tile): tile-major over the rows
  int i, m, tile;
  if (ms) {  // every (row, tile) pair; those past the row's triangle exit
    tile = blockIdx.x / M;
    i = blockIdx.x % M;
    m = degree(ms, i);
    if (m + P * tile >= L) return;  // uniform across the block
  } else {  // the pairs that exist: rows m < L - P tile
    m = blockIdx.x;
    tile = 0;
    while (m >= L - P * tile) {
      m -= L - P * tile;
      ++tile;
    }
    i = m;
  }
  const int l0 = m + P * tile;
  const int c0 = blockIdx.y * TC;
  const int warp = threadIdx.x >> 5;
  K k;
  k.sm = smem;
  k.tab = lam + (static_cast<long long>(i) * L + l0) * nt;  // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                              // g[i, 0, c0]
  k.sgr = sgr;
  k.sgc = sgc;
  k.f = f;
  k.nt = nt;
  k.nr = nr;
  k.nv = min(P, L - l0);
  k.cv = min(TC, C - c0);
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.cls = warp / (kAdjWarps / 2);
  k.wr0 = warp % (kAdjWarps / 2) * K::WR;
  k.init();
  run_ring(k, (nt + K::KC - 1) / K::KC);
  k.finish(out + i * som + c0 * soc + l0, soc, tile == 0 ? m : 0);
}

// ---------------------------------------------------------------------------
// the float64 table's parity pair (Narrow<double>: a float32 batch and
// output): the wide dense pair's blocks with both classes of l - m in one
// block
// ---------------------------------------------------------------------------

constexpr int kWideParRows = 32;      // synthesis degree rows a stage, half
                                      // of each class
constexpr int kWideParColWarps = 4;   // synthesis column warps a block at most
constexpr int kWideParAdjRows = 128;  // adjoint rows l a block, half of each
                                      // class: warps of 32 rows of one class
constexpr int kWideParAdjRings = 24;  // adjoint rings a stage

// The wide parity synthesis' plan, the same on host and device (and in
// legendre_kernels.wide_par_synth_plan): n8 tiles a warp (4 at C <= 32, else
// 8: 64 columns), column warps (enough for C, at most kWideParColWarps), a
// warp of each class for every 16 rings x those columns (at most
// kWideSynWarps warps in all), the fewest ring tiles of nh north rings, of
// sizes that differ by at most one ring, the ring warps the largest needs,
// column tiles, the columns a block, the bytes from one degree row's slot to
// the next (as SynthWidePlan's), and dynamic shared memory: DEPTH + 1 table
// stages and landed x tiles [tc][32 rows 4 bytes + 16], then the odd class's
// sums handed over at a row's end, [warp pair][4 nt][32 lanes] floats.
struct SynthParWidePlan {
  int nt, wn, wr, ntr, nct, tc, rs, smem;
  __host__ __device__ SynthParWidePlan(int nh, int C) {
    nt = C <= 32 ? 4 : 8;
    wn = (C + 8 * nt - 1) / (8 * nt);
    if (wn > kWideParColWarps) wn = kWideParColWarps;
    if (wn < 1) wn = 1;
    const int wmax = kWideSynWarps / (2 * wn);
    ntr = ((nh + 15) / 16 + wmax - 1) / wmax;
    if (ntr < 1) ntr = 1;
    wr = ((nh + ntr - 1) / ntr + 15) / 16;
    if (wr < 1) wr = 1;
    tc = 8 * nt * wn;
    nct = (C + tc - 1) / tc;
    rs = (128 * wr + 63) / 128 * 128 + 32;
    smem = (kWideDepth + 1) *
               (kWideParRows * rs + tc * (kWideParRows * 4 + 16)) +
           wr * wn * 4 * nt * 32 * 4;
  }
};

template <int NT>
struct SynthParWide {
  static constexpr int KS = kWideParRows, KL = KS / 2, DEPTH = kWideDepth;
  static constexpr int CW = 8 * NT;
  // bytes a landed x column: its shift, its chunks
  static constexpr int XL = KS * 4 + 16, XCH = XL / 16;
  static constexpr int HO = 4 * NT * 32;  // floats a warp pair's hand-over
  static_assert(KL % 8 == 0 && (KS * 4) % 16 == 0,
                "each class's k8 steps; a column keeps its shift from stage "
                "to stage");

  unsigned char* tb;    // table slots [DEPTH + 1][KS][rs bytes] by class,
                        // ring r at 8 r
  unsigned char* xl;    // landed x [DEPTH + 1][tc][XL bytes]
  float* ho;            // the warp pair's hand-over [4 NT][32 lanes]
  const double* lam;    // lam[0, 0, r_lo]
  const float* x;       // x[0, c0, 0]
  float* out;           // out[0, 0, c0]
  long long sxm, sxc;
  float f;
  int L, nt, nr, C, rs, tc, r_lo, R, cv;  // cv: the block's columns < C
  int ia, ib, ma, mb, na, nst;   // the row pair, row ia's stages, all stages
  int cls, wr0, wc0;             // the warp's class, first ring, first column
  double acc[NT][4];             // [n8 tile][fragment]

  struct Stage { int ri, l0, nrows; };
  // stage q: degree rows l0 .. l0 + nrows of row ri's slab (l0 - m even)
  __device__ __forceinline__ Stage stage_at(int q) const {
    const int ri = q < na ? ia : ib;
    const int l0 = q < na ? ma + KS * q : mb + KS * (q - na);
    return Stage{ri, l0, min(KS, L - l0)};
  }
  __device__ __forceinline__ const double* row0(const Stage& st) const {
    return lam + (static_cast<long long>(st.ri) * L + st.l0) * nt;
  }
  __device__ __forceinline__ const float* xrow(const Stage& st) const {
    return x + st.ri * sxm + st.l0;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[n][h] = 0.0;
  }

  // the tile's R rings of table rows l0 .. l0 + KS (past the slab: zeros),
  // row k into slot row (k & 1) KL + k / 2, a warp a row, each double at 8 r
  // of its row's slot; x[ri, c, l0 ..] for the block's columns, along l,
  // from each column's start rounded down to 16 bytes
  __device__ __forceinline__ void issue(int q) {
    if (!kCopies) return;
    const Stage st = stage_at(q);
    unsigned char* ts = tb + (q % (DEPTH + 1)) * KS * rs;
    const double* src = row0(st);
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int k = threadIdx.x >> 5; k < KS; k += nw) {
      const bool ok = k < st.nrows;
      const double* row = ok ? src + static_cast<long long>(k) * nt : src;
      unsigned char* slot = ts + ((k & 1) * KL + (k >> 1)) * rs;
      for (int r = lane; r < R; r += 32)
        cp_async8n(slot + 8 * r, ok ? row + r : src, ok ? 8 : 0);
    }
    unsigned char* xs = xl + (q % (DEPTH + 1)) * tc * XL;
    const float* xm = xrow(st);
    for (int e = threadIdx.x; e < tc * XCH; e += blockDim.x) {
      const int c = e / XCH, j = e - c * XCH;
      const bool ok = c < cv;
      copy_chunk(xs + c * XL, ok ? xm + c * sxc : xm, ok ? 4 * st.nrows : 0,
                 j);
    }
  }

  // The warp's class' k8 steps that hold rows, its 16 rings x CW columns;
  // then, at the last stage of a row, the odd class hands its sums, rounded
  // to float32, to its partner warp of the even class through shared memory
  // (lane to lane: both hold the same fragments), which writes north SE +
  // SO and, for the rings r < nr - nt that have a mirror, south f (SE - SO).
  // Fragment rows gid and gid + 8 are rings 2 gid and 2 gid + 1 of the
  // warp's, read in one 16-byte load; class row j of the k8 step is the
  // stage's degree row 2 j + cls, whose x is read from the landed float32 x
  // and widened as it is loaded.  The k8 steps are not unrolled (as
  // synth_wide's).
  __device__ __forceinline__ void mma(int q) {
    const Stage st = stage_at(q);
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const bool live = wr0 < R && wc0 < cv;  // uniform across the warp
    if (live) {
      const unsigned char* pa = tb + (q % (DEPTH + 1)) * KS * rs +
                                (cls * KL + tig) * rs + 8 * (wr0 + 2 * gid);
      const float* xm = xrow(st) + static_cast<long long>(wc0 + gid) * sxc;
      const float* xs = reinterpret_cast<const float*>(
          xl + (q % (DEPTH + 1)) * tc * XL + (wc0 + gid) * XL +
          shift16(xm)) + 2 * tig + cls;
      const int steps = ((st.nrows + 1 - cls) / 2 + 7) / 8;
#pragma unroll 1
      for (int kk = 0; kk < KL / 8; ++kk) {
        if (kk >= steps) break;  // uniform across the warp
        // rings 2 gid, 2 gid + 1 at class rows tig, tig + 4 of the step
        const double2 lo = *reinterpret_cast<const double2*>(pa + 8 * kk * rs);
        const double2 hi =
            *reinterpret_cast<const double2*>(pa + (8 * kk + 4) * rs);
        const double a[4] = {lo.x, lo.y, hi.x, hi.y};
        if (!kProducts) {  // the shared-memory reads stay
          acc[0][0] += a[0] + a[1] + a[2] + a[3] + xs[16 * kk];
          continue;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* b = xs + n * 8 * (XL / 4) + 16 * kk;
          dmma16(acc[n], a, b[0], b[8]);
        }
      }
    }
    if (q != na - 1 && q != nst - 1) return;  // uniform across the block
    if (!kStores) {
      keep_live(acc, out);
      zero();
      return;
    }
    if (cls == 1 && live) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h)
          ho[(4 * n + h) * 32 + lane] = static_cast<float>(acc[n][h]);
    }
    __syncthreads();  // the hand-over written; read before the next stage's
    if (cls == 0 && live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rings 2 gid, 2 gid + 1
        const int r = wr0 + 2 * gid + h;
        if (r >= R) continue;
        const int rn = r_lo + r;
        float* on = out + (static_cast<long long>(st.ri) * nr + rn) * C;
        float* os = out + (static_cast<long long>(st.ri) * nr + nr - 1 - rn) * C;
        const bool south = rn < nr - nt;  // not the equator
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // each class's sums in float32, then combined in float32 (the JAX
          // package's split synthesis rounds E and O to the compute dtype
          // first)
          const int c = wc0 + 8 * n + 2 * tig;
          const float e0 = static_cast<float>(acc[n][2 * h]);
          const float e1 = static_cast<float>(acc[n][2 * h + 1]);
          const float o0 = ho[(4 * n + 2 * h) * 32 + lane];
          const float o1 = ho[(4 * n + 2 * h + 1) * 32 + lane];
          store_pair(on, c, cv, e0 + o0, e1 + o1);
          if (south) store_pair(os, c, cv, f * (e0 - o0), f * (e1 - o1));
        }
      }
    }
    zero();
  }
};

template <int NT>
__global__ void __launch_bounds__(32 * kWideSynWarps, 1)
    synth_par_wide(const double* __restrict__ lam,
                   const float* __restrict__ x, float* __restrict__ out,
                   int L, int nr, int C, long long sxm, long long sxc,
                   const int* __restrict__ ms, int M, double f) {
  using K = SynthParWide<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = (nr + 1) / 2;  // the table's rings
  const SynthParWidePlan pl(nt, C);
  const int tile = blockIdx.x % pl.ntr;
  const int c0 = (blockIdx.x / pl.ntr) * pl.tc;
  // warp: class-major, then column warp, then ring warp
  const int warp = threadIdx.x >> 5, pairs = pl.wr * pl.wn;
  const int pair = warp % pairs;
  K k;
  k.r_lo = tile * nt / pl.ntr;
  k.R = (tile + 1) * nt / pl.ntr - k.r_lo;
  k.rs = pl.rs;
  k.tc = pl.tc;
  k.tb = smem;
  k.xl = smem + (K::DEPTH + 1) * K::KS * pl.rs;
  k.ho = reinterpret_cast<float*>(k.xl + (K::DEPTH + 1) * pl.tc * K::XL) +
         pair * K::HO;
  k.lam = lam + k.r_lo;
  k.x = x + c0 * sxc;
  k.out = out + c0;
  k.sxm = sxm;
  k.sxc = sxc;
  k.f = static_cast<float>(f);
  k.L = L;
  k.nt = nt;
  k.nr = nr;
  k.C = C;
  k.cv = min(pl.tc, C - c0);
  // rows ia and ib of degrees ma and mb; the middle row of an odd M alone
  k.ia = blockIdx.y;
  k.ib = M - 1 - k.ia;
  k.ma = degree(ms, k.ia);
  k.mb = degree(ms, k.ib);
  k.na = (L - k.ma + K::KS - 1) / K::KS;
  k.nst = k.na + (k.ib > k.ia ? (L - k.mb + K::KS - 1) / K::KS : 0);
  k.cls = warp / pairs;
  k.wr0 = pair % pl.wr * 16;
  k.wc0 = pair / pl.wr * K::CW;
  k.zero();
  run_ring1(k, k.nst);
}

// C32: column warps of 32 columns a block (adj_wide_c32); KUNIT: g with
// unit stride on r (else on c)
template <int C32, bool KUNIT>
struct AdjParWide {
  static constexpr int P = kWideParAdjRows, BM = P / 2;  // rows l, of a class
  static constexpr int KC = kWideParAdjRings, DEPTH = kWideDepth;
  static constexpr int MT = 2, NT = 4, TC = 32 * C32;
  static constexpr int THREADS = 32 * (P / 32) * C32;
  static constexpr int TW = KC * 8;         // bytes a table row's piece
  static constexpr int T_SLOT = P * TW;     // bytes; DEPTH + 1 slots
  // bytes a landed g row, [c][ring] (KUNIT) : [ring][c], and its chunks
  static constexpr int GW = (KUNIT ? KC : TC) * 4 + 16;
  static constexpr int GCH = GW / 16;
  static constexpr int G_TILE = (KUNIT ? TC : KC) * GW;  // bytes: north, south
  static constexpr int US = KC;             // doubles a U or V row
  static constexpr int G_OFF = (DEPTH + 1) * T_SLOT;     // bytes
  static constexpr int U_OFF = G_OFF + DEPTH * 2 * G_TILE;
  static constexpr int MAIN = U_OFF + 2 * TC * US * 8;   // U, V [c][ring]
  static constexpr int SO = P + 4;          // epilogue [c][l - l0] floats
  static constexpr int SMEM = MAIN > TC * SO * 4 ? MAIN : TC * SO * 4;
  static_assert(KC % 8 == 0 && (KC * 4) % 16 == 0 && TW % 128 == 64 &&
                    (US * 8) % 128 == 64 && GW % 16 == 0 && BM % 32 == 0,
                "k8 steps; a g column keeps its north shift; 16-byte A and "
                "B reads of rows 64 mod 128 bytes apart meet no bank twice; "
                "warps by class");

  unsigned char* sm;
  const double* tab;    // lam[i, l0, 0]
  const float* gp;      // g[i, 0, c0]
  long long sgr, sgc;   // g's strides
  float f;
  int nt, nr, nv, cv;   // nv: rows l0 + j < L
  int tid, lane, cls, wr0, wc0;  // the warp's class, first row in it, first
                                 // column
  double acc[MT][NT][4];

  // the byte shift of a landed g row: of element e of column c (KUNIT), or
  // of ring e (unit stride on c)
  __device__ __forceinline__ int gshift(int c, int e) const {
    return KUNIT ? shift16(gp + c * sgc + e) : shift16(gp + e * sgr);
  }

  // rings with a south mirror: r < nr - nt (the equator of an odd nr has
  // none); the south rings that a stage at k0 lands: nr - k0 - sv ..
  __device__ __forceinline__ int south_rings(int k0) const {
    return max(min(nr - nt, k0 + KC) - k0, 0);
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mt][n][h] = 0.0;
  }

  // the rows' rings k0 .. k0 + KC (past nt: zeros; rows past L: none), row
  // l0 + j into slot row (j & 1) BM + j / 2, each double at 8 jj of its
  // slot; g[r, c] and g[nr - 1 - r, c] for those rings (KUNIT: each
  // column's run of north rings and of their mirrors)
  __device__ __forceinline__ void issue(int s) {
    if (!kCopies) return;
    const int k0 = s * KC;
    unsigned char* ts = sm + (s % (DEPTH + 1)) * T_SLOT;
    const int kv = min(KC, nt - k0);
    for (int e = tid; e < nv * KC; e += THREADS) {
      const int row = e / KC, jj = e - row * KC;
      const double* src = tab + static_cast<long long>(row) * nt + k0;
      cp_async8n(ts + ((row & 1) * BM + (row >> 1)) * TW + 8 * jj,
                 jj < kv ? src + jj : src, jj < kv ? 8 : 0);
    }
    unsigned char* gn = sm + G_OFF + (s % DEPTH) * 2 * G_TILE;
    unsigned char* gs = gn + G_TILE;
    const int sv = south_rings(k0);
    if constexpr (KUNIT) {
      const int slo = nr - k0 - sv;
      for (int e = tid; e < TC * GCH; e += THREADS) {
        const int c = e / GCH, j = e - c * GCH;
        const bool ok = c < cv;
        const float* col = ok ? gp + c * sgc : gp;
        copy_chunk(gn + c * GW, col + (ok ? k0 : 0), ok ? 4 * kv : 0, j);
        copy_chunk(gs + c * GW, col + (ok && sv ? slo : 0), ok ? 4 * sv : 0,
                   j);
      }
    } else {
      for (int e = tid; e < KC * GCH; e += THREADS) {
        const int t = e / GCH, j = e - t * GCH, r = k0 + t;
        copy_chunk(gn + t * GW, r < nt ? gp + r * sgr : gp,
                   r < nt ? 4 * cv : 0, j);
        copy_chunk(gs + t * GW, t < sv ? gp + (nr - 1 - r) * sgr : gp,
                   t < sv ? 4 * cv : 0, j);
      }
    }
  }

  // U[c][j] = widen(g_n + f g_s), V[c][j] = widen(g_n - f g_s) at ring k0 +
  // j (the fold formed in float32, then widened), zero past the rings and
  // the columns: a thread a column's two rings j, j + 1 at a time
  __device__ __forceinline__ void stage(int s) {
    if (!kStaging) return;
    const unsigned char* gn = sm + G_OFF + (s % DEPTH) * 2 * G_TILE;
    const unsigned char* gs = gn + G_TILE;
    const int k0 = s * KC, sv = south_rings(k0), slo = nr - k0 - sv;
    for (int e = tid; e < TC * (KC / 2); e += THREADS) {
      const int c = e / (KC / 2), j = 2 * (e - c * (KC / 2));
      double* U = reinterpret_cast<double*>(sm + U_OFF) + c * US;
      double* V = U + TC * US;
      const int shn = KUNIT ? gshift(c, k0) : 0;
      const int shs = KUNIT ? gshift(c, slo) : 0;
      float u[2] = {0.0f, 0.0f}, v[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = k0 + j + h;
        if (c < cv && r < nt) {
          float a, b = 0.0f;
          if constexpr (KUNIT) {
            a = ld<float>(gn + c * GW + shn + (j + h) * 4);
            if (j + h < sv)
              b = ld<float>(gs + c * GW + shs + (sv - 1 - j - h) * 4);
          } else {
            a = ld<float>(gn + (j + h) * GW + gshift(0, r) + c * 4);
            if (j + h < sv)
              b = ld<float>(gs + (j + h) * GW + gshift(0, nr - 1 - r) + c * 4);
          }
          b *= f;
          u[h] = a + b;
          v[h] = a - b;
        }
      }
      *reinterpret_cast<double2*>(U + j) = make_double2(u[0], u[1]);
      *reinterpret_cast<double2*>(V + j) = make_double2(v[0], v[1]);
    }
  }

  // The k8 steps that hold rings, for the warp's 32 rows of its class x 32
  // columns (rows past L read stale bytes: their sums are never stored), as
  // adj_wide's: the step's logical degrees tig and tig + 4 are its rings 2
  // tig and 2 tig + 1, read with U's (V's) in one 16-byte load.
  __device__ __forceinline__ void mma(int s) {
    if (wr0 >= (nv + 1 - cls) / 2 || wc0 >= cv) return;  // uniform: the warp
    const int gid = lane >> 2, tig = lane & 3;
    const unsigned char* ts = sm + (s % (DEPTH + 1)) * T_SLOT +
                              (cls * BM + wr0 + gid) * TW + 16 * tig;
    const double* U = reinterpret_cast<const double*>(sm + U_OFF) +
                      (cls * TC + wc0 + gid) * US + 2 * tig;
    const int steps = (min(KC, nt - s * KC) + 7) / 8;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      if (kk >= steps) break;  // uniform across the warp
      double a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const double2 r0 = *reinterpret_cast<const double2*>(
            ts + 16 * mt * TW + 64 * kk);
        const double2 r8 = *reinterpret_cast<const double2*>(
            ts + (16 * mt + 8) * TW + 64 * kk);
        a[mt][0] = r0.x;
        a[mt][1] = r8.x;
        a[mt][2] = r0.y;
        a[mt][3] = r8.y;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {  // B of the warp's n8 column tile n
        const double2 u =
            *reinterpret_cast<const double2*>(U + n * 8 * US + 8 * kk);
        if (!kProducts) {  // the shared-memory reads stay
          acc[0][n][0] += a[0][0] + a[0][1] + a[0][2] + a[0][3] + a[1][0] +
                          a[1][1] + a[1][2] + a[1][3] + u.x + u.y;
          continue;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) dmma16(acc[mt][n], a[mt], u.x, u.y);
      }
    }
  }

  // out[c * soc + l - l0] for c < cv, l - l0 < nv, both classes through
  // shared memory [c][l - l0] (each column shifted to its run's 16-byte
  // alignment), then whole runs along l, a warp a column, each right after
  // the column's zeros at out[c * soc - zeros ..]
  __device__ __forceinline__ void finish(float* out, long long soc,
                                         int zeros) {
    if (!kStores) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) keep_live(acc[mt], out);
      return;
    }
    float* so = reinterpret_cast<float*>(sm);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int l = 2 * (wr0 + 16 * mt + 8 * (h >> 1) + gid) + cls;
          const int c = wc0 + 8 * n + 2 * tig + (h & 1);
          so[c * SO + eshift(out + c * soc) + l] =
              static_cast<float>(acc[mt][n][h]);
        }
    __syncthreads();
    for (int c = tid >> 5; c < cv; c += THREADS / 32) {
      if (zeros > 0) store_run<float>(out + c * soc - zeros, nullptr, zeros, lane);
      store_run(out + c * soc, so + c * SO, nv, lane);
    }
  }
};

template <int C32, bool KUNIT>
__global__ void __launch_bounds__(AdjParWide<C32, KUNIT>::THREADS,
                                  512 / AdjParWide<C32, KUNIT>::THREADS)
    adj_par_wide(const double* __restrict__ lam, const float* __restrict__ g,
                 float* __restrict__ out, int L, int nr, int C, long long sgm,
                 long long sgr, long long sgc, long long som, long long soc,
                 const int* __restrict__ ms, int M, double f) {
  using K = AdjParWide<C32, KUNIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  int i, m, tile, ct;
  if (!wide_block(blockIdx.x, L, K::P, (C + K::TC - 1) / K::TC, ms, i, m,
                  tile, ct))
    return;  // uniform across the block
  const int nt = (nr + 1) / 2;  // the table's rings
  const int l0 = m + K::P * tile;
  const int c0 = ct * K::TC;
  const int warp = threadIdx.x >> 5, rw = K::P / 32;  // row warps
  K k;
  k.sm = smem;
  k.tab = lam + (static_cast<long long>(i) * L + l0) * nt;  // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                              // g[i, 0, c0]
  k.sgr = sgr;
  k.sgc = sgc;
  k.f = static_cast<float>(f);
  k.nt = nt;
  k.nr = nr;
  k.nv = min(K::P, L - l0);
  k.cv = min(K::TC, C - c0);
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.cls = warp % rw / (rw / 2);
  k.wr0 = warp % (rw / 2) * 32;
  k.wc0 = warp / rw * 32;
  k.init();
  run_ring(k, (nt + K::KC - 1) / K::KC);
  k.finish(out + i * som + c0 * soc + l0, soc, tile == 0 ? m : 0);
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

// the batch's type of a table of type T
template <typename T>
using Bt = typename Narrow<T>::B;

template <typename T, int TC, int MT>
int launch_synth(const SynthNarrowPlan& pl, const void* lam, const void* x,
                 void* out, int L, int nr, int C, long long sxm,
                 long long sxc, const int* ms, int M, cudaStream_t s) {
  const dim3 grid(pl.ntr * ((C + TC - 1) / TC), (M + 1) / 2);
  const cudaError_t e = allow_smem(synth_narrow<T, TC, MT>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  synth_narrow<T, TC, MT><<<grid, 32 * pl.warps, pl.smem, s>>>(
      static_cast<const T*>(lam), static_cast<const Bt<T>*>(x),
      static_cast<Bt<T>*>(out), L, nr, C, sxm, sxc, ms, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TC>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int C, long long sxm, long long sxc, const int* ms, int M,
                 cudaStream_t s) {
  const SynthNarrowPlan pl(nr, TC, sizeof(T), sizeof(Bt<T>));
  if (pl.mt == 1)
    return launch_synth<T, TC, 1>(pl, lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                  s);
  return launch_synth<T, TC, 2>(pl, lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                s);
}

// the float64 table's: ring tiles and column tiles in x, row pairs in y
template <int NT>
int launch_synth_wide(const SynthWidePlan& pl, const void* lam,
                      const void* x, void* out, int L, int nr, int C,
                      long long sxm, long long sxc, const int* ms, int M,
                      cudaStream_t s) {
  const dim3 grid(pl.ntr * pl.nct, (M + 1) / 2);
  const cudaError_t e = allow_smem(synth_wide<NT>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  synth_wide<NT><<<grid, 32 * pl.wr * pl.wn, pl.smem, s>>>(
      static_cast<const double*>(lam), static_cast<const float*>(x),
      static_cast<float*>(out), L, nr, C, sxm, sxc, ms, M);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int C, long long sxm, long long sxc, const int* ms, int M,
                 cudaStream_t s) {
  if constexpr (sizeof(T) == 8) {
    const SynthWidePlan pl(nr, C);
    if (pl.nt == 4)
      return launch_synth_wide<4>(pl, lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                  s);
    return launch_synth_wide<8>(pl, lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                s);
  } else {
    switch (col_tile(C)) {
      case 8:
        return launch_synth<T, 8>(lam, x, out, L, nr, C, sxm, sxc, ms, M, s);
      case 16:
        return launch_synth<T, 16>(lam, x, out, L, nr, C, sxm, sxc, ms, M, s);
      default:
        return launch_synth<T, 32>(lam, x, out, L, nr, C, sxm, sxc, ms, M, s);
    }
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
      static_cast<const T*>(lam), static_cast<const Bt<T>*>(g),
      static_cast<Bt<T>*>(out), L, nr, C, sgm, sgr, sgc, som, soc, ms, M);
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

// the float64 table's: (m, row tile) pairs m-major, each pair's column
// tiles next to each other, all in x
template <int C32, bool KUNIT>
int launch_adj_wide(const void* lam, const void* g, void* out, int L, int nr,
                    int C, long long sgm, long long sgr, long long sgc,
                    long long som, long long soc, const int* ms, int M,
                    cudaStream_t s) {
  using K = AdjWide<C32, KUNIT>;
  const int pairs = ms ? M * ((L + K::BM - 1) / K::BM) : adj_pairs(L, K::BM);
  const int blocks = pairs * ((C + K::TC - 1) / K::TC);
  const cudaError_t e = allow_smem(adj_wide<C32, KUNIT>, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  adj_wide<C32, KUNIT><<<blocks, K::THREADS, K::SMEM, s>>>(
      static_cast<const double*>(lam), static_cast<const float*>(g),
      static_cast<float*>(out), L, nr, C, sgm, sgr, sgc, som, soc, ms, M);
  return static_cast<int>(cudaGetLastError());
}

template <int C32>
int launch_adj_wide(const void* lam, const void* g, void* out, int L, int nr,
                    int C, long long sgm, long long sgr, long long sgc,
                    long long som, long long soc, const int* ms, int M,
                    cudaStream_t s) {
  if (sgr == 1)
    return launch_adj_wide<C32, true>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                     som, soc, ms, M, s);
  if (sgc == 1)
    return launch_adj_wide<C32, false>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                      som, soc, ms, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_adj(const void* lam, const void* g, void* out, int L, int nr,
               int C, long long sgm, long long sgr, long long sgc,
               long long som, long long soc, const int* ms, int M,
               cudaStream_t s) {
  if constexpr (sizeof(T) == 8) {
    switch (adj_wide_c32(C)) {
      case 1:
        return launch_adj_wide<1>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                                  soc, ms, M, s);
      case 2:
        return launch_adj_wide<2>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                                  soc, ms, M, s);
      default:
        return launch_adj_wide<4>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                                  soc, ms, M, s);
    }
  } else {
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
}

template <typename T, int TC, int MT>
int launch_synth_par(const SynthParNarrowPlan& pl, const void* lam,
                     const void* x, void* out, int L, int nr, int C,
                     long long sxm, long long sxc, const int* ms, int M,
                     cudaStream_t s, double f) {
  const dim3 grid(pl.ntr * ((C + TC - 1) / TC), (M + 1) / 2);
  const cudaError_t e = allow_smem(synth_par_narrow<T, TC, MT>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  synth_par_narrow<T, TC, MT><<<grid, 32 * pl.warps, pl.smem, s>>>(
      static_cast<const T*>(lam), static_cast<const Bt<T>*>(x),
      static_cast<Bt<T>*>(out), L, nr, C, sxm, sxc, ms, M, f);
  return static_cast<int>(cudaGetLastError());
}

// nr is the output's ring count, the table's ceil(nr / 2); two m16 tiles a
// warp only below 32 columns
template <typename T, int TC>
int launch_synth_par(const void* lam, const void* x, void* out, int L,
                     int nr, int C, long long sxm, long long sxc,
                     const int* ms, int M, cudaStream_t s, double f) {
  constexpr int MT2 = TC == 32 ? 1 : 2;
  const SynthParNarrowPlan pl((nr + 1) / 2, TC, sizeof(T), sizeof(Bt<T>));
  if (pl.mt == 1)
    return launch_synth_par<T, TC, 1>(pl, lam, x, out, L, nr, C, sxm, sxc,
                                      ms, M, s, f);
  return launch_synth_par<T, TC, MT2>(pl, lam, x, out, L, nr, C, sxm, sxc, ms,
                                      M, s, f);
}

// the float64 table's: ring tiles and column tiles in x, row pairs in y
template <int NT>
int launch_synth_par_wide(const SynthParWidePlan& pl, const void* lam,
                          const void* x, void* out, int L, int nr, int C,
                          long long sxm, long long sxc, const int* ms, int M,
                          cudaStream_t s, double f) {
  const dim3 grid(pl.ntr * pl.nct, (M + 1) / 2);
  const cudaError_t e = allow_smem(synth_par_wide<NT>, pl.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  synth_par_wide<NT><<<grid, 64 * pl.wr * pl.wn, pl.smem, s>>>(
      static_cast<const double*>(lam), static_cast<const float*>(x),
      static_cast<float*>(out), L, nr, C, sxm, sxc, ms, M, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_synth_par(const void* lam, const void* x, void* out, int L,
                     int nr, int C, long long sxm, long long sxc,
                     const int* ms, int M, cudaStream_t s, double f) {
  if constexpr (sizeof(T) == 8) {
    const SynthParWidePlan pl((nr + 1) / 2, C);
    if (pl.nt == 4)
      return launch_synth_par_wide<4>(pl, lam, x, out, L, nr, C, sxm, sxc, ms,
                                      M, s, f);
    return launch_synth_par_wide<8>(pl, lam, x, out, L, nr, C, sxm, sxc, ms,
                                    M, s, f);
  } else {
    switch (col_tile(C)) {
      case 8:
        return launch_synth_par<T, 8>(lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                      s, f);
      case 16:
        return launch_synth_par<T, 16>(lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                       s, f);
      default:
        return launch_synth_par<T, 32>(lam, x, out, L, nr, C, sxm, sxc, ms, M,
                                       s, f);
    }
  }
}

// nr is g's ring count, the table's ceil(nr / 2)
template <typename T, int TC, bool KUNIT>
int launch_adj_par(const void* lam, const void* g, void* out, int L, int nr,
                   int C, long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* ms, int M,
                   cudaStream_t s, double f) {
  using K = AdjParNarrow<T, TC, KUNIT>;
  constexpr int P = 2 * K::BM;
  const int blocks = ms ? M * ((L + P - 1) / P) : adj_pairs(L, P);
  const dim3 grid(blocks, (C + TC - 1) / TC);
  const cudaError_t e = allow_smem(adj_par_narrow<T, TC, KUNIT>, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  adj_par_narrow<T, TC, KUNIT><<<grid, K::THREADS, K::SMEM, s>>>(
      static_cast<const T*>(lam), static_cast<const Bt<T>*>(g),
      static_cast<Bt<T>*>(out), L, nr, C, sgm, sgr, sgc, som, soc, ms, M, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TC>
int launch_adj_par(const void* lam, const void* g, void* out, int L, int nr,
                   int C, long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* ms, int M,
                   cudaStream_t s, double f) {
  if (sgr == 1)
    return launch_adj_par<T, TC, true>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                       som, soc, ms, M, s, f);
  if (sgc == 1)
    return launch_adj_par<T, TC, false>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                        som, soc, ms, M, s, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the float64 table's: (m, row tile) pairs m-major, each pair's column
// tiles next to each other, all in x
template <int C32, bool KUNIT>
int launch_adj_par_wide(const void* lam, const void* g, void* out, int L,
                        int nr, int C, long long sgm, long long sgr,
                        long long sgc, long long som, long long soc,
                        const int* ms, int M, cudaStream_t s, double f) {
  using K = AdjParWide<C32, KUNIT>;
  const int pairs = ms ? M * ((L + K::P - 1) / K::P) : adj_pairs(L, K::P);
  const int blocks = pairs * ((C + K::TC - 1) / K::TC);
  const cudaError_t e = allow_smem(adj_par_wide<C32, KUNIT>, K::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  adj_par_wide<C32, KUNIT><<<blocks, K::THREADS, K::SMEM, s>>>(
      static_cast<const double*>(lam), static_cast<const float*>(g),
      static_cast<float*>(out), L, nr, C, sgm, sgr, sgc, som, soc, ms, M, f);
  return static_cast<int>(cudaGetLastError());
}

template <int C32>
int launch_adj_par_wide(const void* lam, const void* g, void* out, int L,
                        int nr, int C, long long sgm, long long sgr,
                        long long sgc, long long som, long long soc,
                        const int* ms, int M, cudaStream_t s, double f) {
  if (sgr == 1)
    return launch_adj_par_wide<C32, true>(lam, g, out, L, nr, C, sgm, sgr,
                                          sgc, som, soc, ms, M, s, f);
  if (sgc == 1)
    return launch_adj_par_wide<C32, false>(lam, g, out, L, nr, C, sgm, sgr,
                                           sgc, som, soc, ms, M, s, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_adj_par(const void* lam, const void* g, void* out, int L, int nr,
                   int C, long long sgm, long long sgr, long long sgc,
                   long long som, long long soc, const int* ms, int M,
                   cudaStream_t s, double f) {
  if constexpr (sizeof(T) == 8) {
    switch (adj_wide_c32(C)) {
      case 1:
        return launch_adj_par_wide<1>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                      som, soc, ms, M, s, f);
      case 2:
        return launch_adj_par_wide<2>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                      som, soc, ms, M, s, f);
      default:
        return launch_adj_par_wide<4>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                      som, soc, ms, M, s, f);
    }
  } else {
    switch (col_tile(C)) {
      case 8:
        return launch_adj_par<T, 8>(lam, g, out, L, nr, C, sgm, sgr, sgc, som,
                                    soc, ms, M, s, f);
      case 16:
        return launch_adj_par<T, 16>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                     som, soc, ms, M, s, f);
      default:
        return launch_adj_par<T, 32>(lam, g, out, L, nr, C, sgm, sgr, sgc,
                                     som, soc, ms, M, s, f);
    }
  }
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

// the plan at (nr, C): kind 0 the dense synthesis' threads << 20 | dynamic
// shared memory (bytes), 1 its resident blocks an SM, 2 its ring tiles, 5
// its rings a warp, 12 its columns a block; 3 the dense adjoint's (g with
// unit stride on r) threads << 20 | bytes, 4 its resident blocks an SM, 13
// its columns a block, 14 its rows l a block; 6-9 and 15 the same of the
// parity synthesis, 10-11 and 16-17 of the parity adjoint (nr the output's
// or g's rings); -1 for any other kind
template <int C32>
int adj_wide_plan(int kind) {
  using A = AdjWide<C32, true>;
  using B = AdjParWide<C32, true>;
  switch (kind) {
    case 3:
      return A::THREADS << 20 | A::SMEM;
    case 4:
      return blocks_per_sm(adj_wide<C32, true>, A::THREADS, A::SMEM);
    case 13:
      return A::TC;
    case 14:
      return A::BM;
    case 10:
      return B::THREADS << 20 | B::SMEM;
    case 11:
      return blocks_per_sm(adj_par_wide<C32, true>, B::THREADS, B::SMEM);
    case 16:
      return B::TC;
    case 17:
      return B::P;
    default:
      return -1;
  }
}

// the float64 table's kernels
inline int wide_plan(int kind, int nr, int C) {
  const SynthWidePlan pl(nr, C);
  const SynthParWidePlan pp((nr + 1) / 2, C);
  const int threads = 32 * pl.wr * pl.wn, pthreads = 64 * pp.wr * pp.wn;
  switch (kind) {
    case 0:
      return threads << 20 | pl.smem;
    case 1:
      return pl.nt == 4 ? blocks_per_sm(synth_wide<4>, threads, pl.smem)
                        : blocks_per_sm(synth_wide<8>, threads, pl.smem);
    case 2:
      return pl.ntr;
    case 5:
    case 9:
      return 16;
    case 12:
      return pl.tc;
    case 6:
      return pthreads << 20 | pp.smem;
    case 7:
      return pp.nt == 4
                 ? blocks_per_sm(synth_par_wide<4>, pthreads, pp.smem)
                 : blocks_per_sm(synth_par_wide<8>, pthreads, pp.smem);
    case 8:
      return pp.ntr;
    case 15:
      return pp.tc;
  }
  switch (adj_wide_c32(C)) {
    case 1:
      return adj_wide_plan<1>(kind);
    case 2:
      return adj_wide_plan<2>(kind);
    default:
      return adj_wide_plan<4>(kind);
  }
}

// the narrow tables' kernels
template <typename T, int TC>
int plan(int kind, int nr) {
  const SynthNarrowPlan pl(nr, TC, sizeof(T), sizeof(Bt<T>));
  using A = AdjNarrow<T, TC, true>;
  // the parity pair, nr the output's or g's rings
  const SynthParNarrowPlan pp((nr + 1) / 2, TC, sizeof(T), sizeof(Bt<T>));
  constexpr int MT2 = TC == 32 ? 1 : 2;
  using B = AdjParNarrow<T, TC, true>;
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
    case 5:
      return 16 * pl.mt;
    case 12:
    case 13:
    case 15:
    case 16:
      return TC;
    case 14:
      return kAdjRows;
    case 6:
      return 32 * pp.warps << 20 | pp.smem;
    case 7:
      return pp.mt == 1 ? blocks_per_sm(synth_par_narrow<T, TC, 1>,
                                         32 * pp.warps, pp.smem)
                        : blocks_per_sm(synth_par_narrow<T, TC, MT2>,
                                        32 * pp.warps, pp.smem);
    case 8:
      return pp.ntr;
    case 9:
      return 16 * pp.mt;
    case 10:
      return B::THREADS << 20 | B::SMEM;
    case 11:
      return blocks_per_sm(adj_par_narrow<T, TC, true>, B::THREADS, B::SMEM);
    case 17:
      return 2 * kAdjParRows;
    default:
      return -1;
  }
}

template <typename T>
int plan(int kind, int nr, int C) {
  if constexpr (sizeof(T) == 8) {
    return wide_plan(kind, nr, C);
  } else {
    switch (col_tile(C)) {
      case 8:
        return plan<T, 8>(kind, nr);
      case 16:
        return plan<T, 16>(kind, nr);
      default:
        return plan<T, 32>(kind, nr);
    }
  }
}

}  // namespace

// The entry points, one set per table dtype (suffix bf16f64: bfloat16,
// f32f64: float32, f16f64: float16, each with a float64 batch and output;
// f64f32: float64 with a float32 batch and output), with the arguments of
// legendre_tri_f64.cu's:
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
NARROW_F64_ENTRY_POINTS(f16f64, __half)
NARROW_F64_ENTRY_POINTS(f64f32, double)

// The plan at (nr, C) of the entry points of table code ``table`` (0:
// bf16f64, 1: f32f64, 2: f16f64, 3: f64f32): kind 0 the dense synthesis'
// threads << 20 | dynamic shared memory (bytes), 1 its resident blocks an
// SM on the current card (-1 if refused), 2 its ring tiles, 5 its rings a
// warp, 12 its columns a block; 3 the dense adjoint's (g with unit stride
// on r) threads << 20 | bytes, 4 its resident blocks an SM, 13 its columns
// a block, 14 its rows l a block; 6, 7, 8, 9, 15 the parity synthesis' and
// 10, 11, 16, 17 the parity adjoint's, in the same order (nr the output's
// or g's rings); -1 for any other kind or table.
int legendre_tri_narrow_f64_plan(int kind, int table, int nr, int C) {
  switch (table) {
    case 0: return plan<__nv_bfloat16>(kind, nr, C);
    case 1: return plan<float>(kind, nr, C);
    case 2: return plan<__half>(kind, nr, C);
    case 3: return plan<double>(kind, nr, C);
    default: return -1;
  }
}
}  // extern "C"
