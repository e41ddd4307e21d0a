// Triangular Legendre contractions on bfloat16 tables for Hopper (sm_90a):
// bf16 tensor-core tiles (mma.sync m16n8k16, float32 accumulation) fed by
// rings of shared-memory stages.  Plain C interface, loaded with ctypes.
//
// Replaces, for bfloat16 tables (the JAX package's table_dtype=bfloat16),
// the Pallas TPU kernels of gibbssampler_tpu/sht/pallas_legendre.py:
//   legendre_synth_tri (:52, _synth_kernel, pallas_call :76)
//       out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
//   legendre_adj_tri   (:106, _adj_kernel, pallas_call :121)
//       out[m, c, l] = sum_r lam[m, l, r] g[m, r, c],  0 for l < m
// whose contract is "lam (fp32 or bf16), fp32 accumulation, fp32 output".
// lam is bfloat16; x and g are float32 in memory, as are the outputs.  The
// function is the JAX package's einsum(lam, b.astype(bfloat16),
// preferred_element_type=float32): each batch value is rounded to bfloat16
// once (to nearest, ties to even: cvt.rn.bf16x2.f32), the products of two
// bfloat16 values are exact in float32 and the sums run in float32.
// Layouts, the m-slab form (ms, M) and the ring-parity mode (entry points
// legendre_*_par_bf16) are those of legendre_tri.cu.  In the parity adjoint
// the fold g[r] + f (-1)^(l-m) g[nr-1-r] is formed in float32 and then
// rounded, the JAX package's U = (Gn + Gs).astype(table_dtype).  (The JAX
// package keeps the equator row of a split table in float32; sht.lcore
// stores it apart and hands these kernels a half table whose equator row is
// zero.)
//
// What bounds them.  At the main-path shape (L 513, nr 65, C 256) one call
// does 4.39 GFLOP and must move ~0.186 GB (table half 17.1 MB in bf16,
// batch half 134.7 MB, output 34.1 MB): 0.0555 ms at the data sheet's
// 3.35 TB/s against 0.0044 ms at its 989 TFLOP/s dense bf16 rate.  Bytes,
// and the batch's more than the table's.  At nr 513 and 1023 (set-up, the
// full grid) the table and the output are most of the bytes.
//
// Design.  The table's rows are nr (or nh) bf16 values and nr is odd (65,
// 83, 193, 211, 391, 513, 1023), so a row starts at any 2-byte alignment:
// neither TMA nor a 16-byte copy takes it as it stands, and the device table
// is not padded (every reader of a table, lsel_table and the m-sharded
// slabs, sees the logical (L, L, nr) tensor).
//
// Every kernel keeps every operand tile that the MMAs read in bf16 in
// shared memory and loads its fragments with ldmatrix.x4 (.trans for the
// synthesis table, whose unit stride is on j).  The raw copies go DEPTH
// stages ahead into a landing ring; once a stage has landed, one staging
// pass writes its bf16 tiles, which the MMAs of that stage read (run_ring:
// two barriers a stage).  Float32 rows, and the synthesis table's rows, are
// copied in whole 16-byte chunks (cp.async.cg) from their start rounded
// down, and the staging pass reads each row from its offset in its first
// chunk.  A k16 step loads its fragments, then runs every 16 x 8 MMA of the
// warp tile: rows and columns past the data hold zeros, and the MMAs cost
// less than branches around them (measured).  The sums run in the MMA
// accumulators.
// - Dense synthesis: i = c (128), j = r (the ring tile BN: 80, 96, 128 or
//   144, which the host picks from nr: the fewest tiles, since every ring
//   tile reads the batch again, then the least padding; nr 65 and 83 take
//   one tile), k = l from m (32); 8 warps of 32 x BN / 2; DEPTH 3.  The
//   staging pass rounds the batch to bf16 once, and shifts each table row
//   into place (a funnel shift of two landed words).  Shared memory: landing
//   3 x (x 128 x 36 float32 + table 32 x (BN + 8) bf16), A 128 x 40 and B
//   32 x (BN + 8) bf16: 86.0, 90.0, 98.0 and 102.0 KB, two blocks an SM.
// - Parity synthesis: the dense synthesis' block (PAR) over the half
//   table's nh north rings, at the ring tile 128 or 144 that the host picks
//   from nh (fewest tiles, then the least padding: nh 257 takes 2 x 144, nh
//   512 4 x 128).  The staging pass writes each stage's 32 rows k = l - m by
//   class (even in the slots 0-15, odd in 16-31, the batch's bf16 pairs
//   from rows k and k + 2), so that each k16 step is of one class.  Both
//   classes of a 128 x BN tile are 2 x 72 fp32 sums a thread at 256
//   threads, over the 128 registers of two blocks an SM, so the block has
//   16 warps: two warp sets, one a class (warps 0-7 even, 8-15 odd), each
//   warp 32 columns x BN / 2 rings of one class, as the dense synthesis'
//   warps; one block an SM.  The epilogue parks both classes' tiles [r][c]
//   in shared memory and writes north SE + SO and south f (SE - SO), a warp
//   a row of the tile's columns in 16-byte stores (where the tile holds all
//   C columns, its north rows are one span and its south rows one span
//   backward by whole rows).  132.0 / 148.5 KB (the epilogue's two tiles).
//   Measured and slower (PERF.md): 128 x 64 / 72 tiles of 8 warps, two
//   blocks an SM (the batch staged twice as often), 256 x 64 / 72 and 64 x
//   256 / 288 tiles of 16 warps.
// - Parity adjoint: a block computes both parities of 256 rows l = l0 ..
//   l0 + 255 (128 of even l - m, which read U+ = g_n + f g_s, and 128 of
//   odd, which read U- = g_n - f g_s) for 64 columns, so the north and south
//   tiles of g are staged once for both; k = r over the nh north rings (32
//   a stage); 8 warps of 64 x 32, two of each parity along i; DEPTH 2.  Rows
//   of one parity are 2 nh values apart and share one 4-byte alignment, so
//   the table tile goes by 4-byte cp.async straight into a ring of three
//   bf16 slots (no staging pass, no registers), starting at ring k0 - sh_p;
//   the staging pass forms U+- in float32 from the landed g (rings k0 - 1 ..
//   k0 + 31), rounds each value once and writes U_p over the same rings as
//   the table of parity p, so that the k axes agree.  Shared memory: table 3
//   x 20 KB, landing 2 x 2 x 64 x 36 float32 (33 x 68 with unit stride on
//   c), U+- 2 x 5 KB: 106.0 / 105.1 KB, two blocks an SM.
// - Dense adjoint: the parity adjoint's block without the fold (DENSE): both
//   groups of 128 rows l = l0 + p + 2 i' (a group's rows are 2 nr values
//   apart, one 4-byte alignment) for 64 columns, k = r over all nr rings,
//   U_p = bf16(g_n) staged over each group's rings, 88.0 / 87.5 KB, two
//   blocks an SM.  The output sets the bound (at nr 65 the l < m zeros alone
//   are 42% of the bytes), and an H100 writes the (C, M, L) output near
//   its memset rate only when a warp sweeps a column's row l = 0 .. L in one
//   go: in 128- or 256-float pieces, as separate zero blocks and row tiles
//   write it, the same bytes take 1.5-2.2x as long (PERF.md).  So the first
//   row tile of each row m writes the zeros of l < m itself, each column's
//   right before its run of sums, in 16-byte stores, and there are no zero
//   blocks.  Tried and slower: a long-lived block walking 128-row tiles of
//   one row m (its stores in pieces), and tiles of 2 x 256 rows by 32
//   columns (the table read 8 times at C 256, copies one stage ahead).
// Every launch goes to the caller's stream; each entry point returns the
// CUDA error code so that a refused launch reaches the wrapper.
//
// The float16 mode (LEGENDRE_TABLE_F16 defined: legendre_tri_f16.cu, entry
// points legendre_*_f16): float16 tables with a float32 batch, the JAX
// package's table_dtype=float16 under float32 compute.  The same kernels,
// tiles, ldmatrix reads and plans, on f16 operands: the batch rounded once
// by cvt.rn.f16x2.f32 and the products by mma.sync m16n8k16 .f16.f16 with
// float32 accumulation (a product of two float16 values, 11 x 11
// significand bits, is exact in float32, as one of two bfloat16 values is).

#include <cuda_runtime.h>
#include <cstdint>

#ifdef LEGENDRE_TABLE_F16
#define LEGENDRE_ENTRY(name) name##_f16
#define LEGENDRE_INFO legendre_tri_f16_info
#define LEGENDRE_OPERAND "f16"
#else
#define LEGENDRE_ENTRY(name) name##_bf16
#define LEGENDRE_INFO legendre_tri_bf16_info
#define LEGENDRE_OPERAND "bf16"
#endif

namespace {

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

// two float32 values -> packed bf16x2 (f16x2 in the float16 mode), each
// rounded to nearest even; lo in the low half (the lower k of the fragment
// pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn." LEGENDRE_OPERAND "x2.f32 %0, %1, %2;\n"
      : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// d += a b, bf16 operands (f16 in the float16 mode), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32." LEGENDRE_OPERAND "."
      LEGENDRE_OPERAND ".f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy of the first n (0, 2 or 4) bytes at src; zeros
// for the rest
__device__ __forceinline__ void cp_async4n(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}

// 16-byte asynchronous copy (through L2 only) of the first n (0 to 16)
// bytes at src, zeros for the rest; src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}

// Chunk j of a row whose vb valid bytes start at p (any alignment): the
// row lands in whole 16-byte chunks from p rounded down, so that byte p + d
// sits at dst + (p & 15) + d; the rest of a chunk reads as zeros, and a row
// with no valid byte reads nothing.  The bytes before p that the first
// chunk reads lie in the same allocation (CUDA allocations are aligned to
// far more than 16 bytes) and are never used.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const void* p,
                                           int vb, int j) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int sh = static_cast<int>(a & 15);
  const int n = vb > 0 ? min(max(sh + vb - 16 * j, 0), 16) : 0;
  cp_async16(dst + 16 * j, reinterpret_cast<const void*>(a - sh + (n ? 16 * j : 0)),
             n);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ldmatrix of four (two) 8 x 8 b16 matrices: lanes 8 q .. 8 q + 7 give the
// 16-byte rows of matrix q; .trans delivers each matrix transposed
__device__ __forceinline__ void ldsm4(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm2t(uint32_t (&d)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(d[0]), "=r"(d[1]) : "r"(smem_u32(p)));
}

// The degree order of memory row i: ms[i] on a slab, i on the full table.
template <bool SLAB>
__device__ __forceinline__ int degree(const int* ms, int i) {
  return SLAB ? __ldg(ms + i) : i;
}

// The float offset (0 to 3) of p within its 16 bytes
__device__ __forceinline__ int quad_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// dst[j] = src[quad_shift(dst) + j] for j < n (src 16-byte aligned in
// shared memory), or 0 where src is null, by one warp: 16-byte stores
// along the run, 4-byte ones at its two ends
__device__ __forceinline__ void store_run(float* dst, const float* src, int n,
                                          int lane) {
  const int s = quad_shift(dst);
  float* base = dst - s;  // 16-byte aligned
  for (int q = lane; 4 * q < s + n; q += 32) {
    const float4 v = src ? *reinterpret_cast<const float4*>(src + 4 * q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const int j = 4 * q - s;  // the run's element at base[4 q]
    if (j >= 0 && j + 4 <= n) {
      *reinterpret_cast<float4*>(base + 4 * q) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (j + d >= 0 && j + d < n) base[4 * q + d] = e[d];
    }
  }
}

// dst[j] = sa (a[j] + sb b[j]) for j < n (a and b 16-byte aligned in shared
// memory), by one warp: 16-byte stores along the run, 4-byte ones at its
// two ends; 16-byte shared-memory loads where dst is 16-byte aligned
__device__ __forceinline__ void store_mix(float* dst, const float* a,
                                          const float* b, float sa, float sb,
                                          int n, int lane) {
  const int s = quad_shift(dst);
  float* base = dst - s;  // 16-byte aligned
  for (int q = lane; 4 * q < s + n; q += 32) {
    const int j = 4 * q - s;  // the run's element at base[4 q]
    float e[4];
    if (s == 0 && j + 4 <= n) {
      const float4 u = *reinterpret_cast<const float4*>(a + j);
      const float4 v = *reinterpret_cast<const float4*>(b + j);
      e[0] = sa * (u.x + sb * v.x);
      e[1] = sa * (u.y + sb * v.y);
      e[2] = sa * (u.z + sb * v.z);
      e[3] = sa * (u.w + sb * v.w);
    } else {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int jd = min(max(j + d, 0), n - 1);
        e[d] = sa * (a[jd] + sb * b[jd]);
      }
    }
    if (j >= 0 && j + 4 <= n) {
      *reinterpret_cast<float4*>(base + 4 * q) = make_float4(e[0], e[1], e[2], e[3]);
    } else {
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (j + d >= 0 && j + d < n) base[4 * q + d] = e[d];
    }
  }
}

// ---------------------------------------------------------------------------
// the dense pair and the parity adjoint: bf16 tiles, ldmatrix
// ---------------------------------------------------------------------------

// The ring: stage s's copies (K::issue) go K::DEPTH stages ahead into
// landing slot s % DEPTH; once they have landed, the staging pass
// (K::stage) writes the stage's bf16 tiles and the MMAs (K::mma) read them.
// The first barrier of a stage sees its copies landed and the MMAs of the
// stage before done (the bf16 tiles free), the second the tiles written
// (the slot free again).
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

// The dense synthesis (PAR false): out[i, r0 + j, c0 + ii] for a BM x BN
// tile (ii = c, j = r), k = l - m.  The parity synthesis (PAR): the same
// tile over the half table's north rings, each stage's k rows stored by
// class (even l - m in the slots [0, BK / 2), odd in [BK / 2, BK)), so
// that each k16 step is of one class, and the sums of each class on a warp
// set of its own (warps [0, WARPS / 2) even, the rest odd): 16 warps.
template <int BN_, bool PAR = false>
struct SynthBf16 {
  static constexpr int BM = 128, BN = BN_, BK = 32, DEPTH = 3;
  static constexpr int WM = 32, WN = BN / 2;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int SETS = PAR ? 2 : 1;       // warp sets: one a class
  static constexpr int WARPS_M = BM / WM, WARPS = SETS * WARPS_M * (BN / WN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = THREADS > 256 ? 1 : 2;
  static constexpr int XW = BK + 4;              // floats a landed x row
  static constexpr int XCH = XW / 4;             // ... in 16-byte chunks
  static constexpr int TCH = BN / 8 + 1;         // chunks a landed table row
  static constexpr int X_BYTES = BM * XW * 4;
  static constexpr int SLOT = X_BYTES + BK * TCH * 16;
  static constexpr int SA = BK + 8;              // A [c][l], B [l][r] bf16
  static constexpr int SB = BN + (BN % 16 ? 16 : 8);
  static constexpr int A_OFF = DEPTH * SLOT, B_OFF = A_OFF + BM * SA * 2;
  static constexpr int MAIN = B_OFF + BK * SB * 2;
  static constexpr int SC = BM + 4;              // epilogue [r][c] float32
  static constexpr int EPI = SETS * BN * SC * 4; // a tile for each class
  static constexpr int SMEM = MAIN > EPI ? MAIN : EPI;
  static_assert(WN % 8 == 0 && BN % WN == 0 && (SA / 8) % 2 == 1 &&
                (SB / 8) % 2 == 1,
                "tile shape; rows an odd number of 16 bytes apart keep "
                "ldmatrix free of bank conflicts");
  static_assert(BM * BK / 2 % THREADS == 0 && BK == 32,
                "whole staging passes of the batch; one k16 step a class");

  unsigned char* sm;
  const float* x;            // x[i, c0, m]
  const unsigned char* tab;  // lam[i, m, r0]
  long long sxc, rowb;       // x's c stride; bytes from one table row to the next
  int nr, iv, jv, Kn;        // nr: the table's rings (nh for PAR)
  int xs0, ts0;              // x's address in floats mod 4, tab's in bf16 mod 8
  int tid, lane, wm0, wn0;
  int cls;                   // PAR: the warp's class
  float acc[MT][NT][4];

  // where a landed row starts: x row c (floats), table row m + k (bf16)
  __device__ __forceinline__ int xshift(int c) const {
    return (xs0 + (c & 3) * static_cast<int>(sxc & 3)) & 3;
  }
  __device__ __forceinline__ int tshift(int k) const {
    return (ts0 + (k & 7) * (nr & 7)) & 7;
  }
  // the place of a stage's row k (PAR: by class)
  static __device__ __forceinline__ int slot(int k) {
    return PAR ? (k & 1) * (BK / 2) + (k >> 1) : k;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  }

  // rows c of x[c, k0 ..] and rows m + k0 + k of the table's rings r0 ..
  __device__ __forceinline__ void issue(int s) {
    unsigned char* slot_ = sm + (s % DEPTH) * SLOT;
    const int k0 = s * BK, kv = min(Kn - k0, BK);
    for (int e = tid; e < BM * XCH; e += THREADS) {
      const int c = e / XCH, j = e - c * XCH;
      copy_chunk(slot_ + c * XW * 4, x + c * sxc + k0, c < iv ? 4 * kv : 0, j);
    }
    for (int e = tid; e < BK * TCH; e += THREADS) {
      const int k = e / TCH, j = e - k * TCH;
      copy_chunk(slot_ + X_BYTES + k * TCH * 16, tab + (k0 + k) * rowb,
                 k < kv ? 2 * jv : 0, j);
    }
  }

  // B row slot(k) <- table row k0 + k, shifted into place
  __device__ __forceinline__ void stage_tab(const uint32_t* tl, int k0,
                                            int e) {
    const int k = e / (BN / 2), q = e % (BN / 2);
    const int t = tshift(k0 + k);
    const uint32_t* w = tl + k * TCH * 4 + (t >> 1) + q;
    *reinterpret_cast<uint32_t*>(sm + B_OFF + (slot(k) * SB + 2 * q) * 2) =
        __funnelshift_r(w[0], w[1], (t & 1) << 4);
  }

  // A: the batch, rounded to bf16 here and nowhere else (PAR: the pair of
  // slots 2 q, 2 q + 1 holds rows 4 q' + p and 4 q' + p + 2 of class p =
  // q / (BK / 4), q' = q % (BK / 4)); B: the table
  __device__ __forceinline__ void stage(int s) {
    const unsigned char* slot_ = sm + (s % DEPTH) * SLOT;
    const float* xl = reinterpret_cast<const float*>(slot_);
    const uint32_t* tl = reinterpret_cast<const uint32_t*>(slot_ + X_BYTES);
#pragma unroll
    for (int it = 0; it < BM * BK / 2 / THREADS; ++it) {
      const int e = tid + it * THREADS, c = e / (BK / 2), q = e % (BK / 2);
      const float* v = xl + c * XW + xshift(c);
      const int k = PAR ? 4 * (q % (BK / 4)) + q / (BK / 4) : 2 * q;
      *reinterpret_cast<uint32_t*>(sm + A_OFF + (c * SA + 2 * q) * 2) =
          pack_bf16(v[k], v[k + (PAR ? 2 : 1)]);
    }
    const int k0 = s * BK;
    if constexpr (BK * BN / 2 % THREADS == 0) {
#pragma unroll
      for (int it = 0; it < BK * BN / 2 / THREADS; ++it)
        stage_tab(tl, k0, tid + it * THREADS);
    } else {
      for (int e = tid; e < BK * BN / 2; e += THREADS) stage_tab(tl, k0, e);
    }
  }

  // the k16 steps that hold data (PAR: the warp's class's one), every 16 x
  // 8 tile of each: rows past iv and rings past jv hold zeros, and an MMA
  // of zeros costs less than the branches that would skip it
  __device__ __forceinline__ void mma(int s) {
    const int kv = Kn - s * BK;
    const unsigned char* A = sm + A_OFF;
    const unsigned char* B = sm + B_OFF;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (PAR) {
        if (kk != cls || kv <= cls) continue;  // uniform across the warp
      } else {
        if (kk * 16 >= kv) break;  // uniform across the block
      }
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm4(a[mt], A + ((wm0 + mt * 16 + (lane & 15)) * SA + kk * 16 +
                          (lane >> 4) * 8) * 2);
      // b0 (k 0-7) and b1 (k 8-15) of the n tiles 2 np and 2 np + 1
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t d[4];
        ldsm4t(d, B + ((kk * 16 + (lane & 15)) * SB + wn0 + np * 16 +
                       (lane >> 4) * 8) * 2);
        const uint32_t b0[2] = {d[0], d[1]}, b1[2] = {d[2], d[3]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b0);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b1);
        }
      }
      if constexpr (NT % 2 == 1) {
        uint32_t b[2];
        ldsm2t(b, B + ((kk * 16 + (lane & 15)) * SB + wn0 + (NT - 1) * 8) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b);
      }
    }
  }

  // the sums into shared memory [r][c] (PAR: the class's tile)
  __device__ __forceinline__ float* park() {
    float* f = reinterpret_cast<float*>(sm) + (PAR ? cls * BN * SC : 0);
    const int gid = lane >> 2, tig = lane & 3;
    // c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wm0 + mt * 16 + gid, r = wn0 + nt * 8 + 2 * tig;
        f[r * SC + c] = acc[mt][nt][0];
        f[(r + 1) * SC + c] = acc[mt][nt][1];
        f[r * SC + c + 8] = acc[mt][nt][2];
        f[(r + 1) * SC + c + 8] = acc[mt][nt][3];
      }
    __syncthreads();
    return reinterpret_cast<float*>(sm);
  }

  // out[r * C + c] for r < jv, c < iv, through shared memory [r][c]
  __device__ __forceinline__ void finish(float* out, int C) {
    const float* f = park();
    for (int e = tid; e < BN * BM; e += THREADS) {
      const int r = e / BM, c = e % BM;
      if (c < iv && r < jv)
        out[static_cast<long long>(r) * C + c] = f[r * SC + c];
    }
  }

  // PAR: north row r < jv at out + r C, SE + SO; south row r < jv2 at
  // outs - r C, f (SE - SO): a warp a row, each row's iv columns in one
  // run (the tile's rows are contiguous where iv = C, and the south rows
  // run backward by whole rows)
  __device__ __forceinline__ void finish_par(float* out, float* outs, int C,
                                             int jv2, float f) {
    const float* se = park();
    const float* so = se + BN * SC;
    for (int row = tid >> 5; row < jv + jv2; row += WARPS) {
      const bool south = row >= jv;
      const int r = south ? row - jv : row;
      store_mix(south ? outs - static_cast<long long>(r) * C
                      : out + static_cast<long long>(r) * C,
                se + r * SC, so + r * SC, south ? f : 1.f, south ? -1.f : 1.f,
                iv, lane);
    }
  }
};

// The parity adjoint: rows l = l0 + p + 2 i' (i' < BM) of both parities p for
// 64 columns c0 .., k = r over the north rings.  Rows of one parity are 2 nh
// bf16 values apart and share one 4-byte alignment: the table tile of parity
// p is copied in whole words straight into its bf16 rows, from ring k0 -
// sh_p (sh_p = 1 where row l0 + p starts mid-word), and U_p is staged over
// the same rings, so that the k axes agree.  DENSE: the dense adjoint, the
// same block without the fold: nh = nr rings, U_p = bf16(g_n) for both
// groups p of rows (l - l0 even, odd), no south rings, and the epilogue's
// runs of l in 16-byte stores.
template <bool KUNIT, bool DENSE = false>
struct AdjParBf16 {
  static constexpr int BM = 128;                 // rows of each parity
  static constexpr int BN = 64, BK = 32, THREADS = 256, DEPTH = 2;
  static constexpr int WM = 64, WN = 32, MT = WM / 16, NT = WN / 8;
  static constexpr int SA = BK + 8;              // bf16 rows of A and U
  static constexpr int A_STAGE = 2 * BM * SA * 2;  // A [p BM + i'][ring], 3 slots
  static constexpr int GR = BK + 1;              // landed rings k0 - 1 .. k0 + BK - 1
  static constexpr int GW = KUNIT ? GR + 3 : BN + 4;  // floats a landed g row
  static constexpr int GCH = GW / 4;             // [c][ring] (KUNIT) : [ring][c]
  static constexpr int G_TILE = (KUNIT ? BN : GR) * GW;  // floats
  static constexpr int G_SLOT = (DENSE ? 1 : 2) * G_TILE * 4;  // north, south
  static constexpr int G_OFF = (DEPTH + 1) * A_STAGE;
  static constexpr int U_OFF = G_OFF + DEPTH * G_SLOT;
  static constexpr int U_TILE = BN * SA * 2;     // U_p [c][ring]
  static constexpr int MAIN = U_OFF + 2 * U_TILE;
  static constexpr int SC = 2 * BM + 4;          // epilogue [c][l - l0] float32
  static constexpr int SMEM = MAIN > BN * SC * 4 ? MAIN : BN * SC * 4;
  static_assert((SA / 8) % 2 == 1 && BM % WM == 0 && G_SLOT % 16 == 0 &&
                G_TILE % 4 == 0, "ldmatrix rows; one parity a warp; chunks");

  unsigned char* sm;
  const unsigned char* tab;  // lam[i, l0, 0]
  const float* gp;           // g[i, 0, c0]
  long long rowb, sgr, sgc;  // bytes from one table row to the next; g's strides
  int nh, nr, cv, iv0, iv1;  // iv0 / iv1: rows of even / odd l - m
  int sh0, sh1, gs0;         // the parities' ring shifts; gp's address in floats mod 4
  float f;
  int tid, lane, wm0, wn0;
  float acc[MT][NT][4];

  // where a landed g row starts (floats): from element e of column c
  // (KUNIT), or of ring e (unit stride on c)
  __device__ __forceinline__ int gshift(int c, int e) const {
    return KUNIT ? (gs0 + (c & 3) * static_cast<int>(sgc & 3) + e) & 3
                 : (gs0 + (e & 3) * static_cast<int>(sgr & 3)) & 3;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  }

  // the table rows' words of rings k0 - sh_p ..; north g[r, c] and south
  // g[nr - 1 - r, c] for r = k0 - 1 .. k0 + BK - 1 (KUNIT: each column's
  // memory rings, the south ones in reverse)
  __device__ __forceinline__ void issue(int s) {
    unsigned char* A = sm + (s % (DEPTH + 1)) * A_STAGE;
    const int k0 = s * BK;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int ivp = p ? iv1 : iv0, shp = p ? sh1 : sh0;
#pragma unroll
      for (int it = 0; it < BM * BK / 2 / THREADS; ++it) {
        const int e = tid + it * THREADS, ip = e / (BK / 2), w = e % (BK / 2);
        const int r = k0 - shp + 2 * w;  // the word's first ring
        const int n = (ip >= ivp || r >= nh) ? 0 : (r + 1 >= nh ? 2 : 4);
        cp_async4n(A + ((p * BM + ip) * SA + 2 * w) * 2,
                   n ? tab + (p + 2LL * ip) * rowb + 2 * r : tab, n);
      }
    }
    unsigned char* gn = sm + G_OFF + (s % DEPTH) * G_SLOT;
    unsigned char* gs = gn + G_TILE * 4;
    if constexpr (KUNIT) {
      const int nlo = max(k0 - 1, 0), nv = max(min(nh, k0 + BK) - nlo, 0);
      const int slo = max(nr - k0 - BK, 0), sv = min(nr - k0, nr - 1) + 1 - slo;
      for (int e = tid; e < BN * GCH; e += THREADS) {
          const int c = e / GCH, j = e - c * GCH;
        const float* col = gp + c * sgc;
        copy_chunk(gn + c * GW * 4, col + nlo, c < cv ? 4 * nv : 0, j);
        if constexpr (!DENSE)
          copy_chunk(gs + c * GW * 4, col + slo, c < cv ? 4 * sv : 0, j);
      }
    } else {
      for (int e = tid; e < GR * GCH; e += THREADS) {
          const int t = e / GCH, j = e - t * GCH, r = k0 - 1 + t;
        copy_chunk(gn + t * GW * 4, gp + r * sgr,
                   r >= 0 && r < nh ? 4 * cv : 0, j);
        if constexpr (!DENSE)
          copy_chunk(gs + t * GW * 4, gp + (nr - 1 - r) * sgr,
                     r >= 0 && r < nr / 2 ? 4 * cv : 0, j);
      }
    }
  }

  // U_p[c][j] = bf16(g_n + sg_p g_s) at ring k0 - sh_p + j, sg_p = f for
  // even l - m, -f for odd
  __device__ __forceinline__ void stage(int s) {
    if (s == 0) {
      // ring -1 of a row that starts mid-word belongs to the row before
      const int shp = tid < BM ? sh0 : sh1;
      if (tid < 2 * BM && shp)
        *reinterpret_cast<uint16_t*>(sm + tid * SA * 2) = 0;
    }
    const float* gn =
        reinterpret_cast<const float*>(sm + G_OFF + (s % DEPTH) * G_SLOT);
    const float* gs = gn + G_TILE;
    const int k0 = s * BK;
    const int nlo = max(k0 - 1, 0), slo = max(nr - k0 - BK, 0);
#pragma unroll
    for (int it = 0; it < BN * BK / 2 / THREADS; ++it) {
      const int e = tid + it * THREADS, c = e / (BK / 2), q = e % (BK / 2);
      // rings k0 - 1 + 2 q + d
      float vn[3], vs[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int t = 2 * q + d, r = k0 - 1 + t;
        if constexpr (KUNIT) {
          vn[d] = r >= 0 ? gn[c * GW + gshift(c, nlo) + r - nlo] : 0.f;
          vs[d] = !DENSE && r >= 0 && r < nr / 2
                      ? gs[c * GW + gshift(c, slo) + nr - 1 - r - slo]
                      : 0.f;
        } else {
          vn[d] = gn[t * GW + gshift(0, r) + c];
          vs[d] = DENSE ? 0.f : gs[t * GW + gshift(0, nr - 1 - r) + c];
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float sg = p ? -f : f;
        const bool o = !(p ? sh1 : sh0);  // ring k0 - sh_p + 2 q at d = o
        const float lo = DENSE ? (o ? vn[1] : vn[0])
                               : o ? vn[1] + sg * vs[1] : vn[0] + sg * vs[0];
        const float hi = DENSE ? (o ? vn[2] : vn[1])
                               : o ? vn[2] + sg * vs[2] : vn[1] + sg * vs[1];
        *reinterpret_cast<uint32_t*>(sm + U_OFF + p * U_TILE +
                                     (c * SA + 2 * q) * 2) =
            pack_bf16(lo, hi);
      }
    }
  }

  // the k16 steps that hold data: the U fragments, then each row tile's A
  // fragments and MMAs (rows past iv_p and columns past cv hold zeros, as
  // in the synthesis)
  __device__ __forceinline__ void mma(int s) {
    const bool odd = wm0 >= BM;  // the warp's parity
    const unsigned char* A = sm + (s % (DEPTH + 1)) * A_STAGE;
    const unsigned char* U = sm + U_OFF + (odd ? U_TILE : 0);
    const int r0 = s * BK - (odd ? sh1 : sh0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (r0 + kk * 16 >= nh) break;  // uniform across the warp
      // b0 (k 0-7) and b1 (k 8-15) of the n tiles 2 np and 2 np + 1
      uint32_t b[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t d[4];
        ldsm4(d, U + ((wn0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * SA +
                      kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        b[2 * np][0] = d[0];
        b[2 * np][1] = d[1];
        b[2 * np + 1][0] = d[2];
        b[2 * np + 1][1] = d[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm4(a, A + ((wm0 + mt * 16 + (lane & 15)) * SA + kk * 16 +
                      (lane >> 4) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
  }

  // out[c * soc + l - l0] for c < cv, l - l0 < lv, through shared memory
  // [c][l - l0] (DENSE: each row shifted to its run's 16-byte alignment,
  // then whole runs along l, a warp a column, each right after the column's
  // zeros at out[c * soc - zeros ..])
  __device__ __forceinline__ void finish(float* out, long long soc, int lv,
                                         int zeros = 0) {
    float* f_ = reinterpret_cast<float*>(sm);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = wm0 + mt * 16 + gid;        // rows gid + 8: l + 16
        const int l = row / BM + 2 * (row % BM), c = wn0 + nt * 8 + 2 * tig;
        float* e0 = f_ + c * SC + l;
        float* e1 = f_ + (c + 1) * SC + l;
        if constexpr (DENSE) {
          e0 += quad_shift(out + c * soc);
          e1 += quad_shift(out + (c + 1) * soc);
        }
        e0[0] = acc[mt][nt][0];
        e1[0] = acc[mt][nt][1];
        e0[16] = acc[mt][nt][2];
        e1[16] = acc[mt][nt][3];
      }
    __syncthreads();
    if constexpr (DENSE) {
      for (int c = tid >> 5; c < cv; c += THREADS / 32) {
        if (zeros > 0) store_run(out + c * soc - zeros, nullptr, zeros, lane);
        store_run(out + c * soc, f_ + c * SC, min(2 * BM, lv), lane);
      }
    } else {
      for (int e = tid; e < BN * 2 * BM; e += THREADS) {
        const int c = e / (2 * BM), l = e % (2 * BM);
        if (c < cv && l < lv) out[c * soc + l] = f_[c * SC + l];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// the parity synthesis' ring tiles (legendre_kernels.BF16_PAR_SYNTH_TILES)
constexpr int kParTile0 = 128, kParTile1 = 144;

// grid (r tiles of BN, c tiles, row i): i = 0 (m = 0, the longest) first
template <int BN, bool SLAB>
__global__ void __launch_bounds__(SynthBf16<BN>::THREADS, 2)
synth_tri_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ x,
               float* __restrict__ out, int L, int nr, int C, long long sxm,
               long long sxc, const int* __restrict__ ms) {
  using K = SynthBf16<BN>;
  extern __shared__ __align__(16) unsigned char smem_u8[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int c0 = blockIdx.y * K::BM, r0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  K k;
  k.sm = smem_u8;
  k.x = x + i * sxm + c0 * sxc + m;                                     // x[i, c0, m]
  k.tab = reinterpret_cast<const unsigned char*>(
      lam + (static_cast<long long>(i) * L + m) * nr + r0);             // lam[i, m, r0]
  k.sxc = sxc;
  k.rowb = 2LL * nr;
  k.nr = nr;
  k.iv = min(K::BM, C - c0);
  k.jv = min(BN, nr - r0);
  k.Kn = L - m;
  k.xs0 = static_cast<int>((reinterpret_cast<uintptr_t>(k.x) >> 2) & 3);
  k.ts0 = static_cast<int>((reinterpret_cast<uintptr_t>(k.tab) >> 1) & 7);
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.wm0 = (warp % (K::BM / K::WM)) * K::WM;
  k.wn0 = (warp / (K::BM / K::WM)) * K::WN;
  k.zero();
  run_ring(k, (k.Kn + K::BK - 1) / K::BK);
  k.finish(out + (static_cast<long long>(i) * nr + r0) * C + c0, C);    // out[i, r0, c0]
}

// grid (c tiles, ceil(L / 2 BM), row i): tile y computes the rows l0 = m +
// 2 BM y .. l0 + 2 BM; tile 0 also writes the zeros of l < m, each column's
// right before its run from l0, so that a warp writes the column's row
// l = 0 .. l0 + 2 BM in one sweep; the rest return at once.
template <bool KUNIT, bool SLAB>
__global__ void __launch_bounds__(AdjParBf16<KUNIT, true>::THREADS, 2)
adj_tri_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ g,
             float* __restrict__ out, int L, int nr, int C, long long sgm,
             long long sgr, long long sgc, long long som, long long soc,
             const int* __restrict__ ms) {
  using K = AdjParBf16<KUNIT, true>;
  constexpr int RT = 2 * K::BM;  // rows l a block
  extern __shared__ __align__(16) unsigned char smem_u8[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int c0 = blockIdx.x * K::BN;
  const int l0 = m + static_cast<int>(blockIdx.y) * RT;
  if (l0 >= L) return;  // uniform across the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* o = out + i * som + c0 * soc;                                  // out[i, c0, 0]
  K k;
  k.sm = smem_u8;
  k.tab = reinterpret_cast<const unsigned char*>(
      lam + (static_cast<long long>(i) * L + l0) * nr);                 // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                                        // g[i, 0, c0]
  k.rowb = 2LL * nr;
  k.sgr = sgr;
  k.sgc = sgc;
  k.nh = nr;
  k.nr = nr;
  k.cv = min(K::BN, C - c0);
  k.iv0 = min(K::BM, (L - l0 + 1) / 2);  // rows l0 + 2 i' < L
  k.iv1 = min(K::BM, (L - l0) / 2);      // rows l0 + 1 + 2 i' < L
  k.sh0 = static_cast<int>((reinterpret_cast<uintptr_t>(k.tab) >> 1) & 1);
  k.sh1 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(k.tab + k.rowb) >> 1) & 1);
  k.gs0 = quad_shift(k.gp);
  k.f = 1.f;
  k.tid = threadIdx.x;
  k.lane = lane;
  k.wm0 = (warp % (RT / K::WM)) * K::WM;
  k.wn0 = (warp / (RT / K::WM)) * K::WN;
  k.zero();
  run_ring(k, (nr + K::BK) / K::BK);  // rings -1 .. nr - 1
  k.finish(o + l0, soc, L - l0, blockIdx.y == 0 ? m : 0);
}

// The ring-parity modes, as in legendre_tri.cu: the table of the nh =
// ceil(nr / 2) north rings serves all nr; with SE / SO the sums over even /
// odd l - m and f = -1 for the opposite reflection parity (flip):
//   synthesis  out[i, r, c] = SE + SO,  out[i, nr-1-r, c] = f (SE - SO);
//   adjoint    out[i, c, l] = sum_{r < nh} lam[i, l, r] (g[i, r, c]
//              + f (-1)^(l-m) g[i, nr-1-r, c]),  0 for l < m.

// grid (north ring tiles of BN, c tiles of BM, row i)
template <int BN, bool SLAB>
__global__ void __launch_bounds__(SynthBf16<BN, true>::THREADS,
                                  SynthBf16<BN, true>::MIN_BLOCKS)
synth_par_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ x,
               float* __restrict__ out, int L, int nr, int C, long long sxm,
               long long sxc, const int* __restrict__ ms, float f) {
  using K = SynthBf16<BN, true>;
  constexpr int SET = K::WARPS / 2;  // warps of a class
  extern __shared__ __align__(16) unsigned char smem_u8[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int nh = (nr + 1) / 2;
  const int c0 = blockIdx.y * K::BM, r0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  K k;
  k.sm = smem_u8;
  k.x = x + i * sxm + c0 * sxc + m;                                     // x[i, c0, m]
  k.tab = reinterpret_cast<const unsigned char*>(
      lam + (static_cast<long long>(i) * L + m) * nh + r0);             // lam[i, m, r0]
  k.sxc = sxc;
  k.rowb = 2LL * nh;
  k.nr = nh;
  k.iv = min(K::BM, C - c0);
  k.jv = min(BN, nh - r0);
  k.Kn = L - m;
  k.xs0 = static_cast<int>((reinterpret_cast<uintptr_t>(k.x) >> 2) & 3);
  k.ts0 = static_cast<int>((reinterpret_cast<uintptr_t>(k.tab) >> 1) & 7);
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.cls = warp / SET;
  k.wm0 = (warp % SET % K::WARPS_M) * K::WM;
  k.wn0 = (warp % SET / K::WARPS_M) * K::WN;
  k.zero();
  run_ring(k, (k.Kn + K::BK - 1) / K::BK);
  // rows r < nr / 2 have a south mirror: the equator row once
  k.finish_par(out + (static_cast<long long>(i) * nr + r0) * C + c0,    // out[i, r0, c0]
               out + (static_cast<long long>(i) * nr + nr - 1 - r0) * C + c0,
               C, max(min(k.jv, nr / 2 - r0), 0), f);
}

// grid (c tiles, ceil(L / 2 BM) + 1, row i).  For row i of degree m the
// first nz = ceil(m / 2 BM) tiles y write the zeros of l < m; tile y >= nz
// computes the rows l0 = m + 2 BM (y - nz) .. l0 + 2 BM of both parities.
template <bool KUNIT, bool SLAB>
__global__ void __launch_bounds__(AdjParBf16<KUNIT>::THREADS, 2)
adj_par_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ g,
             float* __restrict__ out, int L, int nr, int C, long long sgm,
             long long sgr, long long sgc, long long som, long long soc,
             const int* __restrict__ ms, float f) {
  using K = AdjParBf16<KUNIT>;
  constexpr int RT = 2 * K::BM;  // rows l a block
  extern __shared__ __align__(16) unsigned char smem_u8[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int nh = (nr + 1) / 2;
  const int c0 = blockIdx.x * K::BN;
  const int cv = min(K::BN, C - c0);
  const int nz = (m + RT - 1) / RT;
  float* o = out + i * som + c0 * soc;                                  // out[i, c0, 0]
  if (static_cast<int>(blockIdx.y) < nz) {
    const int hi = m - static_cast<int>(blockIdx.y) * RT;
    const int lo = hi > RT ? hi - RT : 0;
    for (int e = threadIdx.x; e < K::BN * RT; e += K::THREADS) {
      const int j = e / RT, l = lo + e % RT;
      if (j < cv && l < hi) o[j * soc + l] = 0.f;
    }
    return;
  }
  const int l0 = m + (static_cast<int>(blockIdx.y) - nz) * RT;
  if (l0 >= L) return;  // uniform across the block
  const int warp = threadIdx.x >> 5;
  K k;
  k.sm = smem_u8;
  k.tab = reinterpret_cast<const unsigned char*>(
      lam + (static_cast<long long>(i) * L + l0) * nh);                 // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                                        // g[i, 0, c0]
  k.rowb = 2LL * nh;
  k.sgr = sgr;
  k.sgc = sgc;
  k.nh = nh;
  k.nr = nr;
  k.cv = cv;
  k.iv0 = min(K::BM, (L - l0 + 1) / 2);  // rows l0 + 2 i' < L
  k.iv1 = min(K::BM, (L - l0) / 2);      // rows l0 + 1 + 2 i' < L
  k.sh0 = static_cast<int>((reinterpret_cast<uintptr_t>(k.tab) >> 1) & 1);
  k.sh1 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(k.tab + k.rowb) >> 1) & 1);
  k.gs0 = static_cast<int>((reinterpret_cast<uintptr_t>(k.gp) >> 2) & 3);
  k.f = f;
  k.tid = threadIdx.x;
  k.lane = threadIdx.x & 31;
  k.wm0 = (warp % (2 * K::BM / K::WM)) * K::WM;
  k.wn0 = (warp / (2 * K::BM / K::WM)) * K::WN;
  k.zero();
  run_ring(k, (nh + K::BK) / K::BK);  // rings -1 .. nh - 1
  k.finish(o + l0, soc, L - l0);
}

template <class T, class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, T::THREADS, T::SMEM, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int C, long long sxm, long long sxc, const void* ms, int M,
                 void* stream) {
  using K = SynthBf16<BN>;
  const dim3 grid((nr + BN - 1) / BN, (C + K::BM - 1) / K::BM, M);
  return launch<K>(ms ? synth_tri_bf16<BN, true> : synth_tri_bf16<BN, false>,
                   grid, stream, static_cast<const uint16_t*>(lam),
                   static_cast<const float*>(x), static_cast<float*>(out), L,
                   nr, C, sxm, sxc, static_cast<const int*>(ms));
}

template <int BN>
int launch_synth_par(const void* lam, const void* x, void* out, int L, int nr,
                     int C, long long sxm, long long sxc, const void* ms,
                     int M, float f, void* stream) {
  using K = SynthBf16<BN, true>;
  const dim3 grid(((nr + 1) / 2 + BN - 1) / BN, (C + K::BM - 1) / K::BM, M);
  return launch<K>(ms ? synth_par_bf16<BN, true> : synth_par_bf16<BN, false>,
                   grid, stream, static_cast<const uint16_t*>(lam),
                   static_cast<const float*>(x), static_cast<float*>(out), L,
                   nr, C, sxm, sxc, static_cast<const int*>(ms), f);
}

// what 0: dynamic shared memory (bytes); 1: resident blocks an SM (-1 if
// the runtime refuses the query)
template <class T, class Kernel>
int info(Kernel kernel, int what) {
  if (what == 0) return T::SMEM;
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T::THREADS,
                                                    T::SMEM) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// lam: bf16 (M, L, nr); x[i, c, l] at x + i * sxm + c * sxc + l, float32;
// ms: null (M = L, row i of degree i) or M int32 degree orders on the device;
// tile: the ring tile, 80, 96, 128 or 144 (legendre_kernels.bf16_synth_tile)
int LEGENDRE_ENTRY(legendre_synth_tri)(
    const void* lam, const void* x, void* out, int L, int nr, int C,
    long long sxm, long long sxc, const void* ms, int M, int tile,
    void* stream) {
  switch (tile) {
    case 80:
      return launch_synth<80>(lam, x, out, L, nr, C, sxm, sxc, ms, M, stream);
    case 96:
      return launch_synth<96>(lam, x, out, L, nr, C, sxm, sxc, ms, M, stream);
    case 128:
      return launch_synth<128>(lam, x, out, L, nr, C, sxm, sxc, ms, M,
                               stream);
    case 144:
      return launch_synth<144>(lam, x, out, L, nr, C, sxm, sxc, ms, M,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// g[i, r, c] at g + i * sgm + r * sgr + c * sgc with sgr == 1 or sgc == 1;
// out[i, c, l] at out + i * som + c * soc + l; ms as above
int LEGENDRE_ENTRY(legendre_adj_tri)(
    const void* lam, const void* g, void* out, int L, int nr, int C,
    long long sgm, long long sgr, long long sgc, long long som, long long soc,
    const void* ms, int M, void* stream) {
  const auto* lam_ = static_cast<const uint16_t*>(lam);
  const auto* g_ = static_cast<const float*>(g);
  auto* out_ = static_cast<float*>(out);
  const auto* ms_ = static_cast<const int*>(ms);
  using K = AdjParBf16<true, true>;
  constexpr int RT = 2 * K::BM;
  const dim3 grid((C + K::BN - 1) / K::BN, (L + RT - 1) / RT, M);
  if (sgr == 1)
    return launch<K>(ms ? adj_tri_bf16<true, true> : adj_tri_bf16<true, false>,
                     grid, stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc,
                     som, soc, ms_);
  if (sgc == 1)
    return launch<AdjParBf16<false, true>>(
        ms ? adj_tri_bf16<false, true> : adj_tri_bf16<false, false>, grid,
        stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ring-parity modes: lam (M, L, nh) over the nh = ceil(nr / 2) north
// rings, x, g and the outputs as above over all nr rings; flip selects the
// opposite reflection parity; tile: the synthesis' ring tile, 128 or 144
// (legendre_kernels.bf16_par_synth_tile)
int LEGENDRE_ENTRY(legendre_synth_par)(
    const void* lam, const void* x, void* out, int L, int nr, int C,
    long long sxm, long long sxc, const void* ms, int M, int flip, int tile,
    void* stream) {
  const float f = flip ? -1.f : 1.f;
  switch (tile) {
    case kParTile0:
      return launch_synth_par<kParTile0>(lam, x, out, L, nr, C, sxm, sxc, ms,
                                         M, f, stream);
    case kParTile1:
      return launch_synth_par<kParTile1>(lam, x, out, L, nr, C, sxm, sxc, ms,
                                         M, f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int LEGENDRE_ENTRY(legendre_adj_par)(
    const void* lam, const void* g, void* out, int L, int nr, int C,
    long long sgm, long long sgr, long long sgc, long long som, long long soc,
    const void* ms, int M, int flip, void* stream) {
  const auto* lam_ = static_cast<const uint16_t*>(lam);
  const auto* g_ = static_cast<const float*>(g);
  auto* out_ = static_cast<float*>(out);
  const auto* ms_ = static_cast<const int*>(ms);
  const float f = flip ? -1.f : 1.f;
  constexpr int RT = 2 * AdjParBf16<true>::BM, BN = AdjParBf16<true>::BN;
  const dim3 grid((C + BN - 1) / BN, (L + RT - 1) / RT + 1, M);
  if (sgr == 1)
    return launch<AdjParBf16<true>>(
        ms ? adj_par_bf16<true, true> : adj_par_bf16<true, false>, grid,
        stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_, f);
  if (sgc == 1)
    return launch<AdjParBf16<false>>(
        ms ? adj_par_bf16<false, true> : adj_par_bf16<false, false>, grid,
        stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// kind: 0-3 the dense synthesis at ring tiles 80, 96, 128, 144; 4 / 5 the
// dense adjoint with unit stride on r / c; 6 / 7 the parity synthesis at
// ring tiles 128 / 144; 8 / 9 the parity adjoint with unit stride on r / c.
// what: 0 dynamic shared memory (bytes), 1 resident blocks an SM.
int LEGENDRE_INFO(int kind, int what) {
  switch (kind) {
    case 0: return info<SynthBf16<80>>(synth_tri_bf16<80, false>, what);
    case 1: return info<SynthBf16<96>>(synth_tri_bf16<96, false>, what);
    case 2: return info<SynthBf16<128>>(synth_tri_bf16<128, false>, what);
    case 3: return info<SynthBf16<144>>(synth_tri_bf16<144, false>, what);
    case 4: return info<AdjParBf16<true, true>>(adj_tri_bf16<true, false>, what);
    case 5: return info<AdjParBf16<false, true>>(adj_tri_bf16<false, false>, what);
    case 6:
      return info<SynthBf16<kParTile0, true>>(synth_par_bf16<kParTile0, false>,
                                              what);
    case 7:
      return info<SynthBf16<kParTile1, true>>(synth_par_bf16<kParTile1, false>,
                                              what);
    case 8: return info<AdjParBf16<true>>(adj_par_bf16<true, false>, what);
    case 9: return info<AdjParBf16<false>>(adj_par_bf16<false, false>, what);
    default: return -1;
  }
}

}  // extern "C"
