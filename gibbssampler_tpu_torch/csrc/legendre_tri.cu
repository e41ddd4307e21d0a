// Triangular Legendre contractions in float32 for Hopper (sm_90a):
// error-compensated TF32 tensor-core tiles (3xTF32) fed by a cp.async ring.
// Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of gibbssampler_tpu/sht/pallas_legendre.py:
//   legendre_synth_tri (:52, _synth_kernel)
//       out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
//   legendre_adj_tri   (:106, _adj_kernel)
//       out[m, c, l] = sum_r lam[m, l, r] g[m, r, c],  0 for l < m
// Layouts: lam (L, L, nr) row-major, zero for l < m; x (L, C, L) with unit
// stride on l and any m and c strides (the state's own (c, m, l) grids pass
// as a permuted view); g (L, nr, C) with unit stride on r or on c;
// synthesis out (L, nr, C) row-major; adjoint out (L, C, L) with unit stride
// on l (the wrapper allocates it as a (C, L, L) buffer, the state's order).
// The float64 entry points live in legendre_tri_f64.cu.
//
// The m-slab form.  Given ms, an int32 device array of M degree orders,
// every "m" above is a memory row i < M of lam (M, L, nr), x (M, C, L) and
// the outputs, and the degree order of row i is ms[i]: the sums run over
// l >= ms[i] and the adjoint's zeros cover l < ms[i].  An m-sharded
// transform launches its slab of each table so (the rows that it holds);
// ms = null is the full table, M = L and ms[i] = i.  The degree only moves
// where a row's triangle starts; the memory row only moves the pointers.
//
// The ring-parity mode (synth_par_3xtf32, adj_par_3xtf32; entry points
// legendre_*_par_f32): a table over the north half of an equator-symmetric
// grid's rings, mirrored into the south half by the kernels; see "the
// ring-parity modes" below.  The synthesis is a block of its own on the
// dense kernels' stages and fragments; the adjoint a ring of its own
// (run_ring) with both parities in one block, operands read by ldmatrix.
//
// What bounds them.  Per m each is a product over the triangle l >= m.  At
// the main-path shape (L 513, nr 65, C 256) one call does 4.39 GFLOP and
// must move ~0.20 GB (batch half 135 MB, table half 34 MB, output 34 MB):
// ~0.06 ms at the data sheet's 3.35 TB/s and ~0.065 ms at its 67 TFLOP/s
// fp32 FMA rate, so a kernel on the FMA pipes can at best tie with the
// bytes.  The first version of these kernels (FMA pipes only, 2 x 4
// register tiles fed by 6 shared loads per 8 FMAs, single-buffered 16-deep
// stages, 32-ring tiles that padded 65 rings to 96) took 0.47 ms there and
// was slower than cuBLAS SGEMM over the dense table (0.42 / 0.34 ms).
//
// Design.
// - Tensor cores in 3xTF32.  Each fp32 operand a is split as it goes from
//   shared memory into a fragment: a_hi = tf32_rna(a), a_lo = tf32_rna(a -
//   a_hi), with the rounding of cvt.rna.tf32.f32.  Each product runs as
//   three mma.sync.m16n8k8 TF32 MMAs, a_hi b_lo + a_lo b_hi + a_hi b_hi;
//   what is dropped (a_lo b_lo and the split's residuals) is ~2^-21 of the
//   product, the order of fp32 rounding.  3 x 4.39 TF32-GFLOP take ~0.05 ms
//   at half the data sheet's 495 TFLOP/s, under the byte time.  The table
//   is split in the kernel and never stored split, so synthesis and adjoint
//   apply the same rounding to the same fp32 table values.
// - Staged accumulation.  Kept in the tensor cores' accumulators over all
//   3 K / 8 MMAs of a 513-deep contraction, the fp32 sum erred by up to
//   4.3e-6 max|ref| (their additions round less well than an fp32 FADD).
//   Each 32-deep stage therefore sums into fresh accumulators, which are
//   added to fp32 sums in registers: 9e-7.
// - One block GEMM for both, C[i, j] = sum_k A[i, k] B[k, j], A with unit
//   stride on k, k in stages of 32:
//     synthesis  i = c (128), j = r (72), k = l from m;   A = x, B = lam;
//     adjoint    i = l (64, from l = m), j = c (128), k = r;  A = lam, B = g.
//   72-ring tiles hold the 65 cut rings with 7 padding columns.  Warps hold
//   32 x 72 (synthesis) or 32 x 32 (adjoint) accumulator tiles; k8 steps and
//   16 x 8 tiles that lie wholly past the valid edge are skipped.
// - A ring of 3 shared-memory stages filled with cp.async: the loads of
//   stages k+1 and k+2 are in flight while stage k multiplies (4 stages
//   measured slower).  The copies are 4 bytes wide: L = 513 and nr = 65
//   are odd, so rows of x, g and lam start at every alignment and neither
//   16-byte copies nor TMA (16-byte strides) can be used; a warp's 32
//   copies still coalesce.  Out-of-range elements are zero-filled by the
//   copy itself (src-size 0).  Row strides of 4 mod 8 (or 8 mod 16 for
//   [k][j] tiles) keep every fragment read free of bank conflicts.  The
//   ring needs 78-81 KB, dynamic shared memory set with
//   cudaFuncSetAttribute: two blocks share an SM.
// - The epilogue goes through shared memory, so the stores run along the
//   output's unit-stride axis (c for synthesis, l for the adjoint).
// - The triangle.  Synthesis starts its k loop at l = m, and blocks are
//   numbered m = 0 first, so the longest go first and the short ones fill
//   the tail.  The adjoint's l tiles start at l = m; its output comes from
//   torch.empty, so the l < m part of each row is written by zero tiles of
//   their own blocks, and every block does about the same work.
// What bounds them now (main-path shape, 3-stage build, NVIDIA H100 80GB
// HBM3 at 700 W): synthesis 0.137 ms, of which the MMAs with their splits
// alone take 0.077 and the copies alone 0.099; adjoint 0.26 ms, where
// leaving out any one of copies, MMAs, stores or zero tiles saves only
// ~0.05 ms: block latency, with two short blocks per SM.  PERF.md has the
// numbers.
// Every launch goes to the caller's stream; each entry point returns the
// CUDA error code so that a refused launch reaches the wrapper.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

// The rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero, on
// the 13 low mantissa bits of a finite value), in two integer operations:
// ptxas expands the cvt into a longer sequence with Inf and NaN checks.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo + O(2^-22 |a|), hi and lo TF32 values
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a b; not volatile, so that ptxas may interleave independent MMAs
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4-byte asynchronous copy; !valid writes a zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy (through L2 only) of the first n (0 to 16)
// bytes at src, zeros for the rest; src and dst 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}

// Chunk j of a row whose vb valid bytes start at p (any 4-byte alignment):
// the row lands in whole 16-byte chunks from p rounded down, so that byte
// p + d sits at dst + (p & 15) + d; the rest of a chunk reads as zeros, and
// a row with no valid byte reads nothing.  The bytes before p that the
// first chunk reads lie in the same allocation (CUDA allocations are
// aligned to far more than 16 bytes) and are never used.
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const void* p,
                                           int vb, int j) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int sh = static_cast<int>(a & 15);
  const int n = vb > 0 ? min(max(sh + vb - 16 * j, 0), 16) : 0;
  cp_async16(dst + 16 * j,
             reinterpret_cast<const void*>(a - sh + (n ? 16 * j : 0)), n);
}

// ldmatrix of four 8 x 8 b16 matrices, here 8 x 4 32-bit words each: lanes
// 8 q .. 8 q + 7 give the 16-byte rows of matrix q, and lane t receives
// word (t / 4, t % 4) of each: a TF32 fragment's register
__device__ __forceinline__ void ldsm4(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(smem_u32(p)));
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

// ---------------------------------------------------------------------------
// the block GEMM
// ---------------------------------------------------------------------------

// Block tile BM x BN over k stages of BK, warp tiles WM x WN.  B_KUNIT: B's
// unit stride is on k (tile stored [j][k]), else on j (stored [k][j]).
template <int BM_, int BN_, int BK_, int WM_, int WN_, bool B_KUNIT_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr bool B_KUNIT = B_KUNIT_;
  static constexpr int STAGES = 3;
  static constexpr int WARPS_M = BM / WM;
  static constexpr int WARPS = WARPS_M * (BN / WN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int SA = BK + 4;                       // A [i][k]
  static constexpr int SB = B_KUNIT ? BK + 4 : BN + (24 - BN % 16) % 16;
  static constexpr int A_TILE = BM * SA;
  static constexpr int B_TILE = (B_KUNIT ? BN : BK) * SB;
  static constexpr int STAGE = A_TILE + B_TILE;
  static constexpr int SC = BM + 4;                       // epilogue [j][i]
  static constexpr int FLOATS =
      STAGES * STAGE > BN * SC ? STAGES * STAGE : BN * SC;
  static constexpr int SMEM = FLOATS * 4;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0 &&
                BK % 8 == 0, "tile shape");
  static_assert(SA % 8 == 4 && SC % 8 == 4, "conflict-free fragment reads");
  static_assert(B_KUNIT ? SB % 8 == 4 : SB % 16 == 8,
                "conflict-free fragment reads");
};

// The place of k in a stage whose k axis is split by parity (the parity
// synthesis): even k in the first half, odd k in the second.
template <int N>
__device__ __forceinline__ int parity_slot(int k) {
  return (k & 1) * (N / 2) + (k >> 1);
}

// Copy a ROWS x U tile, element (row, col) from src + row * rs + col, to
// dst + row * LD + col; zeros where row >= rv or col >= cv.  Warp w copies
// rows w, w + WARPS, ..., its lanes along the unit-stride axis.  A
// zero-fill copy reads nothing, so its source address needs no guard.
// PERM_ROWS / PERM_COLS put row / column k at parity_slot(k) instead.
template <int ROWS, int U, int LD, int WARPS, bool PERM_ROWS = false,
          bool PERM_COLS = false>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long rs, int rv, int cv) {
  static_assert(ROWS % WARPS == 0, "whole rows per warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = src + warp * rs + lane;
  float* d = dst + warp * LD + lane;
#pragma unroll
  for (int s = 0; s < ROWS / WARPS; ++s) {
    const bool row_ok = warp + s * WARPS < rv;
#pragma unroll
    for (int q = 0; q < (U + 31) / 32; ++q) {
      if (U % 32 != 0 && lane + 32 * q >= U) continue;
      if constexpr (PERM_ROWS || PERM_COLS) {
        const int row = warp + s * WARPS, col = lane + 32 * q;
        cp_async4(dst + (PERM_ROWS ? parity_slot<ROWS>(row) : row) * LD +
                      (PERM_COLS ? parity_slot<U>(col) : col),
                  p + 32 * q, row_ok && col < cv);
      } else {
        cp_async4(d + s * WARPS * LD + 32 * q, p + 32 * q,
                  row_ok && lane + 32 * q < cv);
      }
    }
    p += WARPS * rs;
  }
}

// Stage k0 .. k0 + BK of A (iv x Kn, A[i, k] = A[i * sa + k]) and B (Kn x jv,
// B[k, j] = B[j * sb + k] if B_KUNIT else B[k * sb + j]) into shared memory.
// PAR 1 (the parity synthesis) stores k by parity (parity_slot).
template <class T, int PAR = 0>
__device__ __forceinline__ void load_stage(float* sA, float* sB,
                                           const float* A, long long sa,
                                           int iv, const float* B,
                                           long long sb, int jv, int k0,
                                           int Kn) {
  constexpr bool P1 = PAR == 1;
  copy_tile<T::BM, T::BK, T::SA, T::WARPS, false, P1>(sA, A + k0, sa, iv,
                                                      Kn - k0);
  if constexpr (T::B_KUNIT)
    copy_tile<T::BN, T::BK, T::SB, T::WARPS, false, P1>(sB, B + k0, sb, jv,
                                                        Kn - k0);
  else
    copy_tile<T::BK, T::BN, T::SB, T::WARPS, P1>(sB, B + k0 * sb, sb,
                                                 Kn - k0, jv);
}

// acc += the 3xTF32 products of k8 steps KK0 .. KKN - 1 of one stage, whose
// first ksteps of these hold data.  EDGE: skip the 16 x 8 tiles that lie
// wholly past iv or jv.
template <class T, bool EDGE, int KK0 = 0, int KKN = T::BK / 8>
__device__ __forceinline__ void mma_stage(const float* sA, const float* sB,
                                          float (&acc)[T::MT][T::NT][4],
                                          int wm0, int wn0, int gid, int tig,
                                          int ksteps, int iv, int jv) {
#pragma unroll
  for (int kk = KK0; kk < KKN; ++kk) {
    if (kk - KK0 >= ksteps) break;
    uint32_t ah[T::MT][4], al[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      // a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4)
      const float* p = sA + (wm0 + mt * 16 + gid) * T::SA + kk * 8 + tig;
      split_tf32(p[0], ah[mt][0], al[mt][0]);
      split_tf32(p[8 * T::SA], ah[mt][1], al[mt][1]);
      split_tf32(p[4], ah[mt][2], al[mt][2]);
      split_tf32(p[8 * T::SA + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      if (EDGE && wn0 + nt * 8 >= jv) continue;  // uniform across the warp
      // b0 (k = tig, j = gid), b1 (k = tig + 4, j = gid)
      uint32_t bh[2], bl[2];
      const int j = wn0 + nt * 8 + gid;
      if constexpr (T::B_KUNIT) {
        const float* q = sB + j * T::SB + kk * 8 + tig;
        split_tf32(q[0], bh[0], bl[0]);
        split_tf32(q[4], bh[1], bl[1]);
      } else {
        const float* q = sB + (kk * 8 + tig) * T::SB + j;
        split_tf32(q[0], bh[0], bl[0]);
        split_tf32(q[4 * T::SB], bh[1], bl[1]);
      }
      // the small terms first; independent MMAs side by side
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        if (!EDGE || wm0 + mt * 16 < iv) mma_tf32(acc[mt][nt], ah[mt], bl);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        if (!EDGE || wm0 + mt * 16 < iv) mma_tf32(acc[mt][nt], al[mt], bh);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        if (!EDGE || wm0 + mt * 16 < iv) mma_tf32(acc[mt][nt], ah[mt], bh);
    }
  }
}

// The fragments' sums to s[j * SC + i] (an epilogue's staging in shared
// memory, so that the stores run along i)
template <class T>
__device__ __forceinline__ void stash_sums(float* s,
                                           const float (&sum)[T::MT][T::NT][4],
                                           int wm0, int wn0, int gid,
                                           int tig) {
  // c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const int i = wm0 + mt * 16 + gid, j = wn0 + nt * 8 + 2 * tig;
      s[j * T::SC + i] = sum[mt][nt][0];
      s[(j + 1) * T::SC + i] = sum[mt][nt][1];
      s[j * T::SC + i + 8] = sum[mt][nt][2];
      s[(j + 1) * T::SC + i + 8] = sum[mt][nt][3];
    }
}

// out[j * so + i] = sum_{k < Kn} A[i, k] B[k, j] for i < iv, j < jv.  Each
// stage sums into fresh tensor-core accumulators, which are then added to
// the running fp32 sums: the tensor cores' accumulation then spans at most
// 3 BK / 8 MMAs, not 3 Kn / 8.
template <class T>
__device__ __forceinline__ void block_gemm(const float* A, long long sa,
                                           int iv, const float* B,
                                           long long sb, int jv, int Kn,
                                           float* out, long long so,
                                           float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp % T::WARPS_M) * T::WM;
  const int wn0 = (warp / T::WARPS_M) * T::WN;

  float sum[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[mt][nt][q] = 0.f;

  const int KT = (Kn + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < KT) {
      float* st = smem + s * T::STAGE;
      load_stage<T>(st, st + T::A_TILE, A, sa, iv, B, sb, jv, s * T::BK, Kn);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<T::STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                 // ... and everyone's; stage kt - 1 is free
    const int nx = kt + T::STAGES - 1;
    if (nx < KT) {
      float* st = smem + (nx % T::STAGES) * T::STAGE;
      load_stage<T>(st, st + T::A_TILE, A, sa, iv, B, sb, jv, nx * T::BK,
                    Kn);
    }
    cp_async_commit();
    const float* st = smem + (kt % T::STAGES) * T::STAGE;
    const int kv = Kn - kt * T::BK;
    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    if (kv >= T::BK && iv > T::BM - 16 && jv > T::BN - 8)
      // every k8 step and every 16 x 8 tile holds data: no checks
      mma_stage<T, false>(st, st + T::A_TILE, acc, wm0, wn0, gid, tig,
                          T::BK / 8, iv, jv);
    else
      mma_stage<T, true>(st, st + T::A_TILE, acc, wm0, wn0, gid, tig,
                         kv >= T::BK ? T::BK / 8 : (kv + 7) / 8, iv, jv);
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[mt][nt][q] += acc[mt][nt][q];
  }
  cp_async_wait<0>();
  __syncthreads();

  stash_sums<T>(smem, sum, wm0, wn0, gid, tig);
  __syncthreads();
  for (int e = tid; e < T::BN * T::BM; e += T::THREADS) {
    const int j = e / T::BM, i = e % T::BM;
    if (i < iv && j < jv) out[j * so + i] = smem[j * T::SC + i];
  }
}

// ---------------------------------------------------------------------------
// the two kernels
// ---------------------------------------------------------------------------

using SynthTile = Tile<128, 72, 32, 32, 72, false>;
template <bool KUNIT>
using AdjTile = Tile<64, 128, 32, 32, 32, KUNIT>;

// The degree order of memory row i: ms[i] on a slab, i on the full table.
// SLAB is a template parameter, so that the full table's kernels carry no
// test of ms (a run-time one cost them 1-3% at the main-path shapes on an
// H100).
template <bool SLAB>
__device__ __forceinline__ int degree(const int* ms, int i) {
  return SLAB ? __ldg(ms + i) : i;
}

// grid (r tiles, c tiles, row i): i = 0 (m = 0, the longest) first
template <bool SLAB>
__global__ void __launch_bounds__(SynthTile::THREADS, 2)
synth_tri_3xtf32(const float* __restrict__ lam, const float* __restrict__ x,
                 float* __restrict__ out, int L, int nr, int C,
                 long long sxm, long long sxc, const int* __restrict__ ms) {
  using T = SynthTile;
  extern __shared__ float smem[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int c0 = blockIdx.y * T::BM;
  const int r0 = blockIdx.x * T::BN;
  const float* A = x + i * sxm + c0 * sxc + m;                        // x[i, c0, m]
  const float* B = lam + (static_cast<long long>(i) * L + m) * nr + r0;  // lam[i, m, r0]
  float* o = out + (static_cast<long long>(i) * nr + r0) * C + c0;    // out[i, r0, c0]
  block_gemm<T>(A, sxc, min(T::BM, C - c0), B, nr, min(T::BN, nr - r0),
                L - m, o, C, smem);
}

// grid (c tiles, ceil(L / BM) + 1, row i).  For row i of degree m the first
// nz = ceil(m / BM) tiles y write the zeros of l < m, BM at a time down from
// l = m; tile y >= nz computes l0 = m + (y - nz) BM .. l0 + BM; the rest
// return at once.
template <bool KUNIT, bool SLAB>
__global__ void __launch_bounds__(AdjTile<KUNIT>::THREADS, 2)
adj_tri_3xtf32(const float* __restrict__ lam, const float* __restrict__ g,
               float* __restrict__ out, int L, int nr, int C, long long sgm,
               long long sgr, long long sgc, long long som, long long soc,
               const int* __restrict__ ms) {
  using T = AdjTile<KUNIT>;
  extern __shared__ float smem[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int c0 = blockIdx.x * T::BN;
  const int cv = min(T::BN, C - c0);
  const int nz = (m + T::BM - 1) / T::BM;
  float* o = out + i * som + c0 * soc;                                // out[i, c0, 0]
  if (static_cast<int>(blockIdx.y) < nz) {
    const int hi = m - static_cast<int>(blockIdx.y) * T::BM;
    const int lo = hi > T::BM ? hi - T::BM : 0;
    for (int e = threadIdx.x; e < T::BN * T::BM; e += T::THREADS) {
      const int j = e / T::BM, l = lo + e % T::BM;
      if (j < cv && l < hi) o[j * soc + l] = 0.f;
    }
    return;
  }
  const int l0 = m + (static_cast<int>(blockIdx.y) - nz) * T::BM;
  if (l0 >= L) return;  // uniform across the block
  const float* A = lam + (static_cast<long long>(i) * L + l0) * nr;   // lam[i, l0, 0]
  const float* B = g + i * sgm + c0 * sgc;                            // g[i, 0, c0]
  block_gemm<T>(A, nr, min(T::BM, L - l0), B, KUNIT ? sgc : sgr, cv, nr,
                o + l0, soc, smem);
}

// ---------------------------------------------------------------------------
// the ring-parity modes
// ---------------------------------------------------------------------------
//
// On a grid whose rings mirror each other about the equator (ring nr-1-r at
// pi - theta_r), lam_lm(pi - theta) = (-1)^(l+m) lam_lm(theta), so a table
// of the nh = ceil(nr / 2) north rings (the equator last when nr is odd)
// serves all nr.  With the sums over the l of m's parity (SE, l - m even)
// and of the other (SO), and f = -1 for a table of the opposite reflection
// parity (flip: the spin-2 X table), +1 otherwise:
//   synthesis  out[i, r, c] = SE + SO,  out[i, nr-1-r, c] = f (SE - SO)
//              for r < nh, the equator row written once, as SE + SO;
//   adjoint    out[i, c, l] = sum_{r < nh} lam[i, l, r] (g[i, r, c]
//              + f (-1)^(l-m) g[i, nr-1-r, c]),  the equator row once,
//              0 for l < m.
// (f (-1)^(l-m) is sigma_m (-1)^l of the JAX package's split with
// sigma_m = f (-1)^m: in these terms the sign does not depend on m.)
// Each table entry is read once a call, so the table's bytes halve against
// the full table at nr rings, and so do the products.
// - Synthesis (synth_par_3xtf32): a block of 8 warps over one 128-column
//   by BN-ring tile.  Each stage holds 64 degree rows, by parity (the even
//   l - m first: parity_slot), so each k8 step is of one class.  Warps 0-3
//   run the even class's 4 k8 steps of a stage and warps 4-7 the odd
//   class's, over the same 32-column rows (warp w % 4): each warp keeps one
//   sum set, the dense kernel's register tile (32 x BN sums and a stage's
//   fresh accumulators, each 32 degrees of its class deep, as the dense
//   kernel's 32-deep stages), and SE and SO meet once, in the shared-memory
//   epilogue, which writes SE + SO north and f (SE - SO) south along c.
//   The ring tile BN (64, 72, 80 or 88: NT = BN / 8 fragments) is picked
//   on the host from nh, the fewest tiles and then the least padding
//   (legendre_kernels.f32_par_synth_tile): 257 rings take 3 tiles of 88,
//   512 rings 6, so x's 128 x 64 tile is staged 3 or 6 times a column
//   tile, not 7 or 13 as with the 40-ring tiles of two sum sets a thread.
//   Footprint: 3 stages of (128 x 68 + 64 x SB) floats, 172 KB at BN 88
//   (the epilogue's [2][BN][132] floats reuse them), 256 threads of 197-255
//   registers (the slab form at BN 88 spills 20 bytes): one block an SM.
//   Copies stay 4 bytes wide (odd L and nr: any alignment, and the parity
//   permutation).
//   What bounds it (H100, nh 257, C 256; PERF.md, kernel_ab.py
//   --variant): the staging of x, once a ring tile.  Its copies alone take
//   about half the time, and 4 or 5 ring tiles (BN 64-80) are slower than
//   3 of 88; more warps, other stage depths and B split once a block in
//   shared memory were no faster.
// - Adjoint (adj_par_3xtf32, AdjParF32): a block of 8 warps computes both
//   parities of 2 BM = 256 consecutive rows l = l0 .. l0 + 255 (128 of even
//   l - m, which read U+ = g_n + f g_s, and 128 of odd, which read U- = g_n
//   - f g_s) for BN = 64 columns; k = r over the nh north rings, 32 a
//   stage; warps of 64 x 32, two of each parity along l and two along c.
//   Each stage: the table tile of each parity goes by 4-byte cp.async
//   straight into its rows (a parity's rows are 2 nh floats apart), a ring
//   of 3 slots, two stages ahead; g's north and south rings land in whole
//   16-byte chunks; once they have landed, one staging pass forms U+ and U-
//   and writes both already split into their TF32 hi and lo words, so the
//   MMA loop reads every operand by ldmatrix.x4 (a TF32 fragment is 4 words
//   of an 8 x 4 matrix) and splits only the table.  A warp skips its 16-row
//   tiles past the last row, and issues a stage's MMAs as three passes of
//   16 independent ones.  The products and the summation are those of the
//   dense kernels: each stage's 3xTF32 products into fresh accumulators,
//   added to float32 sums.  The epilogue writes whole runs of 256 l a
//   column through shared memory, in 16-byte stores; blocks of their own
//   write the zeros of l < m so.
//   Why 256 x 64 and not 128 x 128, which stages the same bytes (the table
//   once a column tile, g once a row tile): every U value is folded and
//   split once a stage for the block's rows, and every table value split
//   once for each warp along c, so 256 x 64 does half the staging work and
//   half the table splits a product of 128 x 128.  Footprint: table 3 x 2
//   x 128 x 36 floats (108 KB), landing 2 x 2 x 64 x 36 (36 KB), U+- hi
//   and lo 4 x 64 x 36 (36 KB): 180 KB, one block an SM, 64 sums and 64
//   fresh accumulators a thread (~200 registers); the epilogue's 64 x 260
//   floats reuse it.
//   What bounds it (H100, nh 257, C 256; PERF.md, kernel_ab.py --variant):
//   the copies with the staging pass alone take about 0.5 ms and the MMA
//   path alone about as long (the ~100-110 TF32-TFLOP/s of mma.sync that
//   every float32 kernel here reaches); with one block an SM they overlap
//   only in part.  Tried and no faster: one barrier a stage with U+-
//   double-buffered (216 KB), and 2 blocks an SM of 4 warps on 256 x 32.
// The parity synthesis' block: the block GEMM tile 128 x BN over 64-deep
// stages, twice its warps (one set a class)
template <int BN_>
struct SynthParTile : Tile<128, BN_, 64, 32, BN_, false> {
  using Base = Tile<128, BN_, 64, 32, BN_, false>;
  static constexpr int CLASS_WARPS = Base::WARPS;
  static constexpr int WARPS = 2 * CLASS_WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KH = Base::BK / 16;  // a class's k8 steps a stage
  // the stage ring; the epilogue's SE and SO, [2][BN][SC], reuse it
  static constexpr int FLOATS =
      Base::STAGES * Base::STAGE > 2 * BN_ * Base::SC
          ? Base::STAGES * Base::STAGE : 2 * BN_ * Base::SC;
  static constexpr int SMEM = FLOATS * 4;
};

// grid (north ring tiles, c tiles, row i)
template <int BN, bool SLAB>
__global__ void __launch_bounds__(SynthParTile<BN>::THREADS, 1)
synth_par_3xtf32(const float* __restrict__ lam, const float* __restrict__ x,
                 float* __restrict__ out, int L, int nr, int C,
                 long long sxm, long long sxc, const int* __restrict__ ms,
                 float f) {
  using T = SynthParTile<BN>;
  extern __shared__ float smem[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int nh = (nr + 1) / 2;
  const int c0 = blockIdx.y * T::BM;
  const int r0 = blockIdx.x * BN;
  const int iv = min(T::BM, C - c0), jv = min(BN, nh - r0);
  const int Kn = L - m;
  const float* A = x + i * sxm + c0 * sxc + m;                        // x[i, c0, m]
  const float* B = lam + (static_cast<long long>(i) * L + m) * nh + r0;  // lam[i, m, r0]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int p = warp / T::CLASS_WARPS;  // the class: l - m even (0) or odd
  const int wm0 = (warp % T::CLASS_WARPS) * T::WM;

  float sum[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[mt][nt][q] = 0.f;

  const int KT = (Kn + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < KT) {
      float* st = smem + s * T::STAGE;
      load_stage<T, 1>(st, st + T::A_TILE, A, sxc, iv, B, nh, jv, s * T::BK,
                       Kn);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    const int nx = kt + T::STAGES - 1;
    if (nx < KT) {
      float* st = smem + (nx % T::STAGES) * T::STAGE;
      load_stage<T, 1>(st, st + T::A_TILE, A, sxc, iv, B, nh, jv,
                       nx * T::BK, Kn);
    }
    cp_async_commit();
    const float* st = smem + (kt % T::STAGES) * T::STAGE;
    // class p's k slots: A's columns and B's rows BK / 2 p ..
    const float* sA = st + p * (T::BK / 2);
    const float* sB = st + T::A_TILE + p * (T::BK / 2) * T::SB;
    const int kv = Kn - kt * T::BK;  // (kv + 1 - p) / 2 of them are class p
    float acc[T::MT][T::NT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
    if (kv >= T::BK && iv > T::BM - 16 && jv > BN - 8)
      mma_stage<T, false, 0, T::KH>(sA, sB, acc, wm0, 0, gid, tig, T::KH, iv,
                                    jv);
    else
      mma_stage<T, true, 0, T::KH>(
          sA, sB, acc, wm0, 0, gid, tig,
          kv >= T::BK ? T::KH : ((kv + 1 - p) / 2 + 7) / 8, iv, jv);
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[mt][nt][q] += acc[mt][nt][q];
  }
  cp_async_wait<0>();
  __syncthreads();

  // SE at smem [BN][SC], SO after it; north ring r0 + j at o + j C, its
  // mirror nr-1-r0-j at os - j C for j < jv2 (the rings r < nr / 2)
  stash_sums<T>(smem + p * BN * T::SC, sum, wm0, 0, gid, tig);
  __syncthreads();
  float* o = out + (static_cast<long long>(i) * nr + r0) * C + c0;    // out[i, r0, c0]
  float* os = out + (static_cast<long long>(i) * nr + nr - 1 - r0) * C + c0;
  const int jv2 = min(jv, nr / 2 - r0);
  const float* se = smem;
  const float* so = smem + BN * T::SC;
  for (int e = tid; e < BN * T::BM; e += T::THREADS) {
    const int j = e / T::BM, ii = e % T::BM;
    if (ii < iv && j < jv) {
      const float a = se[j * T::SC + ii], b = so[j * T::SC + ii];
      o[j * C + ii] = a + b;
      if (j < jv2) os[-j * C + ii] = f * (a - b);
    }
  }
}

// The ring: stage s's copies (K::issue) go K::DEPTH stages ahead; once
// they have landed, the staging pass (K::stage) writes the stage's operand
// tiles and the MMAs (K::mma) read them.  The first barrier of a stage sees
// its copies landed and the MMAs of the stage before done (the staged tiles
// free), the second the tiles written (the landing slot free again).
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

// The parity adjoint's block: rows l = l0 + p + 2 i' (i' < BM) of both
// parities p for the columns c0 .. c0 + BN, k = r over the north rings.
template <bool KUNIT>
struct AdjParF32 {
  static constexpr int BM = 128;                   // rows of each parity
  static constexpr int BN = 64, BK = 32, THREADS = 256, WARPS = 8, DEPTH = 2;
  static constexpr int WM = 64, WN = 32, MT = WM / 16, NT = WN / 8;
  static constexpr int SA = BK + 4;                // words a row of A and U
  static constexpr int A_STAGE = 2 * BM * SA * 4;  // A [p BM + i'][ring], DEPTH + 1 slots
  static constexpr int GW = KUNIT ? BK + 4 : BN + 8;  // floats a landed g row
  static constexpr int GCH = GW / 4;               // [c][ring] (KUNIT) : [ring][c]
  static constexpr int G_TILE = (KUNIT ? BN : BK) * GW;  // floats
  static constexpr int G_SLOT = 2 * G_TILE * 4;    // north, south
  static constexpr int G_OFF = (DEPTH + 1) * A_STAGE;
  static constexpr int U_OFF = G_OFF + DEPTH * G_SLOT;
  static constexpr int U_TILE = BN * SA * 4;       // [c][ring]: U+ hi, lo, U- hi, lo
  static constexpr int MAIN = U_OFF + 4 * U_TILE;
  static constexpr int SC = 2 * BM + 4;            // epilogue [c][l - l0] float32
  static constexpr int SMEM = MAIN > BN * SC * 4 ? MAIN : BN * SC * 4;
  static_assert(SA % 8 == 4 && SC % 4 == 0 && G_SLOT % 16 == 0 &&
                BM % WM == 0 && 2 * BM / WM * (BN / WN) == WARPS,
                "ldmatrix rows an odd number of 16 bytes apart; one parity a "
                "warp; 16-byte chunks and epilogue rows");

  unsigned char* sm;
  const float* tab;      // lam[i, l0, 0]
  const float* gp;       // g[i, 0, c0]
  long long sgr, sgc;    // g's strides
  int nh, nr, cv, iv0, iv1;  // iv0 / iv1: rows of even / odd l - m
  int gs0;               // gp's address in floats mod 4
  float f;
  int tid, lane, wm0, wn0;
  float sum[MT][NT][4];

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
        for (int q = 0; q < 4; ++q) sum[mt][nt][q] = 0.f;
  }

  // the table rows' rings k0 .. k0 + BK (a warp a row, its lanes along the
  // rings); north g[r, c] and south g[nr - 1 - r, c] for r = k0 .. k0 + BK,
  // r < nh and r < nr / 2 (KUNIT: each column's memory rings, the south
  // ones in reverse)
  __device__ __forceinline__ void issue(int s) {
    float* A = reinterpret_cast<float*>(sm + (s % (DEPTH + 1)) * A_STAGE);
    const int k0 = s * BK, r = k0 + lane, warp = tid >> 5;
#pragma unroll
    for (int it = 0; it < 2 * BM / WARPS; ++it) {
      const int w = warp + WARPS * it, p = it >= BM / WARPS, ip = w - p * BM;
      cp_async4(A + w * SA + lane, tab + (p + 2LL * ip) * nh + r,
                ip < (p ? iv1 : iv0) && r < nh);
    }
    unsigned char* gn = sm + G_OFF + (s % DEPTH) * G_SLOT;
    unsigned char* gs = gn + G_TILE * 4;
    const int se = min(k0 + BK, nr / 2);  // south rings k0 .. se - 1 ...
    const int slo = nr - se;              // ... at memory rings slo .. nr - 1 - k0
    if constexpr (KUNIT) {
      const int nv = min(nh, k0 + BK) - k0;
      for (int e = tid; e < BN * GCH; e += THREADS) {
        const int c = e / GCH, j = e - c * GCH;
        const float* col = gp + c * sgc;
        copy_chunk(gn + c * GW * 4, col + k0, c < cv ? 4 * nv : 0, j);
        copy_chunk(gs + c * GW * 4, col + slo,
                   c < cv && se > k0 ? 4 * (se - k0) : 0, j);
      }
    } else {
      for (int e = tid; e < BK * GCH; e += THREADS) {
        const int t = e / GCH, j = e - t * GCH, rt = k0 + t;
        copy_chunk(gn + t * GW * 4, gp + rt * sgr, rt < nh ? 4 * cv : 0, j);
        copy_chunk(gs + t * GW * 4, gp + (nr - 1 - rt) * sgr,
                   rt < nr / 2 ? 4 * cv : 0, j);
      }
    }
  }

  // U+-[c][t] = g_n +- f g_s at ring k0 + t (g_s = 0 from ring nr / 2 on:
  // the equator row once), formed once and split into TF32 hi and lo words
  __device__ __forceinline__ void stage(int s) {
    const float* gn =
        reinterpret_cast<const float*>(sm + G_OFF + (s % DEPTH) * G_SLOT);
    const float* gs = gn + G_TILE;
    uint32_t* U = reinterpret_cast<uint32_t*>(sm + U_OFF);
    const int k0 = s * BK, slo = nr - min(k0 + BK, nr / 2);
#pragma unroll
    for (int it = 0; it < BN * BK / THREADS; ++it) {
      int c, t;
      if constexpr (KUNIT) {  // a warp a column, its lanes along the rings
        const int e = tid + it * THREADS;
        c = e >> 5;
        t = e & 31;
      } else {  // 8 columns x 4 rings a warp
        const int q = (tid >> 5) * (BN * BK / THREADS) + it;
        c = (q % (BN / 8)) * 8 + (lane & 7);
        t = (q / (BN / 8)) * 4 + (lane >> 3);
      }
      const int r = k0 + t;
      float vn, vs = 0.f;
      if constexpr (KUNIT) {
        vn = gn[c * GW + gshift(c, k0) + t];
        if (r < nr / 2) vs = gs[c * GW + gshift(c, slo) + nr - 1 - r - slo];
      } else {
        vn = gn[t * GW + gshift(0, r) + c];
        if (r < nr / 2) vs = gs[t * GW + gshift(0, nr - 1 - r) + c];
      }
      const int e = c * SA + t;
      split_tf32(fmaf(f, vs, vn), U[e], U[U_TILE / 4 + e]);
      split_tf32(fmaf(-f, vs, vn), U[2 * U_TILE / 4 + e], U[3 * U_TILE / 4 + e]);
    }
  }

  // sum += one stage's 3xTF32 products, summed into fresh accumulators:
  // the k8 steps that hold data and the warp's first NM 16-row tiles (all
  // its columns: those past cv hold zeros)
  template <int NM>
  __device__ __forceinline__ void mma_rows(int s, int p) {
    const unsigned char* A = sm + (s % (DEPTH + 1)) * A_STAGE;
    const unsigned char* Uh = sm + U_OFF + 2 * p * U_TILE;
    const unsigned char* Ul = Uh + U_TILE;
    const int k0 = s * BK;
    float acc[NM][NT][4];
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      if (k0 + kk * 8 >= nh) break;  // uniform across the block
      // b0 (k 0-3) and b1 (k 4-7) of the n tiles 2 np and 2 np + 1
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = ((wn0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * SA +
                         kk * 8 + ((lane >> 3) & 1) * 4) * 4;
        uint32_t d[4];
        ldsm4(d, Uh + off);
        bh[2 * np][0] = d[0];
        bh[2 * np][1] = d[1];
        bh[2 * np + 1][0] = d[2];
        bh[2 * np + 1][1] = d[3];
        ldsm4(d, Ul + off);
        bl[2 * np][0] = d[0];
        bl[2 * np][1] = d[1];
        bl[2 * np + 1][0] = d[2];
        bl[2 * np + 1][1] = d[3];
      }
      // a0 (rows 0-7, k 0-3), a1 (rows 8-15), a2 (k 4-7), a3
      uint32_t ah[NM][4], al[NM][4];
#pragma unroll
      for (int mt = 0; mt < NM; ++mt) {
        uint32_t d[4];
        ldsm4(d, A + ((wm0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          SA + kk * 8 + (lane >> 4) * 4) * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_tf32(__uint_as_float(d[q]), ah[mt][q], al[mt][q]);
      }
      // the small terms first; NM x NT independent MMAs between two into
      // one accumulator
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[mt][nt][q] += acc[mt][nt][q];
  }

  // the 16-row tiles of the warp that hold data (uniform across the warp)
  __device__ __forceinline__ void mma(int s) {
    const int p = wm0 >= BM;  // the warp's parity
    const int rows = (p ? iv1 : iv0) - (wm0 - p * BM);
    if (rows > 48) mma_rows<4>(s, p);
    else if (rows > 32) mma_rows<3>(s, p);
    else if (rows > 16) mma_rows<2>(s, p);
    else if (rows > 0) mma_rows<1>(s, p);
  }

  // out[c * soc + l - l0] for c < cv, l - l0 < lv: the sums to shared memory
  // [c][l - l0], each row shifted to its run's 16-byte alignment, then
  // whole runs along l, a warp a column
  __device__ __forceinline__ void finish(float* out, long long soc, int lv) {
    float* e = reinterpret_cast<float*>(sm);
    const int gid = lane >> 2, tig = lane & 3;
    // c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = wm0 + mt * 16 + gid;  // rows gid + 8: l + 16
        const int l = row / BM + 2 * (row % BM), c = wn0 + nt * 8 + 2 * tig;
        float* e0 = e + c * SC + quad_shift(out + c * soc) + l;
        float* e1 = e + (c + 1) * SC + quad_shift(out + (c + 1) * soc) + l;
        e0[0] = sum[mt][nt][0];
        e1[0] = sum[mt][nt][1];
        e0[16] = sum[mt][nt][2];
        e1[16] = sum[mt][nt][3];
      }
    __syncthreads();
    for (int c = tid >> 5; c < cv; c += WARPS)
      store_run(out + c * soc, e + c * SC, min(2 * BM, lv), lane);
  }
};

// grid (c tiles, y, row i).  For row i of degree m the first nz = ceil(m /
// 2 BM) tiles y write the zeros of l < m, 2 BM at a time down from l = m;
// tile y >= nz computes the rows l0 = m + 2 BM (y - nz) .. l0 + 2 BM of both
// parities; the rest return at once.
template <bool KUNIT, bool SLAB>
__global__ void __launch_bounds__(AdjParF32<KUNIT>::THREADS, 1)
adj_par_3xtf32(const float* __restrict__ lam, const float* __restrict__ g,
               float* __restrict__ out, int L, int nr, int C, long long sgm,
               long long sgr, long long sgc, long long som, long long soc,
               const int* __restrict__ ms, float f) {
  using K = AdjParF32<KUNIT>;
  constexpr int RT = 2 * K::BM;  // rows l a block
  extern __shared__ __align__(16) unsigned char smem_u8[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int nh = (nr + 1) / 2;
  const int c0 = blockIdx.x * K::BN;
  const int cv = min(K::BN, C - c0);
  const int nz = (m + RT - 1) / RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* o = out + i * som + c0 * soc;                                // out[i, c0, 0]
  if (static_cast<int>(blockIdx.y) < nz) {
    const int hi = m - static_cast<int>(blockIdx.y) * RT;
    const int lo = hi > RT ? hi - RT : 0;
    for (int c = warp; c < cv; c += K::WARPS)
      store_run(o + c * soc + lo, nullptr, hi - lo, lane);
    return;
  }
  const int l0 = m + (static_cast<int>(blockIdx.y) - nz) * RT;
  if (l0 >= L) return;  // uniform across the block
  K k;
  k.sm = smem_u8;
  k.tab = lam + (static_cast<long long>(i) * L + l0) * nh;            // lam[i, l0, 0]
  k.gp = g + i * sgm + c0 * sgc;                                      // g[i, 0, c0]
  k.sgr = sgr;
  k.sgc = sgc;
  k.nh = nh;
  k.nr = nr;
  k.cv = cv;
  k.iv0 = min(K::BM, (L - l0 + 1) / 2);  // rows l0 + 2 i' < L
  k.iv1 = min(K::BM, (L - l0) / 2);      // rows l0 + 1 + 2 i' < L
  k.gs0 = quad_shift(k.gp);
  k.f = f;
  k.tid = threadIdx.x;
  k.lane = lane;
  k.wm0 = (warp % (RT / K::WM)) * K::WM;
  k.wn0 = (warp / (RT / K::WM)) * K::WN;
  k.zero();
  run_ring(k, (nh + K::BK - 1) / K::BK);
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
int launch_synth_par(const void* lam, const void* x, void* out, int L, int nr,
                     int C, long long sxm, long long sxc, const void* ms,
                     int M, int flip, void* stream) {
  using T = SynthParTile<BN>;
  const int nh = (nr + 1) / 2;
  const dim3 grid((nh + BN - 1) / BN, (C + T::BM - 1) / T::BM, M);
  return launch<T>(ms ? synth_par_3xtf32<BN, true>
                      : synth_par_3xtf32<BN, false>,
                   grid, stream, static_cast<const float*>(lam),
                   static_cast<const float*>(x), static_cast<float*>(out), L,
                   nr, C, sxm, sxc, static_cast<const int*>(ms),
                   flip ? -1.f : 1.f);
}

// what 0: the kernel's dynamic shared memory (bytes); 1: its resident
// blocks an SM on the current card (-1 where the runtime refuses the query)
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

// x[i, c, l] at x + i * sxm + c * sxc + l; ms: null (M = L, row i of degree
// i) or M int32 degree orders on the device
int legendre_synth_tri_f32(const void* lam, const void* x, void* out, int L,
                           int nr, int C, long long sxm, long long sxc,
                           const void* ms, int M, void* stream) {
  using T = SynthTile;
  const dim3 grid((nr + T::BN - 1) / T::BN, (C + T::BM - 1) / T::BM, M);
  return launch<T>(ms ? synth_tri_3xtf32<true> : synth_tri_3xtf32<false>,
                   grid, stream, static_cast<const float*>(lam),
                   static_cast<const float*>(x), static_cast<float*>(out), L,
                   nr, C, sxm, sxc, static_cast<const int*>(ms));
}

// g[i, r, c] at g + i * sgm + r * sgr + c * sgc with sgr == 1 or sgc == 1;
// out[i, c, l] at out + i * som + c * soc + l; ms as above
int legendre_adj_tri_f32(const void* lam, const void* g, void* out, int L,
                         int nr, int C, long long sgm, long long sgr,
                         long long sgc, long long som, long long soc,
                         const void* ms, int M, void* stream) {
  const auto* lam_ = static_cast<const float*>(lam);
  const auto* g_ = static_cast<const float*>(g);
  auto* out_ = static_cast<float*>(out);
  const auto* ms_ = static_cast<const int*>(ms);
  if (sgr == 1) {
    using T = AdjTile<true>;
    const dim3 grid((C + T::BN - 1) / T::BN, (L + T::BM - 1) / T::BM + 1, M);
    return launch<T>(ms ? adj_tri_3xtf32<true, true>
                        : adj_tri_3xtf32<true, false>,
                     grid, stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc,
                     som, soc, ms_);
  }
  if (sgc == 1) {
    using T = AdjTile<false>;
    const dim3 grid((C + T::BN - 1) / T::BN, (L + T::BM - 1) / T::BM + 1, M);
    return launch<T>(ms ? adj_tri_3xtf32<false, true>
                        : adj_tri_3xtf32<false, false>,
                     grid, stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc,
                     som, soc, ms_);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// info(kind, what) of each kernel (kinds: 0 synthesis, 1 / 2 adjoint with
// unit stride on r / on c, 3 / 4 the parity adjoint likewise, 5-8 the
// parity synthesis at ring tile 64, 72, 80, 88)
int legendre_tri_f32_info(int kind, int what) {
  switch (kind) {
    case 0: return info<SynthTile>(synth_tri_3xtf32<false>, what);
    case 1: return info<AdjTile<true>>(adj_tri_3xtf32<true, false>, what);
    case 2: return info<AdjTile<false>>(adj_tri_3xtf32<false, false>, what);
    case 3: return info<AdjParF32<true>>(adj_par_3xtf32<true, false>, what);
    case 4: return info<AdjParF32<false>>(adj_par_3xtf32<false, false>, what);
    case 5: return info<SynthParTile<64>>(synth_par_3xtf32<64, false>, what);
    case 6: return info<SynthParTile<72>>(synth_par_3xtf32<72, false>, what);
    case 7: return info<SynthParTile<80>>(synth_par_3xtf32<80, false>, what);
    case 8: return info<SynthParTile<88>>(synth_par_3xtf32<88, false>, what);
    default: return -1;
  }
}

// The ring-parity modes: lam (M, L, nh) over the nh = ceil(nr / 2) north
// rings, x, g and the outputs as above over all nr rings; flip selects the
// opposite reflection parity; the synthesis' ring tile is one of
// 64, 72, 80, 88 (legendre_kernels.f32_par_synth_tile(nh)).
int legendre_synth_par_f32(const void* lam, const void* x, void* out, int L,
                           int nr, int C, long long sxm, long long sxc,
                           const void* ms, int M, int flip, int tile,
                           void* stream) {
  switch (tile) {
    case 64: return launch_synth_par<64>(lam, x, out, L, nr, C, sxm, sxc, ms, M, flip, stream);
    case 72: return launch_synth_par<72>(lam, x, out, L, nr, C, sxm, sxc, ms, M, flip, stream);
    case 80: return launch_synth_par<80>(lam, x, out, L, nr, C, sxm, sxc, ms, M, flip, stream);
    case 88: return launch_synth_par<88>(lam, x, out, L, nr, C, sxm, sxc, ms, M, flip, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int legendre_adj_par_f32(const void* lam, const void* g, void* out, int L,
                         int nr, int C, long long sgm, long long sgr,
                         long long sgc, long long som, long long soc,
                         const void* ms, int M, int flip, void* stream) {
  const auto* lam_ = static_cast<const float*>(lam);
  const auto* g_ = static_cast<const float*>(g);
  auto* out_ = static_cast<float*>(out);
  const auto* ms_ = static_cast<const int*>(ms);
  const float f = flip ? -1.f : 1.f;
  constexpr int RT = 2 * AdjParF32<true>::BM, BN = AdjParF32<true>::BN;
  // zero tiles, then row tiles of both parities
  const dim3 grid((C + BN - 1) / BN, (L + RT - 1) / RT + 1, M);
  if (sgr == 1)
    return launch<AdjParF32<true>>(
        ms ? adj_par_3xtf32<true, true> : adj_par_3xtf32<true, false>, grid,
        stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_, f);
  if (sgc == 1)
    return launch<AdjParF32<false>>(
        ms ? adj_par_3xtf32<false, true> : adj_par_3xtf32<false, false>,
        grid, stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_,
        f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
