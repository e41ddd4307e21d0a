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
  static constexpr int STAGE = A_TILE + (B_KUNIT ? BN : BK) * SB;
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

// Copy a ROWS x U tile, element (row, col) from src + row * rs + col, to
// dst + row * LD + col; zeros where row >= rv or col >= cv.  Warp w copies
// rows w, w + WARPS, ..., its lanes along the unit-stride axis.  A zero-fill
// copy reads nothing, so its source address needs no guard.
template <int ROWS, int U, int LD, int WARPS>
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
      cp_async4(d + s * WARPS * LD + 32 * q, p + 32 * q,
                row_ok && lane + 32 * q < cv);
    }
    p += WARPS * rs;
  }
}

// Stage k0 .. k0 + BK of A (iv x Kn, A[i, k] = A[i * sa + k]) and B (Kn x jv,
// B[k, j] = B[j * sb + k] if B_KUNIT else B[k * sb + j]) into shared memory.
template <class T>
__device__ __forceinline__ void load_stage(float* sA, float* sB,
                                           const float* A, long long sa,
                                           int iv, const float* B,
                                           long long sb, int jv, int k0,
                                           int Kn) {
  copy_tile<T::BM, T::BK, T::SA, T::WARPS>(sA, A + k0, sa, iv, Kn - k0);
  if constexpr (T::B_KUNIT)
    copy_tile<T::BN, T::BK, T::SB, T::WARPS>(sB, B + k0, sb, jv, Kn - k0);
  else
    copy_tile<T::BK, T::BN, T::SB, T::WARPS>(sB, B + k0 * sb, sb, Kn - k0,
                                             jv);
}

// acc += the 3xTF32 products of one stage, whose first ksteps k8 steps
// hold data.  EDGE: skip the 16 x 8 tiles that lie wholly past iv or jv.
template <class T, bool EDGE>
__device__ __forceinline__ void mma_stage(const float* sA, const float* sB,
                                          float (&acc)[T::MT][T::NT][4],
                                          int wm0, int wn0, int gid, int tig,
                                          int ksteps, int iv, int jv) {
#pragma unroll
  for (int kk = 0; kk < T::BK / 8; ++kk) {
    if (kk >= ksteps) break;
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

// out[j * so + i] = sum_{k < Kn} A[i, k] B[k, j] for i < iv, j < jv.
// Each stage sums into fresh tensor-core accumulators, which are then added
// to the running fp32 sums: the tensor cores' accumulation then spans at
// most 3 BK / 8 MMAs, not 3 Kn / 8.
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
      load_stage<T>(st, st + T::A_TILE, A, sa, iv, B, sb, jv, nx * T::BK, Kn);
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

  // c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const int i = wm0 + mt * 16 + gid, j = wn0 + nt * 8 + 2 * tig;
      smem[j * T::SC + i] = sum[mt][nt][0];
      smem[(j + 1) * T::SC + i] = sum[mt][nt][1];
      smem[j * T::SC + i + 8] = sum[mt][nt][2];
      smem[(j + 1) * T::SC + i + 8] = sum[mt][nt][3];
    }
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

template <class T, class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, T::THREADS, T::SMEM, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
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

// dynamic shared memory of each kernel, bytes (0 synthesis, 1 adjoint with
// unit stride on r, 2 adjoint with unit stride on c)
int legendre_tri_f32_smem(int kind) {
  return kind == 0 ? SynthTile::SMEM
                   : kind == 1 ? AdjTile<true>::SMEM : AdjTile<false>::SMEM;
}

}  // extern "C"
