// Triangular Legendre contractions on bfloat16 tables for Hopper (sm_90a):
// bf16 tensor-core tiles (mma.sync m16n8k16, float32 accumulation) fed by a
// ring of shared-memory stages.  Plain C interface, loaded with ctypes.
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
// (to nearest, ties to even: cvt.rn.bf16x2.f32) as it goes from shared
// memory into a fragment, so the batch is read once, in float32, and never
// stored rounded; the products of two bfloat16 values are exact in float32
// and the sums run in float32.
// Layouts, the m-slab form (ms, M) and the ring-parity mode (entry points
// legendre_*_par_bf16) are those of legendre_tri.cu, whose block-GEMM
// skeleton this file follows.  In the parity adjoint the fold g[r] + f
// (-1)^(l-m) g[nr-1-r] is formed in float32 and then rounded, the JAX
// package's U = (Gn + Gs).astype(table_dtype).  (The JAX package keeps the
// equator row of a split table in float32; sht.lcore stores it apart and
// hands these kernels a half table whose equator row is zero.)
//
// What bounds them.  At the main-path shape (L 513, nr 65, C 256) one call
// does 4.39 GFLOP and must move ~0.186 GB (table half 17.1 MB in bf16,
// batch half 134.7 MB, output 34.1 MB): 0.0555 ms at the data sheet's
// 3.35 TB/s against 0.0044 ms at its 989 TFLOP/s dense bf16 rate.  Bytes,
// and the batch's more than the table's: halving the table saves 8% of the
// float32 kernels' bytes at this shape.  At nr 513 and 1023 (set-up, the
// full grid) the table is most of the bytes.
//
// Design (a first version: right and simple; making it fast is later work).
// - One bf16 MMA of k 16 where the float32 kernels run three TF32 MMAs of
//   k 8 (3xTF32).  Fragments are packed from float32 shared memory: pairs
//   along k are adjacent for the [i][k] A tiles and [j][k] B tiles (8-byte
//   reads) and one row apart for [k][j] B tiles.  Row strides of 8 mod 32
//   floats ([*][k]) and 4 or 12 mod 16 ([k][j]) keep the reads free of bank
//   conflicts.
// - The table's rows are nr bf16 values and nr is odd (65, 83, 193, 211,
//   391, 513, 1023), so a row starts at any 2-byte alignment and neither
//   cp.async (4 bytes at least) nor TMA can copy it as it stands.  The table
//   goes through registers instead: a stage's table tile is read from
//   global memory (2 bytes a lane, a warp's 32 lanes along the row) into
//   registers before the MMAs of the stage two ahead of it, and stored to
//   shared memory, as float32, after them, so the loads are in flight while
//   the tensor cores work.  The float32 operand (x or g) keeps the 4-byte
//   cp.async copies of legendre_tri.cu.  The device table is not padded:
//   every reader of a table (lsel_table, the m-sharded slabs) sees the
//   logical (L, L, nr) tensor.
// - Staged accumulation, as legendre_tri.cu: each 32-deep stage sums into
//   fresh accumulators, added to float32 sums in registers.
// - Tiles, grids, the triangle and the parity modes are legendre_tri.cu's:
//   synthesis i = c (128), j = r (72; 40 in the parity mode), k = l from m;
//   adjoint i = l (64 from l = m), j = c (128), k = r; a ring of 3 stages.
// Every launch goes to the caller's stream; each entry point returns the
// CUDA error code so that a refused launch reaches the wrapper.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

// two float32 values -> packed bf16x2, each rounded to nearest even; lo in
// the low half (the lower k of the fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// d += a b, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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
// unit stride is on k (tile stored [j][k]), else on j (stored [k][j]).  B2:
// a stage holds a second B tile (the parity adjoint's south rows).  TAB:
// the operand that is the bf16 table (1: A, the adjoint; 2: B, synthesis);
// the other is float32.
template <int BM_, int BN_, int BK_, int WM_, int WN_, bool B_KUNIT_,
          int TAB_, bool B2_ = false>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr bool B_KUNIT = B_KUNIT_, B2 = B2_;
  static constexpr int TAB = TAB_;
  static constexpr int STAGES = 3;
  static constexpr int WARPS_M = BM / WM;
  static constexpr int WARPS = WARPS_M * (BN / WN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int SA = BK + 8;                       // A [i][k]
  static constexpr int SB = B_KUNIT ? BK + 8 : BN + 4;
  static constexpr int A_TILE = BM * SA;
  static constexpr int B_TILE = (B_KUNIT ? BN : BK) * SB;
  static constexpr int STAGE = A_TILE + (B2 ? 2 : 1) * B_TILE;
  static constexpr int SC = BM + 4;                       // epilogue [j][i]
  static constexpr int FLOATS =
      STAGES * STAGE > BN * SC ? STAGES * STAGE : BN * SC;
  static constexpr int SMEM = FLOATS * 4;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0 &&
                BK % 32 == 0, "tile shape");
  static_assert(SA % 32 == 8 && SC % 8 == 4, "conflict-free fragment reads");
  static_assert(B_KUNIT ? SB % 32 == 8 : (SB % 16 == 4 || SB % 16 == 12),
                "conflict-free fragment reads");
  static_assert(TAB == 1 || TAB == 2, "one operand is the table");
};

// The place of k in a stage whose k axis is split by parity (the parity
// synthesis): even k in the first half, odd k in the second.
template <int N>
__device__ __forceinline__ int parity_slot(int k) {
  return (k & 1) * (N / 2) + (k >> 1);
}

// Copy a ROWS x U float32 tile, element (row, col) from src + row * rs +
// CS * col, to dst + row * LD + col; zeros where row >= rv or col >= cv.
// Warp w copies rows w, w + WARPS, ..., its lanes along the unit-stride
// axis.  PERM_ROWS / PERM_COLS put row / column k at parity_slot(k).
template <int ROWS, int U, int LD, int WARPS, int CS = 1,
          bool PERM_ROWS = false, bool PERM_COLS = false>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long rs, int rv, int cv) {
  static_assert(ROWS % WARPS == 0, "whole rows per warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = src + warp * rs + CS * lane;
#pragma unroll
  for (int s = 0; s < ROWS / WARPS; ++s) {
    const int row = warp + s * WARPS;
#pragma unroll
    for (int q = 0; q < (U + 31) / 32; ++q) {
      const int col = lane + 32 * q;
      if (U % 32 != 0 && col >= U) continue;
      cp_async4(dst + (PERM_ROWS ? parity_slot<ROWS>(row) : row) * LD +
                    (PERM_COLS ? parity_slot<U>(col) : col),
                p + CS * 32 * q, row < rv && col < cv);
    }
    p += WARPS * rs;
  }
}

// A ROWS x U tile of the bf16 table held in registers between its load from
// global memory and its store to shared memory (as float32), element (row,
// col) from src + row * rs + col; zeros where row >= rv or col >= cv.  Warp
// w holds rows w, w + WARPS, ..., its lanes along the row.
template <int ROWS, int U, int WARPS>
struct TabRegs {
  static constexpr int RPW = ROWS / WARPS, QN = (U + 31) / 32;
  static_assert(ROWS % WARPS == 0, "whole rows per warp");
  uint16_t v[RPW][QN];

  __device__ __forceinline__ void load(const uint16_t* src, long long rs,
                                       int rv, int cv) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < RPW; ++s) {
      const int row = warp + s * WARPS;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int col = lane + 32 * q;
        v[s][q] = (row < rv && col < cv && col < U)
                      ? __ldg(src + row * rs + col)
                      : static_cast<uint16_t>(0);
      }
    }
  }

  template <int LD, bool PERM_ROWS = false, bool PERM_COLS = false>
  __device__ __forceinline__ void store(float* dst) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < RPW; ++s) {
      const int row = warp + s * WARPS;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int col = lane + 32 * q;
        if (U % 32 != 0 && col >= U) continue;
        dst[(PERM_ROWS ? parity_slot<ROWS>(row) : row) * LD +
            (PERM_COLS ? parity_slot<U>(col) : col)] =
            __uint_as_float(static_cast<uint32_t>(v[s][q]) << 16);
      }
    }
  }
};

// the table tile of a stage: A (BM x BK) for the adjoint, B (BK x BN,
// [k][j]) for the synthesis
template <class T>
using StageTab = TabRegs<T::TAB == 1 ? T::BM : T::BK,
                         T::TAB == 1 ? T::BK : T::BN, T::WARPS>;

// What the parity modes add to a block GEMM (PAR 1: the parity synthesis,
// PAR 2: the parity adjoint; see block_gemm).
struct ParArgs {
  const float* B2;  // PAR 2: B's south rows, B2[k, j] = g[nr - 1 - k, j]
  int Kn2;          // PAR 2: rows of B2 that exist (k < nr / 2)
  float sgn;        // PAR 1: sign of the south rows; PAR 2: of B2
  float* out2;      // PAR 1: the south rows, row j at out2 - j so
  int jv2;          // PAR 1: south rows that exist (j < jv2)
};

// Stage k0 .. k0 + BK: the float32 operand by cp.async into shared memory,
// the table operand into registers (tr; stored by store_tab).  A: iv x Kn,
// A[i, k] at A[i * sa + k]; B: Kn x jv, B[k, j] at B[j * sb + k] if B_KUNIT
// else B[k * sb + j].  PAR 1 stores k by parity (parity_slot); PAR 2 also
// stages B2 (Kn2 x jv, B2[k, j] = B2[j * sb - k] if B_KUNIT else B2[-k * sb
// + j]) after sB.
template <class T, int PAR>
__device__ __forceinline__ void load_stage(float* sA, float* sB,
                                           const void* A, long long sa,
                                           int iv, const void* B,
                                           long long sb, int jv, int k0,
                                           int Kn, const ParArgs& pa,
                                           StageTab<T>& tr) {
  constexpr bool P1 = PAR == 1;
  if constexpr (T::TAB == 1) {
    tr.load(static_cast<const uint16_t*>(A) + k0, sa, iv, Kn - k0);
  } else {
    copy_tile<T::BM, T::BK, T::SA, T::WARPS, 1, false, P1>(
        sA, static_cast<const float*>(A) + k0, sa, iv, Kn - k0);
  }
  if constexpr (T::TAB == 2) {
    static_assert(!T::B_KUNIT, "the synthesis table is [k][j]");
    tr.load(static_cast<const uint16_t*>(B) + k0 * sb, sb, Kn - k0, jv);
  } else {
    const float* Bf = static_cast<const float*>(B);
    if constexpr (T::B_KUNIT)
      copy_tile<T::BN, T::BK, T::SB, T::WARPS>(sB, Bf + k0, sb, jv, Kn - k0);
    else
      copy_tile<T::BK, T::BN, T::SB, T::WARPS>(sB, Bf + k0 * sb, sb, Kn - k0,
                                               jv);
  }
  if constexpr (PAR == 2) {
    float* sB2 = sB + T::B_TILE;
    if constexpr (T::B_KUNIT)
      copy_tile<T::BN, T::BK, T::SB, T::WARPS, -1>(sB2, pa.B2 - k0, sb, jv,
                                                   pa.Kn2 - k0);
    else
      copy_tile<T::BK, T::BN, T::SB, T::WARPS>(sB2, pa.B2 - k0 * sb, -sb,
                                               pa.Kn2 - k0, jv);
  }
}

// the registers of a stage's table tile into its shared-memory place
template <class T, int PAR>
__device__ __forceinline__ void store_tab(float* st, const StageTab<T>& tr) {
  if constexpr (T::TAB == 1)
    tr.template store<T::SA>(st);
  else
    tr.template store<T::SB, PAR == 1>(st + T::A_TILE);
}

// acc += the products of k16 steps KK0 .. KKN - 1 of one stage, whose first
// ksteps of these hold data.  EDGE: skip the 16 x 8 tiles that lie wholly
// past iv or jv.  B2: B's values are sB + sgn sB2, formed in float32 and
// then rounded.
template <class T, bool EDGE, int KK0 = 0, int KKN = T::BK / 16>
__device__ __forceinline__ void mma_stage(const float* sA, const float* sB,
                                          float (&acc)[T::MT][T::NT][4],
                                          int wm0, int wn0, int gid, int tig,
                                          int ksteps, int iv, int jv,
                                          float sgn = 0.f) {
#pragma unroll
  for (int kk = KK0; kk < KKN; ++kk) {
    if (kk - KK0 >= ksteps) break;
    uint32_t a[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      // a0 (gid, 2 tig..+1), a1 (gid + 8, ..), a2 (gid, 2 tig + 8..+9),
      // a3 (gid + 8, 2 tig + 8..+9)
      const float* p = sA + (wm0 + mt * 16 + gid) * T::SA + kk * 16 + 2 * tig;
      const float2 v0 = *reinterpret_cast<const float2*>(p);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * T::SA);
      const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * T::SA + 8);
      a[mt][0] = pack_bf16(v0.x, v0.y);
      a[mt][1] = pack_bf16(v1.x, v1.y);
      a[mt][2] = pack_bf16(v2.x, v2.y);
      a[mt][3] = pack_bf16(v3.x, v3.y);
    }
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      if (EDGE && wn0 + nt * 8 >= jv) continue;  // uniform across the warp
      // b0 (k = 2 tig..+1, j = gid), b1 (k = 2 tig + 8..+9, j = gid)
      const int j = wn0 + nt * 8 + gid, k = kk * 16 + 2 * tig;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ke = k + (e & 1) + 8 * (e >> 1);
        const int o = T::B_KUNIT ? j * T::SB + ke : ke * T::SB + j;
        if constexpr (T::B2)
          v[e] = fmaf(sgn, sB[T::B_TILE + o], sB[o]);  // U = Gn + sgn Gs
        else
          v[e] = sB[o];
      }
      const uint32_t b[2] = {pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])};
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        if (!EDGE || wm0 + mt * 16 < iv) mma_bf16(acc[mt][nt], a[mt], b);
    }
  }
}

// out[j * so + i] = sum_{k < Kn} A[i, k] B[k, j] for i < iv, j < jv, the
// table operand in bf16, the other in float32 rounded to bf16 in the
// fragments.  Each stage sums into fresh tensor-core accumulators, which
// are then added to the running float32 sums.  The parity modes (pa):
//   PAR 1  the sums over even k (SE) and over odd k (SO) are kept apart (a
//          stage holds its k by parity, so each k16 step is of one parity);
//          out[j so + i] = SE + SO and, for j < jv2, out2[-j so + i] =
//          sgn (SE - SO);
//   PAR 2  B[k, j] + sgn B2[k, j] for B, and out[j so + 2 i]: the rows i
//          are every other row of the output.
template <class T, int PAR = 0>
__device__ __forceinline__ void block_gemm(const void* A, long long sa,
                                           int iv, const void* B,
                                           long long sb, int jv, int Kn,
                                           float* out, long long so,
                                           float* smem,
                                           const ParArgs& pa = {}) {
  static_assert(PAR != 2 || T::B2, "the parity adjoint stages B2");
  constexpr int KH = T::BK / 32;  // PAR 1: the k16 steps of one parity
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp % T::WARPS_M) * T::WM;
  const int wn0 = (warp / T::WARPS_M) * T::WN;

  float sum[T::MT][T::NT][4];
  float sum2[PAR == 1 ? T::MT : 1][PAR == 1 ? T::NT : 1][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[mt][nt][q] = 0.f;
  if constexpr (PAR == 1) {
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum2[mt][nt][q] = 0.f;
  }

  StageTab<T> tr;
  const int KT = (Kn + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < KT) {
      float* st = smem + s * T::STAGE;
      load_stage<T, PAR>(st, st + T::A_TILE, A, sa, iv, B, sb, jv, s * T::BK,
                         Kn, pa, tr);
      store_tab<T, PAR>(st, tr);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<T::STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                 // ... and everyone's; stage kt - 1 is free
    const int nx = kt + T::STAGES - 1;
    float* stn = smem + (nx % T::STAGES) * T::STAGE;
    if (nx < KT)
      load_stage<T, PAR>(stn, stn + T::A_TILE, A, sa, iv, B, sb, jv,
                         nx * T::BK, Kn, pa, tr);
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
    const bool full = kv >= T::BK && iv > T::BM - 16 && jv > T::BN - 8;
    if constexpr (PAR == 1) {
      // the even k: (kv + 1) / 2 of them hold data, the odd k kv / 2
      const int se = kv >= T::BK ? KH : ((kv + 1) / 2 + 15) / 16;
      const int so_ = kv >= T::BK ? KH : (kv / 2 + 15) / 16;
      if (full)
        mma_stage<T, false, 0, KH>(st, st + T::A_TILE, acc, wm0, wn0, gid,
                                   tig, KH, iv, jv);
      else
        mma_stage<T, true, 0, KH>(st, st + T::A_TILE, acc, wm0, wn0, gid,
                                  tig, se, iv, jv);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sum[mt][nt][q] += acc[mt][nt][q];
            acc[mt][nt][q] = 0.f;
          }
      if (full)
        mma_stage<T, false, KH, 2 * KH>(st, st + T::A_TILE, acc, wm0, wn0,
                                        gid, tig, KH, iv, jv);
      else
        mma_stage<T, true, KH, 2 * KH>(st, st + T::A_TILE, acc, wm0, wn0,
                                       gid, tig, so_, iv, jv);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) sum2[mt][nt][q] += acc[mt][nt][q];
    } else {
      if (full)
        // every k16 step and every 16 x 8 tile holds data: no checks
        mma_stage<T, false>(st, st + T::A_TILE, acc, wm0, wn0, gid, tig,
                            T::BK / 16, iv, jv, pa.sgn);
      else
        mma_stage<T, true>(st, st + T::A_TILE, acc, wm0, wn0, gid, tig,
                           kv >= T::BK ? T::BK / 16 : (kv + 15) / 16, iv, jv,
                           pa.sgn);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) sum[mt][nt][q] += acc[mt][nt][q];
    }
    // stage nx's table, loaded before the MMAs above, into its place (last
    // read in stage kt - 1, before this iteration's barrier)
    if (nx < KT) store_tab<T, PAR>(stn, tr);
  }
  cp_async_wait<0>();
  __syncthreads();

  // c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1)
  // PAR 1: pass 0 the north rows SE + SO, pass 1 the south rows
  // sgn (SE - SO); PAR 2: every other output row
  constexpr int IS = PAR == 2 ? 2 : 1;
#pragma unroll
  for (int pass = 0; pass < (PAR == 1 ? 2 : 1); ++pass) {
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int i = wm0 + mt * 16 + gid, j = wn0 + nt * 8 + 2 * tig;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (PAR == 1)
            v[q] = pass ? pa.sgn * (sum[mt][nt][q] - sum2[mt][nt][q])
                        : sum[mt][nt][q] + sum2[mt][nt][q];
          else
            v[q] = sum[mt][nt][q];
        }
        smem[j * T::SC + i] = v[0];
        smem[(j + 1) * T::SC + i] = v[1];
        smem[j * T::SC + i + 8] = v[2];
        smem[(j + 1) * T::SC + i + 8] = v[3];
      }
    __syncthreads();
    float* o = pass ? pa.out2 : out;
    const long long jstep = pass ? -so : so;
    const int jn = pass ? pa.jv2 : jv;
    for (int e = tid; e < T::BN * T::BM; e += T::THREADS) {
      const int j = e / T::BM, i = e % T::BM;
      if (i < iv && j < jn) o[j * jstep + IS * i] = smem[j * T::SC + i];
    }
    if (PAR == 1 && pass == 0) __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

using SynthTile = Tile<128, 72, 32, 32, 72, false, 2>;
template <bool KUNIT>
using AdjTile = Tile<64, 128, 32, 32, 32, KUNIT, 1>;
using SynthParTile = Tile<128, 40, 32, 32, 40, false, 2>;
template <bool KUNIT>
using AdjParTile = Tile<64, 128, 32, 32, 32, KUNIT, 1, true>;

// The degree order of memory row i: ms[i] on a slab, i on the full table.
template <bool SLAB>
__device__ __forceinline__ int degree(const int* ms, int i) {
  return SLAB ? __ldg(ms + i) : i;
}

// grid (r tiles, c tiles, row i): i = 0 (m = 0, the longest) first
template <bool SLAB>
__global__ void __launch_bounds__(SynthTile::THREADS, 2)
synth_tri_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ x,
               float* __restrict__ out, int L, int nr, int C, long long sxm,
               long long sxc, const int* __restrict__ ms) {
  using T = SynthTile;
  extern __shared__ float smem[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int c0 = blockIdx.y * T::BM;
  const int r0 = blockIdx.x * T::BN;
  const float* A = x + i * sxm + c0 * sxc + m;                          // x[i, c0, m]
  const uint16_t* B = lam + (static_cast<long long>(i) * L + m) * nr + r0;  // lam[i, m, r0]
  float* o = out + (static_cast<long long>(i) * nr + r0) * C + c0;      // out[i, r0, c0]
  block_gemm<T>(A, sxc, min(T::BM, C - c0), B, nr, min(T::BN, nr - r0),
                L - m, o, C, smem);
}

// grid (c tiles, ceil(L / BM) + 1, row i).  For row i of degree m the first
// nz = ceil(m / BM) tiles y write the zeros of l < m, BM at a time down from
// l = m; tile y >= nz computes l0 = m + (y - nz) BM .. l0 + BM; the rest
// return at once.
template <bool KUNIT, bool SLAB>
__global__ void __launch_bounds__(AdjTile<KUNIT>::THREADS, 2)
adj_tri_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ g,
             float* __restrict__ out, int L, int nr, int C, long long sgm,
             long long sgr, long long sgc, long long som, long long soc,
             const int* __restrict__ ms) {
  using T = AdjTile<KUNIT>;
  extern __shared__ float smem[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int c0 = blockIdx.x * T::BN;
  const int cv = min(T::BN, C - c0);
  const int nz = (m + T::BM - 1) / T::BM;
  float* o = out + i * som + c0 * soc;                                  // out[i, c0, 0]
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
  const uint16_t* A = lam + (static_cast<long long>(i) * L + l0) * nr;  // lam[i, l0, 0]
  const float* B = g + i * sgm + c0 * sgc;                              // g[i, 0, c0]
  block_gemm<T>(A, nr, min(T::BM, L - l0), B, KUNIT ? sgc : sgr, cv, nr,
                o + l0, soc, smem);
}

// The ring-parity modes, as in legendre_tri.cu: the table of the nh =
// ceil(nr / 2) north rings serves all nr; with SE / SO the sums over even /
// odd l - m and f = -1 for the opposite reflection parity (flip):
//   synthesis  out[i, r, c] = SE + SO,  out[i, nr-1-r, c] = f (SE - SO);
//   adjoint    out[i, c, l] = sum_{r < nh} lam[i, l, r] (g[i, r, c]
//              + f (-1)^(l-m) g[i, nr-1-r, c]),  0 for l < m.

// grid (north ring tiles, c tiles, row i)
template <bool SLAB>
__global__ void __launch_bounds__(SynthParTile::THREADS, 2)
synth_par_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ x,
               float* __restrict__ out, int L, int nr, int C, long long sxm,
               long long sxc, const int* __restrict__ ms, float f) {
  using T = SynthParTile;
  extern __shared__ float smem[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int nh = (nr + 1) / 2;
  const int c0 = blockIdx.y * T::BM;
  const int r0 = blockIdx.x * T::BN;
  const int jv = min(T::BN, nh - r0);
  const float* A = x + i * sxm + c0 * sxc + m;                          // x[i, c0, m]
  const uint16_t* B = lam + (static_cast<long long>(i) * L + m) * nh + r0;  // lam[i, m, r0]
  float* o = out + (static_cast<long long>(i) * nr + r0) * C + c0;      // out[i, r0, c0]
  ParArgs pa{};
  pa.sgn = f;
  pa.out2 = out + (static_cast<long long>(i) * nr + nr - 1 - r0) * C + c0;
  pa.jv2 = min(jv, nr / 2 - r0);  // rows r < nr / 2 have a south mirror
  block_gemm<T, 1>(A, sxc, min(T::BM, C - c0), B, nh, jv, L - m, o, C, smem,
                   pa);
}

// grid (c tiles, y, row i).  For row i of degree m the first nz =
// ceil(m / BM) tiles y write the zeros of l < m; tile y = nz + 2 t + p
// computes the rows l = m + p + 2 (BM t + i') of parity p, i' < BM.
template <bool KUNIT, bool SLAB>
__global__ void __launch_bounds__(AdjParTile<KUNIT>::THREADS, 2)
adj_par_bf16(const uint16_t* __restrict__ lam, const float* __restrict__ g,
             float* __restrict__ out, int L, int nr, int C, long long sgm,
             long long sgr, long long sgc, long long som, long long soc,
             const int* __restrict__ ms, float f) {
  using T = AdjParTile<KUNIT>;
  extern __shared__ float smem[];
  const int i = blockIdx.z, m = degree<SLAB>(ms, i);
  const int nh = (nr + 1) / 2;
  const int c0 = blockIdx.x * T::BN;
  const int cv = min(T::BN, C - c0);
  const int nz = (m + T::BM - 1) / T::BM;
  float* o = out + i * som + c0 * soc;                                  // out[i, c0, 0]
  if (static_cast<int>(blockIdx.y) < nz) {
    const int hi = m - static_cast<int>(blockIdx.y) * T::BM;
    const int lo = hi > T::BM ? hi - T::BM : 0;
    for (int e = threadIdx.x; e < T::BN * T::BM; e += T::THREADS) {
      const int j = e / T::BM, l = lo + e % T::BM;
      if (j < cv && l < hi) o[j * soc + l] = 0.f;
    }
    return;
  }
  const int t = static_cast<int>(blockIdx.y) - nz, p = t & 1;
  const int l0 = m + p + 2 * T::BM * (t >> 1);
  if (l0 >= L) return;  // uniform across the block
  const uint16_t* A = lam + (static_cast<long long>(i) * L + l0) * nh;  // lam[i, l0, 0]
  const float* B = g + i * sgm + c0 * sgc;                              // g[i, 0, c0]
  ParArgs pa{};
  pa.B2 = B + (nr - 1) * sgr;                                           // g[i, nr-1, c0]
  pa.Kn2 = nr / 2;
  pa.sgn = p ? -f : f;
  block_gemm<T, 2>(A, 2LL * nh, min(T::BM, (L - l0 + 1) / 2), B,
                   KUNIT ? sgc : sgr, cv, nh, o + l0, soc, smem, pa);
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

// lam: bf16 (M, L, nr); x[i, c, l] at x + i * sxm + c * sxc + l, float32;
// ms: null (M = L, row i of degree i) or M int32 degree orders on the device
int legendre_synth_tri_bf16(const void* lam, const void* x, void* out, int L,
                            int nr, int C, long long sxm, long long sxc,
                            const void* ms, int M, void* stream) {
  using T = SynthTile;
  const dim3 grid((nr + T::BN - 1) / T::BN, (C + T::BM - 1) / T::BM, M);
  return launch<T>(ms ? synth_tri_bf16<true> : synth_tri_bf16<false>, grid,
                   stream, static_cast<const uint16_t*>(lam),
                   static_cast<const float*>(x), static_cast<float*>(out), L,
                   nr, C, sxm, sxc, static_cast<const int*>(ms));
}

// g[i, r, c] at g + i * sgm + r * sgr + c * sgc with sgr == 1 or sgc == 1;
// out[i, c, l] at out + i * som + c * soc + l; ms as above
int legendre_adj_tri_bf16(const void* lam, const void* g, void* out, int L,
                          int nr, int C, long long sgm, long long sgr,
                          long long sgc, long long som, long long soc,
                          const void* ms, int M, void* stream) {
  const auto* lam_ = static_cast<const uint16_t*>(lam);
  const auto* g_ = static_cast<const float*>(g);
  auto* out_ = static_cast<float*>(out);
  const auto* ms_ = static_cast<const int*>(ms);
  if (sgr == 1) {
    using T = AdjTile<true>;
    const dim3 grid((C + T::BN - 1) / T::BN, (L + T::BM - 1) / T::BM + 1, M);
    return launch<T>(ms ? adj_tri_bf16<true, true> : adj_tri_bf16<true, false>,
                     grid, stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc,
                     som, soc, ms_);
  }
  if (sgc == 1) {
    using T = AdjTile<false>;
    const dim3 grid((C + T::BN - 1) / T::BN, (L + T::BM - 1) / T::BM + 1, M);
    return launch<T>(
        ms ? adj_tri_bf16<false, true> : adj_tri_bf16<false, false>, grid,
        stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The ring-parity modes: lam (M, L, nh) over the nh = ceil(nr / 2) north
// rings, x, g and the outputs as above over all nr rings; flip selects the
// opposite reflection parity.
int legendre_synth_par_bf16(const void* lam, const void* x, void* out, int L,
                            int nr, int C, long long sxm, long long sxc,
                            const void* ms, int M, int flip, void* stream) {
  using T = SynthParTile;
  const int nh = (nr + 1) / 2;
  const dim3 grid((nh + T::BN - 1) / T::BN, (C + T::BM - 1) / T::BM, M);
  return launch<T>(ms ? synth_par_bf16<true> : synth_par_bf16<false>, grid,
                   stream, static_cast<const uint16_t*>(lam),
                   static_cast<const float*>(x), static_cast<float*>(out), L,
                   nr, C, sxm, sxc, static_cast<const int*>(ms),
                   flip ? -1.f : 1.f);
}

int legendre_adj_par_bf16(const void* lam, const void* g, void* out, int L,
                          int nr, int C, long long sgm, long long sgr,
                          long long sgc, long long som, long long soc,
                          const void* ms, int M, int flip, void* stream) {
  const auto* lam_ = static_cast<const uint16_t*>(lam);
  const auto* g_ = static_cast<const float*>(g);
  auto* out_ = static_cast<float*>(out);
  const auto* ms_ = static_cast<const int*>(ms);
  const float f = flip ? -1.f : 1.f;
  constexpr int BM = AdjParTile<true>::BM, BN = AdjParTile<true>::BN;
  // zero tiles, then both parities' row tiles
  const int ny = (L + BM - 1) / BM + 2 * (((L + 1) / 2 + BM - 1) / BM);
  const dim3 grid((C + BN - 1) / BN, ny, M);
  if (sgr == 1)
    return launch<AdjParTile<true>>(
        ms ? adj_par_bf16<true, true> : adj_par_bf16<true, false>, grid,
        stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_, f);
  if (sgc == 1)
    return launch<AdjParTile<false>>(
        ms ? adj_par_bf16<false, true> : adj_par_bf16<false, false>, grid,
        stream, lam_, g_, out_, L, nr, C, sgm, sgr, sgc, som, soc, ms_, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory of each kernel, bytes: 0 synthesis, 1 / 2 adjoint
// with unit stride on r / c, 3 parity synthesis, 4 / 5 parity adjoint
int legendre_tri_bf16_smem(int kind) {
  switch (kind) {
    case 0: return SynthTile::SMEM;
    case 1: return AdjTile<true>::SMEM;
    case 2: return AdjTile<false>::SMEM;
    case 3: return SynthParTile::SMEM;
    case 4: return AdjParTile<true>::SMEM;
    default: return AdjParTile<false>::SMEM;
  }
}

}  // extern "C"
