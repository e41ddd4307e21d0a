// Triangular Legendre contractions of a narrow table (bfloat16 or float32)
// with a float64 batch, for Hopper (sm_90a): the table read in its own
// dtype and widened in registers, the batch rounded to the table dtype,
// the exact products summed in float64 on the FMA pipes.  Plain C
// interface, loaded with ctypes.
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
// exact in float64, so every output is a float64 sum of exact products, in
// ascending l (synthesis) or r (adjoint) within each parity class.
//
// What bounds them: at the CG family's C = 16 columns (8 chains x Re/Im),
// the FMA pipes.  At L 513, nr 513 one dense call does 2 nr C L(L+1)/2 =
// 2.16 GFLOP: 0.0323 ms at 67 TFLOP/s (the fp64 tensor-core rate, the
// bound in PERF.md) and 0.065 ms at the 33.5 TFLOP/s of the FMA pipes these
// kernels use, against 0.0555 ms (bfloat16) and 0.0958 ms (float32) for the
// bytes at 3.35 TB/s; so the bfloat16 ones cannot reach their bound on the
// FMA pipes, and the float32 ones can only with the pipes nearly full.
//
// Design (first version: simple and right, one stage in flight).
// - Synthesis: a thread a ring (a block one ring tile of at most 128 rings
//   of one row i, of sizes that differ by at most one tile of 32), a block
//   NC = 16 batch columns.  Each thread streams its ring's column of the
//   table straight from global memory into registers, KL = 32 degree rows
//   a stage (a warp reads 32 consecutive rings of one row: coalesced), the
//   next stage's loads issued before the current stage's products.  The
//   stage's batch values x[i, c, l0:l0+KL], rounded, sit in shared memory
//   and are read by every thread at once (broadcast), two degrees a 16-byte
//   load.  The parity mode keeps two sums a column: a stage starts at an
//   even l - m, so the class of each unrolled step is known at compile time.
// - Adjoint: a thread a degree row (a block 128 rows of one row i), a block
//   NC columns.  Each stage stages a 128 x KR (32 rings) table tile in
//   shared memory in the table dtype, by coalesced loads along r, rows at an
//   odd word stride (no bank conflicts when each thread reads its row), and
//   the KR x NC batch tile rounded (the parity mode: U and V, the folds).
//   In the parity mode each warp holds rows of one class of l - m (threads
//   0-63 the even class, 64-127 the odd one), so that a warp reads one of U
//   and V.  Blocks whose rows all lie below m only write zeros.
// - Column tiles of one (row, ring tile) are consecutive blocks, so that at
//   C > 16 the second tile finds the table in L2.
// Every launch goes to the caller's stream; each entry point returns
// cudaGetLastError() so that a refused launch reaches the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  // adjoint table tile rows: 34 elements, an odd number (17) of words
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
  // adjoint table tile rows: 33 words
  static constexpr int kTileStride = KR + 1;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ double round(double v) {
    return static_cast<double>(__double2float_rn(v));
  }
};

// ---------------------------------------------------------------------------
// synthesis: grid (ceil(C / NC), ring tiles, M), a thread a ring
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

template <typename T, bool PAR>
__global__ void __launch_bounds__(kMaxRingTile)
    synth_narrow(const T* __restrict__ lam, const double* __restrict__ x,
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
        if (PAR)
          so[c] = fma(t1, v.y, so[c]);
        else
          se[c] = fma(t1, v.y, se[c]);
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
    if (!PAR) {
      north[c0 + c] = se[c];
    } else {
      north[c0 + c] = se[c] + so[c];
      if (r < nr - nt) south[c0 + c] = f * (se[c] - so[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// adjoint: grid (ceil(C / NC), ceil(L / LT), M), a thread a degree row
// ---------------------------------------------------------------------------

// the degree row of thread / tile row j of the block at lb: lb + j, or in
// the parity mode the rows of even l - m on j < 64 and odd ones on j >= 64
template <bool PAR>
__device__ __forceinline__ int adj_row(int j, int lb, int m) {
  if (!PAR) return lb + j;
  const int p = j / (LT / 2), q = j % (LT / 2);
  return lb + 2 * q + ((p + m + lb) & 1);
}

template <typename T, bool PAR>
__global__ void __launch_bounds__(LT)
    adj_narrow(const T* __restrict__ lam, const double* __restrict__ g,
               double* __restrict__ out, int L, int nr, int nt, int C,
               long long sgm, long long sgr, long long sgc, long long som,
               long long soc, const int* __restrict__ ms, double f) {
  constexpr int TS = Narrow<T>::kTileStride;
  __shared__ T tab[LT * TS];
  __shared__ __align__(16) double us[KR][NC];
  __shared__ __align__(16) double vs[PAR ? KR : 1][NC];
  const int i = blockIdx.z;
  const int m = degree(ms, i);
  const int c0 = blockIdx.x * NC;
  const int lb = blockIdx.y * LT;
  const int j = threadIdx.x;
  const int l = adj_row<PAR>(j, lb, m);
  const T* lami = lam + static_cast<long long>(i) * L * nt;
  const double* gi = g + i * sgm;
  const bool r_unit = sgr == 1;
  double acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0;
  // rows of class (l - m) odd read V; a warp's rows are of one class
  const double(*src)[NC] = (PAR && ((l - m) & 1)) ? vs : us;
  if (lb + LT > m) {
    for (int r0 = 0; r0 < nt; r0 += KR) {
      __syncthreads();  // the previous stage's reads are done
      // the table tile: a warp reads KR consecutive rings of one row
      for (int e = j; e < LT * KR; e += LT) {
        const int row = e / KR, k = e % KR;
        const int lr = adj_row<PAR>(row, lb, m);
        tab[row * TS + k] =
            (lr >= m && lr < L && r0 + k < nt)
                ? lami[static_cast<long long>(lr) * nt + r0 + k]
                : Narrow<T>::zero();
      }
      // the batch tile (rounded; the parity mode's folds U and V), read
      // along g's unit stride
      for (int e = j; e < KR * NC; e += LT) {
        const int k = r_unit ? e % KR : e / NC;
        const int c = r_unit ? e / KR : e % NC;
        const int rr = r0 + k;
        double u = 0.0, v = 0.0;
        if (rr < nt && c0 + c < C) {
          const double gn = gi[rr * sgr + (c0 + c) * sgc];
          if (PAR) {
            const double gs =
                rr < nr - nt ? f * gi[(nr - 1 - rr) * sgr + (c0 + c) * sgc]
                             : 0.0;
            u = Narrow<T>::round(gn + gs);
            v = Narrow<T>::round(gn - gs);
          } else {
            u = Narrow<T>::round(gn);
          }
        }
        us[k][c] = u;
        if (PAR) vs[k][c] = v;
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

template <typename T>
int launch_synth(const void* lam, const void* x, void* out, int L, int nr,
                 int nt, int C, long long sxm, long long sxc, const int* ms,
                 int M, cudaStream_t s, bool par, double f) {
  // the fewest ring tiles of at most kMaxRingTile rings, of even sizes
  const int tiles = (nt + kMaxRingTile - 1) / kMaxRingTile;
  const int per = (nt + tiles - 1) / tiles;
  const int threads = (per + 31) / 32 * 32;
  const dim3 grid((C + NC - 1) / NC, (nt + threads - 1) / threads, M);
  const auto* lt = static_cast<const T*>(lam);
  const auto* xb = static_cast<const double*>(x);
  auto* o = static_cast<double*>(out);
  if (par)
    synth_narrow<T, true><<<grid, threads, 0, s>>>(lt, xb, o, L, nr, nt, C,
                                                   sxm, sxc, ms, f);
  else
    synth_narrow<T, false><<<grid, threads, 0, s>>>(lt, xb, o, L, nr, nt, C,
                                                    sxm, sxc, ms, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adj(const void* lam, const void* g, void* out, int L, int nr,
               int nt, int C, long long sgm, long long sgr, long long sgc,
               long long som, long long soc, const int* ms, int M,
               cudaStream_t s, bool par, double f) {
  const dim3 grid((C + NC - 1) / NC, (L + LT - 1) / LT, M);
  const auto* lt = static_cast<const T*>(lam);
  const auto* gb = static_cast<const double*>(g);
  auto* o = static_cast<double*>(out);
  if (par)
    adj_narrow<T, true><<<grid, LT, 0, s>>>(lt, gb, o, L, nr, nt, C, sgm,
                                            sgr, sgc, som, soc, ms, f);
  else
    adj_narrow<T, false><<<grid, LT, 0, s>>>(lt, gb, o, L, nr, nt, C, sgm,
                                             sgr, sgc, som, soc, ms, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The entry points, one set per table dtype (suffix bf16f64: bfloat16,
// f32f64: float32), with the arguments of legendre_tri_f64.cu's:
// x[i, c, l] at x + i * sxm + c * sxc + l; g[i, r, c] at g + i * sgm + r *
// sgr + c * sgc; out[i, c, l] at out + i * som + c * soc + l; ms null (M =
// L, row i of degree i) or M int32 degree orders on the device; nr the
// dense table's rings, or in the parity mode the output's (synthesis) or
// g's (adjoint) rings, of which the table holds ceil(nr / 2); flip the
// table's opposite reflection parity.
#define NARROW_F64_ENTRY_POINTS(SFX, T)                                      \
  int legendre_synth_tri_##SFX(const void* lam, const void* x, void* out,   \
                               int L, int nr, int C, long long sxm,         \
                               long long sxc, const void* ms, int M,        \
                               void* stream) {                              \
    return launch_synth<T>(lam, x, out, L, nr, nr, C, sxm, sxc,              \
                           static_cast<const int*>(ms), M,                   \
                           static_cast<cudaStream_t>(stream), false, 1.0);   \
  }                                                                          \
  int legendre_adj_tri_##SFX(const void* lam, const void* g, void* out,     \
                             int L, int nr, int C, long long sgm,           \
                             long long sgr, long long sgc, long long som,   \
                             long long soc, const void* ms, int M,          \
                             void* stream) {                                \
    return launch_adj<T>(lam, g, out, L, nr, nr, C, sgm, sgr, sgc, som, soc, \
                         static_cast<const int*>(ms), M,                     \
                         static_cast<cudaStream_t>(stream), false, 1.0);     \
  }                                                                          \
  int legendre_synth_par_##SFX(const void* lam, const void* x, void* out,   \
                               int L, int nr, int C, long long sxm,         \
                               long long sxc, const void* ms, int M,        \
                               int flip, void* stream) {                    \
    return launch_synth<T>(lam, x, out, L, nr, (nr + 1) / 2, C, sxm, sxc,    \
                           static_cast<const int*>(ms), M,                   \
                           static_cast<cudaStream_t>(stream), true,          \
                           flip ? -1.0 : 1.0);                               \
  }                                                                          \
  int legendre_adj_par_##SFX(const void* lam, const void* g, void* out,     \
                             int L, int nr, int C, long long sgm,           \
                             long long sgr, long long sgc, long long som,   \
                             long long soc, const void* ms, int M, int flip,\
                             void* stream) {                                \
    return launch_adj<T>(lam, g, out, L, nr, (nr + 1) / 2, C, sgm, sgr, sgc, \
                         som, soc, static_cast<const int*>(ms), M,           \
                         static_cast<cudaStream_t>(stream), true,            \
                         flip ? -1.0 : 1.0);                                 \
  }

extern "C" {
NARROW_F64_ENTRY_POINTS(bf16f64, __nv_bfloat16)
NARROW_F64_ENTRY_POINTS(f32f64, float)
}  // extern "C"
