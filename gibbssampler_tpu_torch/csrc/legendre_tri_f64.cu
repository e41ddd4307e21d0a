// Triangular Legendre contractions in float64 for Hopper (sm_90a), on the
// FMA pipes.  Plain C interface, loaded with ctypes.
//
// Replaces, for float64 operands, the Pallas TPU kernels of
// gibbssampler_tpu/sht/pallas_legendre.py:
//   legendre_synth_tri (:52, _synth_kernel)
//       out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
//   legendre_adj_tri   (:106, _adj_kernel)
//       out[m, c, l] = sum_r lam[m, l, r] g[m, r, c],  0 for l < m
// with the layouts of the float32 kernels (legendre_tri.cu): lam (L, L, nr)
// row-major; x (L, C, L) with unit stride on l; g (L, nr, C) with any
// strides; synthesis out (L, nr, C) row-major; adjoint out (L, C, L) with
// unit stride on l.
//
// What bounds them: the H100's fp64 FMA rate (34 TFLOP/s on the data sheet)
// and this kernel's shared-memory reads (6 for 8 FMAs).  The float64 path
// serves the card tests and small checking runs, not the float32 main path,
// so the kernel stays simple: one thread block per (m, ring tile, batch
// tile) for synthesis and per (m, degree tile, batch tile) for the adjoint;
// 256 threads, each accumulating a 2 x 4 register tile; the contracted axis
// walked in shared-memory stages of TK.  Synthesis starts its l loop at
// l = m, and the adjoint's degree tiles start at l = m (tile j covers
// [m + j*TLA, m + (j+1)*TLA)), so no tile below the diagonal is loaded or
// multiplied.  The adjoint's output comes from torch.empty, so its first
// tile's block also writes the zeros of l < m.
// Every launch goes to the caller's stream; each entry point returns
// cudaGetLastError() so that a refused launch reaches the wrapper.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int TR = 32;         // synthesis: rings per block
constexpr int TLA = 32;        // adjoint: degrees per block
constexpr int TC = 64;         // batch columns per block
constexpr int TK = 16;         // contracted depth per shared-memory stage

__global__ void __launch_bounds__(kThreads)
synth_tri_f64(const double* __restrict__ lam, const double* __restrict__ x,
              double* __restrict__ out, int L, int nr, int C, long long sxm,
              long long sxc) {
  const int m = blockIdx.z;
  const int r0 = blockIdx.y * TR;
  const int c0 = blockIdx.x * TC;
  const int tx = threadIdx.x;  // batch direction
  const int ty = threadIdx.y;  // ring direction
  const int tid = ty * 16 + tx;

  __shared__ double ls[TK][TR];      // lam[m, l0 + k, r0 + rr]
  __shared__ double xs[TK][TC + 1];  // x[m, c0 + cc, l0 + k]

  const double* lam_m = lam + static_cast<size_t>(m) * L * nr;
  const double* x_m = x + m * sxm;

  double acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

  for (int l0 = m; l0 < L; l0 += TK) {
    for (int i = tid; i < TK * TR; i += kThreads) {
      const int k = i / TR, rr = i % TR;
      const int l = l0 + k, r = r0 + rr;
      ls[k][rr] = (l < L && r < nr) ? lam_m[static_cast<size_t>(l) * nr + r] : 0.0;
    }
    for (int i = tid; i < TC * TK; i += kThreads) {
      const int cc = i / TK, k = i % TK;
      const int l = l0 + k, c = c0 + cc;
      xs[k][cc] = (l < L && c < C) ? x_m[c * sxc + l] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      double a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = ls[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  double* out_m = out + static_cast<size_t>(m) * nr * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < C) out_m[static_cast<size_t>(r) * C + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adj_tri_f64(const double* __restrict__ lam, const double* __restrict__ g,
            double* __restrict__ out, int L, int nr, int C, long long sgm,
            long long sgr, long long sgc, long long som, long long soc) {
  const int m = blockIdx.z;
  const int l0 = m + blockIdx.y * TLA;
  const int c0 = blockIdx.x * TC;
  const int tx = threadIdx.x;  // degree direction
  const int ty = threadIdx.y;  // batch direction
  const int tid = ty * 16 + tx;

  double* out_m = out + m * som;
  if (blockIdx.y == 0) {
    // zeros below the diagonal: out[m, c, l] for l < m, this batch tile
    for (int i = tid; i < TC * m; i += kThreads) {
      const int cc = i / m, l = i % m;
      const int c = c0 + cc;
      if (c < C) out_m[c * soc + l] = 0.0;
    }
  }
  if (l0 >= L) return;  // uniform across the block

  __shared__ double ls[TLA][TK + 1];  // lam[m, l0 + ll, r0 + k]
  __shared__ double gs[TK][TC];       // g[m, r0 + k, c0 + cc]

  const double* lam_m = lam + static_cast<size_t>(m) * L * nr;
  const double* g_m = g + m * sgm;

  double acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

  for (int r0 = 0; r0 < nr; r0 += TK) {
    for (int i = tid; i < TLA * TK; i += kThreads) {
      const int ll = i / TK, k = i % TK;
      const int l = l0 + ll, r = r0 + k;
      ls[ll][k] = (l < L && r < nr) ? lam_m[static_cast<size_t>(l) * nr + r] : 0.0;
    }
    for (int i = tid; i < TK * TC; i += kThreads) {
      const int k = i / TC, cc = i % TC;
      const int r = r0 + k, c = c0 + cc;
      gs[k][cc] = (r < nr && c < C) ? g_m[r * sgr + c * sgc] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      double a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = ls[tx + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = gs[k][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + ty + 16 * j;
    if (c >= C) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int l = l0 + tx + 16 * i;
      if (l < L) out_m[c * soc + l] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x[m, c, l] at x + m * sxm + c * sxc + l
int legendre_synth_tri_f64(const void* lam, const void* x, void* out, int L,
                           int nr, int C, long long sxm, long long sxc,
                           void* stream) {
  const dim3 grid((C + TC - 1) / TC, (nr + TR - 1) / TR, L);
  synth_tri_f64<<<grid, dim3(16, 16), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lam), static_cast<const double*>(x),
      static_cast<double*>(out), L, nr, C, sxm, sxc);
  return static_cast<int>(cudaGetLastError());
}

// g[m, r, c] at g + m * sgm + r * sgr + c * sgc;
// out[m, c, l] at out + m * som + c * soc + l
int legendre_adj_tri_f64(const void* lam, const void* g, void* out, int L,
                         int nr, int C, long long sgm, long long sgr,
                         long long sgc, long long som, long long soc,
                         void* stream) {
  const dim3 grid((C + TC - 1) / TC, (L + TLA - 1) / TLA, L);
  adj_tri_f64<<<grid, dim3(16, 16), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lam), static_cast<const double*>(g),
      static_cast<double*>(out), L, nr, C, sgm, sgr, sgc, som, soc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
