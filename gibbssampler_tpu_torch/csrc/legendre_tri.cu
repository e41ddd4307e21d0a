// Triangular Legendre contractions for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of gibbssampler_tpu/sht/pallas_legendre.py:
//   legendre_synth_tri (_synth_kernel)  out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
//   legendre_adj_tri   (_adj_kernel)    out[m, c, l] = sum_r lam[m, l, r] g[m, r, c], 0 for l < m
// with the same layouts: lam (L, L, nr), x (L, C, L), g (L, nr, C),
// synthesis out (L, nr, C), adjoint out (L, C, L), all row-major contiguous.
//
// What bounds them: per m each is a (nr x L) by (L x C) matrix product over
// the triangle l >= m.  At the main-path shape (L = 513, nr = 65, C = 256)
// one call needs ~4.4 GFLOP and, read once, the ~34 MB fp32 table half and
// the ~135 MB batch half: ~26 FLOP per byte, about the ridge of the H100's
// plain fp32 FMA rate (67 TFLOP/s over 3.35 TB/s on the data sheet).  This
// kernel stays on the FMA pipes, so its FMA issue rate and its
// shared-memory reads bound it; tensor-core (wgmma) tiles would leave the
// memory traffic as the bound.
//
// Design (simple and correct first; wgmma and TMA are later work):
// - one thread block per (m, ring tile, batch tile) for synthesis and per
//   (m, degree tile, batch tile) for the adjoint; 256 threads, each
//   accumulating a 2 x 4 register tile with FMAs in the element type;
// - the contracted axis is walked in shared-memory stages of TK;
// - the triangle: synthesis starts its l loop at l = m, and the adjoint's
//   degree tiles start at l = m (tile j covers [m + j*TLA, m + (j+1)*TLA)),
//   so no tile below the diagonal is loaded or multiplied.  Blocks whose
//   tile starts past L return at once.  The adjoint's output comes from
//   torch.empty, so its first tile's block also writes the zeros of l < m
//   (the Pallas kernel zero-initialised its output block instead).
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
synth_tri_kernel(const T* __restrict__ lam, const T* __restrict__ x,
                 T* __restrict__ out, int L, int nr, int C) {
  const int m = blockIdx.z;
  const int r0 = blockIdx.y * TR;
  const int c0 = blockIdx.x * TC;
  const int tx = threadIdx.x;  // batch direction
  const int ty = threadIdx.y;  // ring direction
  const int tid = ty * 16 + tx;

  __shared__ T ls[TK][TR];      // lam[m, l0 + k, r0 + rr]
  __shared__ T xs[TK][TC + 1];  // x[m, c0 + cc, l0 + k]

  const T* lam_m = lam + static_cast<size_t>(m) * L * nr;
  const T* x_m = x + static_cast<size_t>(m) * C * L;

  T acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int l0 = m; l0 < L; l0 += TK) {
    for (int i = tid; i < TK * TR; i += kThreads) {
      const int k = i / TR, rr = i % TR;
      const int l = l0 + k, r = r0 + rr;
      ls[k][rr] = (l < L && r < nr) ? lam_m[static_cast<size_t>(l) * nr + r] : T(0);
    }
    for (int i = tid; i < TC * TK; i += kThreads) {
      const int cc = i / TK, k = i % TK;
      const int l = l0 + k, c = c0 + cc;
      xs[k][cc] = (l < L && c < C) ? x_m[static_cast<size_t>(c) * L + l] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      T a[2], b[4];
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

  T* out_m = out + static_cast<size_t>(m) * nr * C;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
adj_tri_kernel(const T* __restrict__ lam, const T* __restrict__ g,
               T* __restrict__ out, int L, int nr, int C) {
  const int m = blockIdx.z;
  const int l0 = m + blockIdx.y * TLA;
  const int c0 = blockIdx.x * TC;
  const int tx = threadIdx.x;  // degree direction
  const int ty = threadIdx.y;  // batch direction
  const int tid = ty * 16 + tx;

  T* out_m = out + static_cast<size_t>(m) * C * L;
  if (blockIdx.y == 0) {
    // zeros below the diagonal: out[m, c, l] for l < m, this batch tile
    for (int i = tid; i < TC * m; i += kThreads) {
      const int cc = i / m, l = i % m;
      const int c = c0 + cc;
      if (c < C) out_m[static_cast<size_t>(c) * L + l] = T(0);
    }
  }
  if (l0 >= L) return;  // uniform across the block

  __shared__ T ls[TLA][TK + 1];  // lam[m, l0 + ll, r0 + k]
  __shared__ T gs[TK][TC];       // g[m, r0 + k, c0 + cc]

  const T* lam_m = lam + static_cast<size_t>(m) * L * nr;
  const T* g_m = g + static_cast<size_t>(m) * nr * C;

  T acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int r0 = 0; r0 < nr; r0 += TK) {
    for (int i = tid; i < TLA * TK; i += kThreads) {
      const int ll = i / TK, k = i % TK;
      const int l = l0 + ll, r = r0 + k;
      ls[ll][k] = (l < L && r < nr) ? lam_m[static_cast<size_t>(l) * nr + r] : T(0);
    }
    for (int i = tid; i < TK * TC; i += kThreads) {
      const int k = i / TC, cc = i % TC;
      const int r = r0 + k, c = c0 + cc;
      gs[k][cc] = (r < nr && c < C) ? g_m[static_cast<size_t>(r) * C + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      T a[2], b[4];
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
      if (l < L) out_m[static_cast<size_t>(c) * L + l] = acc[i][j];
    }
  }
}

template <typename T>
int launch_synth(const T* lam, const T* x, T* out, int L, int nr, int C,
                 void* stream) {
  const dim3 grid((C + TC - 1) / TC, (nr + TR - 1) / TR, L);
  synth_tri_kernel<T><<<grid, dim3(16, 16), 0,
                        static_cast<cudaStream_t>(stream)>>>(lam, x, out, L, nr, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adj(const T* lam, const T* g, T* out, int L, int nr, int C,
               void* stream) {
  const dim3 grid((C + TC - 1) / TC, (L + TLA - 1) / TLA, L);
  adj_tri_kernel<T><<<grid, dim3(16, 16), 0,
                      static_cast<cudaStream_t>(stream)>>>(lam, g, out, L, nr, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int legendre_synth_tri_f32(const void* lam, const void* x, void* out, int L,
                           int nr, int C, void* stream) {
  return launch_synth(static_cast<const float*>(lam),
                      static_cast<const float*>(x), static_cast<float*>(out),
                      L, nr, C, stream);
}

int legendre_synth_tri_f64(const void* lam, const void* x, void* out, int L,
                           int nr, int C, void* stream) {
  return launch_synth(static_cast<const double*>(lam),
                      static_cast<const double*>(x), static_cast<double*>(out),
                      L, nr, C, stream);
}

int legendre_adj_tri_f32(const void* lam, const void* g, void* out, int L,
                         int nr, int C, void* stream) {
  return launch_adj(static_cast<const float*>(lam),
                    static_cast<const float*>(g), static_cast<float*>(out),
                    L, nr, C, stream);
}

int legendre_adj_tri_f64(const void* lam, const void* g, void* out, int L,
                         int nr, int C, void* stream) {
  return launch_adj(static_cast<const double*>(lam),
                    static_cast<const double*>(g), static_cast<double*>(out),
                    L, nr, C, stream);
}

}  // extern "C"
