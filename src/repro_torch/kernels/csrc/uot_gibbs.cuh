// The Gibbs tile of a point-cloud geometry, computed on the card: the one
// __device__ tile function that kernels h, i, j (uot_geometry.cu) and k
// (uot_resident.cu) share. Replaces the tile prologue of the TPU kernels,
// src/repro/kernels/uot_geometry.py:61-77 (_tile) and
// src/repro/kernels/uot_resident.py:185-202.
//
// Entry (r, c) of problem b is
//   K = expf(-(((xn_r + yn_c) - 2 * dot) [/ scale]) / reg),
//   dot = x_r0*y_c0 + x_r1*y_c1 + ... (unrolled, in this order),
// exactly 0 where r >= m_valid[b] or c >= n_valid[b], then rounded to the
// storage type (a bf16 tile is what a bf16 copy of the fp32 kernel holds).
// Every operation is a separately rounded __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, in the order of the plain version
// (repro_torch/geometry/pointcloud.py gibbs_tile), so nvcc contracts
// nothing into an FMA; expf is the accurate one (no __expf, no
// --use_fast_math), the function PyTorch's CUDA exp calls. The reference
// needed an XLA optimization barrier and 128-lane padding to pin its
// rounding (pointcloud.py:15-33, :85-100, dense.py:116-130); here the
// explicit operations do it.
//
// d is a runtime size (2-8 in the workloads, any value in the reference):
// the dot is unrolled for d = 2 (point-set matching) and d = 3 (colour
// transfer), D = d, and a loop over d otherwise, D = 0. On an H100 the
// loop made h, i and j 11-61% slower at d = 3 than the unrolled dot, and
// unrolling every d = 1..8 made the build 3.4x longer (PERF.md).
//
// Layout: x (B, M, d) as given (a row's d coordinates are one broadcast
// read for a warp working on that row); y is transposed by the wrapper to
// (B, d, N), so neighbouring threads, which own neighbouring columns, read
// neighbouring addresses. Nothing is staged in shared memory, so the
// streamed kernels' launch plans and kernel k's shared-memory budget are
// those of their dense twins.
#pragma once

#include <type_traits>

#include "uot_common.cuh"

namespace {

// The coordinates of a stack of point-cloud problems.
struct GibbsArgs {
  const float* x;        // (B, M, d)
  const float* xn;       // (B, M) squared norms of the rows
  const float* yt;       // (B, d, N) column coordinates, transposed
  const float* yn;       // (B, N) squared norms of the columns
  const int* m_valid;    // (B,)
  const int* n_valid;    // (B,)
  int d;
  float reg;
  float scale;
  int scaled;            // scale != 1: divide the cost by it
};

// The tile of one problem: entry (r, c), masked, in fp32 (before the
// storage rounding).
template <int D>
struct GibbsProblem {
  const float* x;
  const float* xn;
  const float* yt;
  const float* yn;
  int N, d, mv, nv;
  float reg, scale;
  int scaled;

  __device__ __forceinline__ GibbsProblem(const GibbsArgs& g, int b, int M,
                                          int N_)
      : x(g.x + (size_t)b * M * (D > 0 ? D : g.d)),
        xn(g.xn + (size_t)b * M),
        yt(g.yt + (size_t)b * (D > 0 ? D : g.d) * N_),
        yn(g.yn + (size_t)b * N_),
        N(N_),
        d(D > 0 ? D : g.d),
        mv(g.m_valid[b]),
        nv(g.n_valid[b]),
        reg(g.reg),
        scale(g.scale),
        scaled(g.scaled) {}

  __device__ __forceinline__ float operator()(int r, int c) const {
    if (r >= mv || c >= nv) return 0.f;
    const float* xr = x + (size_t)r * (D > 0 ? D : d);
    const float* yc = yt + c;
    float dot = __fmul_rn(xr[0], yc[0]);
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 1; k < D; ++k)
        dot = __fadd_rn(dot, __fmul_rn(xr[k], yc[(size_t)k * N]));
    } else {
      for (int k = 1; k < d; ++k)
        dot = __fadd_rn(dot, __fmul_rn(xr[k], yc[(size_t)k * N]));
    }
    float sq = __fsub_rn(__fadd_rn(xn[r], yn[c]), __fmul_rn(2.f, dot));
    if (scaled) sq = __fdiv_rn(sq, scale);
    return expf(__fdiv_rn(-sq, reg));
  }
};

// Tile source of the streamed kernels (see LoadTile in uot_stream.cuh):
// vector v of row r, computed and rounded to the storage type.
template <typename T, int VEC, int D>
struct GibbsTile {
  using Args = GibbsArgs;
  static constexpr bool kComputed = true;
  GibbsProblem<D> g;

  __device__ __forceinline__ GibbsTile(const GibbsArgs& a, const T*, int b,
                                       int M, int N)
      : g(a, b, M, N) {}

  __device__ __forceinline__ typename Raw<T, VEC>::type raw(int r,
                                                            int v) const {
    float y[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) y[k] = g(r, v * VEC + k);
    return from_floats<T, VEC>(y);
  }
};

// Call f(std::integral_constant<int, D>{}) with D = d for d = 2 and 3 and
// D = 0 (the runtime loop) otherwise.
template <typename F>
int with_dim(int d, F&& f) {
  switch (d) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

inline GibbsArgs gibbs_args(const float* x, const float* xn, const float* yt,
                            const float* yn, const int* m_valid,
                            const int* n_valid, int d, float reg,
                            float scale, int scaled) {
  GibbsArgs g;
  g.x = x;
  g.xn = xn;
  g.yt = yt;
  g.yn = yn;
  g.m_valid = m_valid;
  g.n_valid = n_valid;
  g.d = d;
  g.reg = reg;
  g.scale = scale;
  g.scaled = scaled;
  return g;
}

}  // namespace
