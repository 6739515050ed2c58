// Point-cloud geometry kernels for Hopper (sm_90a): kernels h, i and j of
// the port, behind ops.solve_fused_batched(geometry=...) and the serving
// tier's point requests. Built and bound like uot_batched.cu (see there);
// the launchers return cudaGetLastError(), or a negative code for
// arguments they do not take.
//
// The Gibbs kernel K = exp(-||x - y||^2 / (scale * reg)) of a point cloud
// is a function of O((M + N) * d) coordinates. These kernels compute its
// tiles on the card (the tile function of uot_gibbs.cuh) instead of
// reading an M*N matrix:
//   h: the Algorithm-1 preprocessing column sums — nothing M*N-sized is
//      read or written;
//   i: iteration 1 with the tile computed — the solve's first M*N write
//      is the rescaled A1, and K never reaches device memory;
//   j: the masked Gibbs stack, stored (scheduler admission, kernel(),
//      num_iters == 0).
// h and i are kernels c and d of uot_stream.cuh with the GibbsTile source:
// the same grid, plan (the wrapper's uot_batched.plan_colsum / plan_for)
// and summation order, so on one problem h gives c's sums of j's output
// and i gives d's pass over it, bit for bit. The TPU kernels kept their
// column sums in one output block revisited by sequential grid steps
// (uot_geometry.py:145-149, :201-206); here, as for c and d, blocks write
// partial sums that a second launch adds in a fixed order. No atomics.

#include "uot_gibbs.cuh"
#include "uot_stream.cuh"

namespace {

// Call f(Tag<T>{}, std::integral_constant<int, VEC>{}) for the storage
// type (0 = float32, 1 = bfloat16) and a vector width it has.
template <typename T> struct Tag { using type = T; };

template <typename F>
int with_storage(int dtype, int vec, int N, F&& f) {
  using One = std::integral_constant<int, 1>;
  if (dtype == 0 && vec == 1) return f(Tag<float>{}, One{});
  if (dtype == 0 && vec == 4 && N % 4 == 0)
    return f(Tag<float>{}, std::integral_constant<int, 4>{});
  if (dtype == 1 && vec == 1) return f(Tag<__nv_bfloat16>{}, One{});
  if (dtype == 1 && vec == 8 && N % 8 == 0)
    return f(Tag<__nv_bfloat16>{}, std::integral_constant<int, 8>{});
  return -2;
}

// Kernel j: compute, mask, round, store. Grid (row blocks of kJRows rows,
// column tiles of kThreads vectors, B): a thread owns one vector column
// and walks the block's rows; each store is VEC elements (16 bytes when N
// allows). Bound: bytes, B*M*N*s written, against about 2d + 4 fp32
// operations and one expf per entry.
constexpr int kJRows = 8;

template <typename T, int VEC, int D>
__global__ void __launch_bounds__(kThreads)
    pc_materialize_kernel(T* __restrict__ out, const GibbsArgs g, int M,
                          int N) {
  const int b = blockIdx.z;
  const int v = blockIdx.y * kThreads + threadIdx.x;
  if (v >= N / VEC) return;
  const GibbsTile<T, VEC, D> src(g, nullptr, b, M, N);
  const int r0 = blockIdx.x * kJRows;
  const int r1 = min(M, r0 + kJRows);
  T* p = out + ((size_t)b * M + r0) * N + (size_t)v * VEC;
  for (int r = r0; r < r1; ++r, p += N) store_raw<T, VEC>(p, src.raw(r, v));
}

inline bool valid_geometry(int B, int M, int N, int d) {
  return B > 0 && M > 0 && N > 0 && d > 0 && B <= 65535;
}

}  // namespace

// Kernel j. Replaces src/repro/kernels/uot_geometry.py:112
// batched_pc_materialize (pallas_call :128). out (B, M, N) fp32 (dtype 0)
// or bf16 (dtype 1); x (B, M, d), xn (B, M), yt (B, d, N), yn (B, N) fp32;
// m_valid, n_valid (B,) int32. vec: 1 or 16 bytes / itemsize.
extern "C" int uot_pc_materialize(void* out, const float* x,
                                  const float* xn, const float* yt,
                                  const float* yn, const int* m_valid,
                                  const int* n_valid, int B, int M, int N,
                                  int d, int dtype, int vec, float reg,
                                  float scale, int scaled, void* stream) {
  if (!valid_geometry(B, M, N, d)) return -1;
  const GibbsArgs g = gibbs_args(x, xn, yt, yn, m_valid, n_valid, d, reg,
                                 scale, scaled);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_storage(dtype, vec, N, [&](auto tag, auto V) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(V)::value;
    return with_dim(d, [&](auto Dc) {
      constexpr int D = decltype(Dc)::value;
      const int tiles = (N / VEC + kThreads - 1) / kThreads;
      pc_materialize_kernel<T, VEC, D>
          <<<dim3((M + kJRows - 1) / kJRows, tiles, B), kThreads, 0, s>>>(
              static_cast<T*>(out), g, M, N);
      return (int)cudaGetLastError();
    });
  });
}

// Kernel h. Replaces src/repro/kernels/uot_geometry.py:155
// batched_pc_colsum (pallas_call :172). Column sums (B, N) fp32 of the
// masked tile rounded to the storage dtype (dtype), through partials
// (B, R, N) fp32 scratch; the row plan is kernel c's (plan_colsum).
// Bound: operations (the tile is computed, nothing M*N moves).
extern "C" int uot_pc_colsum(const float* x, const float* xn,
                             const float* yt, const float* yn,
                             const int* m_valid, const int* n_valid,
                             float* partial, float* out, int B, int M, int N,
                             int d, int dtype, int vec, int rows_per_cta,
                             int R, float reg, float scale, int scaled,
                             void* stream) {
  if (!valid_geometry(B, M, N, d) || !valid_grid(B, M, N, rows_per_cta, R))
    return -1;
  const GibbsArgs g = gibbs_args(x, xn, yt, yn, m_valid, n_valid, d, reg,
                                 scale, scaled);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_storage(dtype, vec, N, [&](auto tag, auto V) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(V)::value;
    return with_dim(d, [&](auto Dc) {
      constexpr int D = decltype(Dc)::value;
      return launch_colsum<T, VEC, GibbsTile<T, VEC, D>>(
          nullptr, partial, out, B, M, N, rows_per_cta, R, s, g);
    });
  });
}

// Kernel i. Replaces src/repro/kernels/uot_geometry.py:212
// batched_pc_first_iteration (pallas_call :233). Writes A1 (B, M, N) in
// the storage dtype, colsum (B, N) and frow (B, M) fp32, from fcol (B, N)
// and a (B, M) fp32 and the coordinates; the plan (bm, rows_per_cta, R,
// one_pass, vec) is kernel d's (plan_for). Bound: bytes, B*M*N*s written.
extern "C" int uot_pc_first_iteration(
    void* A, const float* fcol, const float* a, float* colsum, float* frow,
    float* partial, const float* x, const float* xn, const float* yt,
    const float* yn, const int* m_valid, const int* n_valid, int B, int M,
    int N, int d, int dtype, int vec, int bm, int rows_per_cta, int R,
    int one_pass, float fi, int fi_one, float reg, float scale, int scaled,
    void* stream) {
  if (!valid_geometry(B, M, N, d) || !valid_grid(B, M, N, rows_per_cta, R))
    return -1;
  if (bm <= 0 || (bm & (bm - 1)) != 0 || rows_per_cta % bm != 0) return -3;
  if (frow == nullptr) return -4;
  const GibbsArgs g = gibbs_args(x, xn, yt, yn, m_valid, n_valid, d, reg,
                                 scale, scaled);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_storage(dtype, vec, N, [&](auto tag, auto V) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(V)::value;
    return with_dim(d, [&](auto Dc) {
      constexpr int D = decltype(Dc)::value;
      return dispatch_fused<T, VEC, GibbsTile<T, VEC, D>>(
          A, fcol, a, nullptr, colsum, frow, partial, B, M, N, bm,
          rows_per_cta, R, one_pass, fi, fi_one, s, g);
    });
  });
}
