// The streamed kernels shared by the single-problem launchers of
// uot_fused.cu (kernels a, b: B = 1) and the stack launchers of
// uot_batched.cu (kernels c, d, e): the column sums of a stack, and the
// Algorithm-1 pass, which streams the coupling from device memory through
// the block once per iteration.
//
// Column sums across blocks. The TPU kernels carry each problem's column
// sums in one VMEM block that sequential grid steps revisit
// (uot_fused.py:70-77, uot_batched.py:57-61, :123-127, :184-189). CUDA
// blocks run concurrently and in no order, so here each block owns
// `rows_per_cta` rows of one problem and writes its own partial column sums
// (B, R, N); a second small launch sums the R partials of each column in
// a fixed order (reduce_partials_kernel). No float atomics: the result is
// the same bits on every run.
//
// Rows. The row sum needs a whole row before the row can be rescaled.
// ONE-PASS: a block stages `bm` rows of its storage tile in shared memory
// while it sums them, so the coupling is read once and written once.
// TWO-PASS (rows too wide for the shared-memory budget): the block sums
// `bm` rows, then reads them again (from L2) to scale and store.
//
// Ragged edges: rows past M are masked by the block's row range; columns
// are loaded as 16-byte vectors when N is a multiple of the vector width
// and the base is aligned, else one element at a time (VEC == 1).
#pragma once

#include "uot_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum the R row-block partials of each column: (B, R, N) -> (B, N). A
// block owns 32 columns of one problem, a lane per column (coalesced rows
// of 128 bytes); each of its warps adds a contiguous slice of the R
// partial rows in row order, and warp 0 then adds the slices in order. The
// order depends on R alone, so a launch repeats bit for bit. Splitting R
// over the warps matters for one problem, whose R is in the hundreds
// (kernels a and b); a thread per column adding all R rows left the
// reduction latency-bound there.
// With a lane mask, frozen lanes keep the column sums they carried.
constexpr int kReduceCols = 32;

__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ partial,
                           float* __restrict__ out,
                           const uint8_t* __restrict__ mask, int R, int N) {
  const int b = blockIdx.y;
  if (mask != nullptr && mask[b] == 0) return;
  __shared__ float slice[kWarps][kReduceCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kReduceCols + lane;
  const int per = (R + kWarps - 1) / kWarps;
  const int r1 = min(R, (warp + 1) * per);
  float s = 0.f;
  if (n < N) {
    const float* p = partial + (size_t)b * R * N + n;
#pragma unroll 8
    for (int r = warp * per; r < r1; ++r) s += p[(size_t)r * N];
  }
  slice[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && n < N) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += slice[w][lane];
    out[(size_t)b * N + n] = t;
  }
}

inline int launch_reduce(const float* partial, float* out,
                         const uint8_t* mask, int B, int R, int N,
                         cudaStream_t stream) {
  reduce_partials_kernel<<<dim3((N + kReduceCols - 1) / kReduceCols, B),
                           kThreads, 0, stream>>>(partial, out, mask, R, N);
  return (int)cudaGetLastError();
}

// Column sums of a stack, (B, M, N) -> partials (B, R, N), then the
// in-order reduction above to (B, N): kernel c, and kernel a at B = 1.
// Bound: bytes, B*M*N*s read once (the partials add B*R*N*4 written and
// read). Grid (R, column tiles, B): block (r, t, b) owns rows
// [r*rows_per_cta, ...) of problem b and the kThreads*VEC columns of tile
// t, one vector column per thread, four rows' loads in flight, summed in
// row order. Tiling the columns as well as the rows lets one problem fill
// the card with few row blocks, and so few partials.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    colsum_partial_kernel(const T* __restrict__ A, float* __restrict__ partial,
                          int M, int N, int rows_per_cta) {
  const int b = blockIdx.z;
  const int cta = blockIdx.x;
  const int R = gridDim.x;
  const int v = blockIdx.y * kThreads + threadIdx.x;
  if (v >= N / VEC) return;
  const int row_lo = cta * rows_per_cta;
  const int row_hi = min(M, row_lo + rows_per_cta);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  const T* p = A + ((size_t)b * M + row_lo) * N + (size_t)v * VEC;
  int r = row_lo;
  for (; r + 4 <= row_hi; r += 4, p += 4 * (size_t)N) {
    float x0[VEC], x1[VEC], x2[VEC], x3[VEC];
    to_floats<T, VEC>(load_raw<T, VEC>(p), x0);
    to_floats<T, VEC>(load_raw<T, VEC>(p + N), x1);
    to_floats<T, VEC>(load_raw<T, VEC>(p + 2 * (size_t)N), x2);
    to_floats<T, VEC>(load_raw<T, VEC>(p + 3 * (size_t)N), x3);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      acc[k] = (((acc[k] + x0[k]) + x1[k]) + x2[k]) + x3[k];
  }
  for (; r < row_hi; ++r, p += N) {
    float x0[VEC];
    to_floats<T, VEC>(load_raw<T, VEC>(p), x0);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += x0[k];
  }
  float* out = partial + ((size_t)b * R + cta) * N + (size_t)v * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = acc[k];
}

inline bool valid_grid(int B, int M, int N, int rows_per_cta, int R) {
  return B > 0 && M > 0 && N > 0 && rows_per_cta > 0 && R > 0 &&
         B <= 65535 && (size_t)R * rows_per_cta >= (size_t)M &&
         (size_t)(R - 1) * rows_per_cta < (size_t)M;
}

template <typename T, int VEC>
int launch_colsum(const void* A, float* partial, float* out, int B, int M,
                  int N, int rows_per_cta, int R, cudaStream_t stream) {
  const int tiles = (N / VEC + kThreads - 1) / kThreads;
  colsum_partial_kernel<T, VEC><<<dim3(R, tiles, B), kThreads, 0, stream>>>(
      static_cast<const T*>(A), partial, M, N, rows_per_cta);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce(partial, out, nullptr, B, R, N, stream);
}

// Checked entry of the column sums for the extern "C" launchers: the row
// plan must cover M, and the vector width be one the storage type has.
inline int colsum_checked(const void* A, float* partial, float* out, int B,
                          int M, int N, int dtype, int vec, int rows_per_cta,
                          int R, void* stream) {
  if (!valid_grid(B, M, N, rows_per_cta, R)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UOT_COLSUM(T, V) \
  return launch_colsum<T, V>(A, partial, out, B, M, N, rows_per_cta, R, s)
  if (dtype == 0 && vec == 1) UOT_COLSUM(float, 1);
  if (dtype == 0 && vec == 4 && N % 4 == 0) UOT_COLSUM(float, 4);
  if (dtype == 1 && vec == 1) UOT_COLSUM(__nv_bfloat16, 1);
  if (dtype == 1 && vec == 8 && N % 8 == 0) UOT_COLSUM(__nv_bfloat16, 8);
#undef UOT_COLSUM
  return -2;
}

// One Algorithm-1 pass over a stack, in place. Per block, for each
// sub-block of bm rows:
//   phase 1: row sums of A*fcol (a warp, or wpr warps, per row), the row
//            factors frow = safe_pow(a, rowsum, fi);
//   phase 2: each thread owns VEC columns: A' = (A*fcol)*frow stored in
//            place, the column partials accumulated in shared memory.
// Bound: bytes, 2*B*M*N*s (read + write of the tile) + O(B*(M+N)) per
// iteration; the one-pass variant moves exactly that plus the partials,
// the two-pass variant re-reads the sub-block from L2.
// MASKED: a lane with mask 0 is skipped by every block, so its tile,
// carried column sums and frow stay as they were, bit for bit.
template <typename T, int VEC, bool MASKED, bool ONEPASS>
__global__ void __launch_bounds__(kThreads)
    fused_iter_kernel(T* __restrict__ A, const float* __restrict__ fcol,
                      const float* __restrict__ a,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ frow_out,
                      float* __restrict__ partial, int M, int N, int bm,
                      int rows_per_cta, float fi, int fi_one) {
  const int b = blockIdx.y;
  if (MASKED && mask[b] == 0) return;
  const int cta = blockIdx.x;
  const int R = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nvec = N / VEC;
  const int wpr = bm >= kWarps ? 1 : kWarps / bm;  // warps per row, phase 1

  extern __shared__ __align__(16) unsigned char smem[];
  float* colacc = reinterpret_cast<float*>(smem);  // N
  float* red = colacc + N;                         // bm * wpr
  float* frow_s = red + bm * wpr;                  // bm
  const size_t head = ((size_t)(N + bm * wpr + bm) * 4 + 15) / 16 * 16;
  T* tile = reinterpret_cast<T*>(smem + head);     // bm * N (ONEPASS)

  T* Ab = A + (size_t)b * M * N;
  const float* fb = fcol + (size_t)b * N;
  const float* ab = a + (size_t)b * M;

  // colacc[v*VEC .. +VEC) is touched only by thread v % kThreads, here,
  // in phase 2 and in the final store: no barrier guards it.
  for (int v = tid; v < nvec; v += kThreads) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) colacc[v * VEC + k] = 0.f;
  }

  const int row_lo = cta * rows_per_cta;
  const int row_hi = min(M, row_lo + rows_per_cta);
  for (int r0 = row_lo; r0 < row_hi; r0 += bm) {
    const int nrows = min(bm, row_hi - r0);
    // phase 1: row sums of A * fcol
    for (int slot = warp / wpr; slot < bm; slot += kWarps / wpr) {
      const int part = warp % wpr;
      float s = 0.f;
      if (slot < nrows) {
        const T* row = Ab + (size_t)(r0 + slot) * N;
#pragma unroll 4
        for (int v = part * 32 + lane; v < nvec; v += wpr * 32) {
          const typename Raw<T, VEC>::type raw = load_raw<T, VEC>(row + (size_t)v * VEC);
          if constexpr (ONEPASS)
            store_raw<T, VEC>(tile + (size_t)slot * N + (size_t)v * VEC, raw);
          float x[VEC], f[VEC];
          to_floats<T, VEC>(raw, x);
          load_f32<VEC>(fb + (size_t)v * VEC, f);
#pragma unroll
          for (int k = 0; k < VEC; ++k) s = __fadd_rn(s, __fmul_rn(x[k], f[k]));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0) red[slot * wpr + part] = s;
    }
    __syncthreads();
    if (tid < nrows) {
      float rs = 0.f;
      for (int p = 0; p < wpr; ++p) rs = __fadd_rn(rs, red[tid * wpr + p]);
      const float f = safe_pow(ab[r0 + tid], rs, fi, fi_one);
      frow_s[tid] = f;
      if constexpr (MASKED) frow_out[(size_t)b * M + r0 + tid] = f;
    }
    __syncthreads();
    // phase 2: scale, store in place, accumulate the column partials
    for (int v = tid; v < nvec; v += kThreads) {
      float f[VEC], acc[VEC];
      load_f32<VEC>(fb + (size_t)v * VEC, f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = colacc[v * VEC + k];
      for (int r = 0; r < nrows; ++r) {
        T* p = Ab + (size_t)(r0 + r) * N + (size_t)v * VEC;
        typename Raw<T, VEC>::type raw;
        if constexpr (ONEPASS)
          raw = load_raw<T, VEC>(tile + (size_t)r * N + (size_t)v * VEC);
        else
          raw = load_raw<T, VEC>(p);
        float x[VEC], y[VEC];
        to_floats<T, VEC>(raw, x);
        const float fr = frow_s[r];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          y[k] = __fmul_rn(__fmul_rn(x[k], f[k]), fr);
          acc[k] = __fadd_rn(acc[k], y[k]);
        }
        store_raw<T, VEC>(p, from_floats<T, VEC>(y));
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) colacc[v * VEC + k] = acc[k];
    }
    __syncthreads();  // tile, red and frow_s are reused by the next rows
  }
  float* out = partial + ((size_t)b * R + cta) * N;
  for (int v = tid; v < nvec; v += kThreads) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      out[(size_t)v * VEC + k] = colacc[v * VEC + k];
  }
}

inline size_t fused_smem_bytes(int N, int bm, int itemsize, int one_pass) {
  const int wpr = bm >= kWarps ? 1 : kWarps / bm;
  const size_t head = ((size_t)(N + bm * wpr + bm) * 4 + 15) / 16 * 16;
  return head + (one_pass ? (size_t)bm * N * itemsize : 0);
}

template <typename T, int VEC, bool MASKED, bool ONEPASS>
int launch_fused(void* A, const float* fcol, const float* a,
                 const uint8_t* mask, float* colsum, float* frow,
                 float* partial, int B, int M, int N, int bm,
                 int rows_per_cta, int R, float fi, int fi_one,
                 cudaStream_t stream) {
  auto kern = fused_iter_kernel<T, VEC, MASKED, ONEPASS>;
  const size_t smem = fused_smem_bytes(N, bm, sizeof(T), ONEPASS);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(R, B), kThreads, smem, stream>>>(
      static_cast<T*>(A), fcol, a, mask, frow, partial, M, N, bm,
      rows_per_cta, fi, fi_one);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce(partial, colsum, mask, B, R, N, stream);
}

template <typename T, int VEC>
int dispatch_fused(void* A, const float* fcol, const float* a,
                   const uint8_t* mask, float* colsum, float* frow,
                   float* partial, int B, int M, int N, int bm,
                   int rows_per_cta, int R, int one_pass, float fi,
                   int fi_one, cudaStream_t stream) {
#define UOT_FUSED(MK, OP)                                                    \
  return launch_fused<T, VEC, MK, OP>(A, fcol, a, mask, colsum, frow,        \
                                      partial, B, M, N, bm, rows_per_cta, R, \
                                      fi, fi_one, stream)
  if (mask != nullptr) {
    if (one_pass) UOT_FUSED(true, true);
    UOT_FUSED(true, false);
  }
  if (one_pass) UOT_FUSED(false, true);
  UOT_FUSED(false, false);
#undef UOT_FUSED
}

// Checked entry of the streamed pass for the extern "C" launchers: the
// row plan must cover M, bm be a power of two dividing rows_per_cta, and
// the vector width one the storage type has.
inline int fused_iteration_checked(void* A, const float* fcol,
                                   const float* a, const uint8_t* mask,
                                   float* colsum, float* frow,
                                   float* partial, int B, int M, int N,
                                   int dtype, int vec, int bm,
                                   int rows_per_cta, int R, int one_pass,
                                   float fi, int fi_one, void* stream) {
  if (!valid_grid(B, M, N, rows_per_cta, R)) return -1;
  if (bm <= 0 || (bm & (bm - 1)) != 0 || rows_per_cta % bm != 0) return -3;
  if (mask != nullptr && frow == nullptr) return -4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UOT_DISPATCH(T, V)                                                 \
  return dispatch_fused<T, V>(A, fcol, a, mask, colsum, frow, partial, B, \
                              M, N, bm, rows_per_cta, R, one_pass, fi,    \
                              fi_one, s)
  if (dtype == 0 && vec == 1) UOT_DISPATCH(float, 1);
  if (dtype == 0 && vec == 4 && N % 4 == 0) UOT_DISPATCH(float, 4);
  if (dtype == 1 && vec == 1) UOT_DISPATCH(__nv_bfloat16, 1);
  if (dtype == 1 && vec == 8 && N % 8 == 0) UOT_DISPATCH(__nv_bfloat16, 8);
#undef UOT_DISPATCH
  return -2;
}

}  // namespace
