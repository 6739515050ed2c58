// Batched MAP-UOT kernels for Hopper (sm_90a): kernels c, d and e of the
// port. Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" launchers at the bottom.
// Each launcher runs on the caller's stream, allocates nothing (the Python
// wrapper passes outputs and scratch) and returns cudaGetLastError(), or a
// negative code for arguments it does not take.
//
// Storage is fp32 or bf16; every sum and factor is fp32. A bf16 value is
// upcast once on load and downcast once on store.
//
// Column sums across blocks. The TPU kernels carry each problem's column
// sums in one VMEM block that sequential grid steps revisit
// (uot_batched.py:57-61, :123-127, :184-189). CUDA blocks run concurrently
// and in no order, so here each block owns `rows_per_cta` rows of one
// problem and writes its own partial column sums (B, R, N); a second small
// launch sums the R partials of each column in row-block order. No float
// atomics: the result is the same bits on every run.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Raw storage of one vector: a 16-byte uint4, or one element.
template <typename T, int VEC> struct Raw { using type = uint4; };
template <typename T> struct Raw<T, 1> { using type = T; };

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, VEC>::type*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_raw(T* p,
                                          typename Raw<T, VEC>::type r) {
  *reinterpret_cast<typename Raw<T, VEC>::type*>(p) = r;
}

template <typename T, int VEC>
__device__ __forceinline__ void to_floats(typename Raw<T, VEC>::type r,
                                          float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_f(r);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) x[k] = to_f(e[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type from_floats(
    const float (&y)[VEC]) {
  typename Raw<T, VEC>::type r;
  if constexpr (VEC == 1) {
    r = from_f<T>(y[0]);
  } else {
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_f<T>(y[k]);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) x[k] = p[k];
}

// (target / sums) ** fi with 0-sums mapped to 1; matches uot_fused.py:47-53
// (a sum that is not > 0, NaN included, gives factor 1; fi == 1 skips pow).
__device__ __forceinline__ float safe_pow(float t, float s, float fi,
                                          int fi_one) {
  if (!(s > 0.f)) return 1.f;
  const float r = __fdiv_rn(t, s);
  return fi_one ? r : powf(r, fi);
}

// ---------------------------------------------------------------------------
// Kernel c: per-problem column sums, (B, M, N) -> partials (B, R, N).
// Replaces src/repro/kernels/uot_batched.py:194 batched_colsum.
// Bound: bytes, B*M*N*s read once. Each thread owns VEC columns and walks
// the block's rows, four loads in flight, in row order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    colsum_partial_kernel(const T* __restrict__ A, float* __restrict__ partial,
                          int M, int N, int rows_per_cta) {
  const int b = blockIdx.y;
  const int cta = blockIdx.x;
  const int R = gridDim.x;
  const int row_lo = cta * rows_per_cta;
  const int row_hi = min(M, row_lo + rows_per_cta);
  const int nvec = N / VEC;
  const T* Ab = A + (size_t)b * M * N;
  float* out = partial + ((size_t)b * R + cta) * N;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    const T* p = Ab + (size_t)row_lo * N + (size_t)v * VEC;
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
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[(size_t)v * VEC + k] = acc[k];
  }
}

// Sum the R row-block partials of each column in order: (B, R, N) -> (B, N).
// With a lane mask, frozen lanes keep the column sums they carried.
__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ partial,
                           float* __restrict__ out,
                           const uint8_t* __restrict__ mask, int R, int N) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  if (mask != nullptr && mask[b] == 0) return;
  const float* p = partial + (size_t)b * R * N + n;
  float s = 0.f;
#pragma unroll 8
  for (int r = 0; r < R; ++r) s += p[(size_t)r * N];
  out[(size_t)b * N + n] = s;
}

// ---------------------------------------------------------------------------
// Kernels d and e: one Algorithm-1 pass over a stack, in place.
// Replace src/repro/kernels/uot_batched.py:66 batched_fused_iteration (d,
// MASKED=false) and :132 batched_fused_iteration_frow (e, MASKED=true).
// Per block, for each sub-block of bm rows:
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

size_t fused_smem_bytes(int N, int bm, int itemsize, int one_pass) {
  const int wpr = bm >= kWarps ? 1 : kWarps / bm;
  const size_t head = ((size_t)(N + bm * wpr + bm) * 4 + 15) / 16 * 16;
  return head + (one_pass ? (size_t)bm * N * itemsize : 0);
}

bool valid_grid(int B, int M, int N, int rows_per_cta, int R) {
  return B > 0 && M > 0 && N > 0 && rows_per_cta > 0 && R > 0 &&
         B <= 65535 && (size_t)R * rows_per_cta >= (size_t)M &&
         (size_t)(R - 1) * rows_per_cta < (size_t)M;
}

template <typename T, int VEC>
int launch_colsum(const void* A, float* partial, float* out, int B, int M,
                  int N, int rows_per_cta, int R, cudaStream_t stream) {
  colsum_partial_kernel<T, VEC><<<dim3(R, B), kThreads, 0, stream>>>(
      static_cast<const T*>(A), partial, M, N, rows_per_cta);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<dim3((N + kThreads - 1) / kThreads, B), kThreads,
                           0, stream>>>(partial, out, nullptr, R, N);
  return (int)cudaGetLastError();
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
  reduce_partials_kernel<<<dim3((N + kThreads - 1) / kThreads, B), kThreads,
                           0, stream>>>(partial, colsum, mask, R, N);
  return (int)cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: 1, or 16 bytes / itemsize (then
// N must be a multiple of vec and the tensors 16-byte aligned, which the
// wrapper checks). partial: (B, R, N) fp32 scratch; out: (B, N) fp32.
extern "C" int uot_batched_colsum(const void* A, float* partial, float* out,
                                  int B, int M, int N, int dtype, int vec,
                                  int rows_per_cta, int R, void* stream) {
  if (!valid_grid(B, M, N, rows_per_cta, R)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return launch_colsum<float, 1>(A, partial, out, B, M, N, rows_per_cta, R, s);
  if (dtype == 0 && vec == 4 && N % 4 == 0)
    return launch_colsum<float, 4>(A, partial, out, B, M, N, rows_per_cta, R, s);
  if (dtype == 1 && vec == 1)
    return launch_colsum<__nv_bfloat16, 1>(A, partial, out, B, M, N,
                                           rows_per_cta, R, s);
  if (dtype == 1 && vec == 8 && N % 8 == 0)
    return launch_colsum<__nv_bfloat16, 8>(A, partial, out, B, M, N,
                                           rows_per_cta, R, s);
  return -2;
}

// One Algorithm-1 pass, in place on A (B, M, N). mask == nullptr is kernel
// d (colsum (B, N) written for every lane, frow unused); a (B,) uint8 mask
// is kernel e (frow (B, M) written and colsum updated only for lanes with
// mask != 0). bm: rows per sub-block (a power of two); one_pass: stage the
// sub-block in shared memory.
extern "C" int uot_batched_fused_iteration(
    void* A, const float* fcol, const float* a, const uint8_t* mask,
    float* colsum, float* frow, float* partial, int B, int M, int N,
    int dtype, int vec, int bm, int rows_per_cta, int R, int one_pass,
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

extern "C" const char* uot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
