// Resident MAP-UOT kernels for Hopper (sm_90a): kernels f and g of the
// port, behind ops.solve_fused_resident and ops.solve_fused_stepped_resident
// (impl='auto' / 'resident'). Built and bound like uot_batched.cu (see
// there); the launchers return cudaGetLastError(), or a negative code for
// arguments they do not take.
//
// One block per lane. The block loads its lane's whole coupling from device
// memory ONCE, upcast to fp32 into dynamic shared memory, runs the
// Algorithm-1 loop there, and stores the result ONCE, rounded to the
// storage dtype: device-memory traffic is M*N*s in + M*N*s out per solve
// (kernel f) or per chunk (kernel g), not per iteration.
//
// What the TPU kernels relied on, and what replaces it here:
//  * VMEM budget. The TPU tier kept in + out tiles (double-buffered) and an
//    fp32 working copy in a 32 MiB budget (ops.py:224-282), about 2M fp32
//    elements. One Hopper block has 227 KB of shared memory, and only the
//    fp32 working tile lives there (the storage tile is read from and
//    written to device memory directly), plus four O(M + N) vectors and a
//    32-float reduction scratch: resident_smem_bytes below, mirrored by
//    ops.resident_fits. That is about 50k elements (128x384 fits, 256x256
//    does not), the same for fp32 and bf16 storage.
//  * Sequential grid steps. The lanes are independent blocks; a lane whose
//    loop ends early frees its SM for the next lane, so no lane waits for
//    the slowest one.
//  * Reductions. Row sums are a warp per row (a fixed xor butterfly) and
//    column sums a thread per column adding the rows in order, all with
//    __fmul_rn / __fadd_rn: a launch repeats bit for bit.
//
// Bound, per lane and iteration: 4 fp32 operations per element (a product
// and a sum in phase II, again in phase IV) and O(M + N) for the factors
// and the drift, against 2*M*N*s bytes per solve, so from about 40
// iterations (fp32 storage; 20 bf16) the operations bound at 67 TFLOP/s
// is the larger. __fmul_rn / __fadd_rn never contract to an FMA, so the
// instructions issue at half that rate at best. In practice one SM's
// shared-memory traffic (each element is read and written twice an
// iteration) is what limits a lane.
//
// Known limit: one block per lane leaves most of the card idle at small
// batches (8 lanes fill 8 of 132 SMs). A thread-block-cluster variant that
// spreads a tile over several SMs and shares column sums through
// distributed shared memory would widen both the occupancy and the
// resident shape range.

#include "uot_common.cuh"

namespace {

constexpr int kResThreads = 1024;
constexpr int kResWarps = kResThreads / 32;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory per block

// Shared memory of one lane, in floats: tile M*N | colsum (or fcol) N |
// b N | frow M | a M | reduction scratch kResWarps.
inline size_t resident_smem_bytes(int M, int N) {
  return 4 * ((size_t)M * N + 2 * (size_t)M + 2 * (size_t)N + kResWarps);
}

struct Resident {
  float* tile;
  float* cs;
  float* bs;
  float* fr;
  float* as;
  float* red;
};

__device__ __forceinline__ Resident carve(float* sm, int M, int N) {
  Resident r;
  r.tile = sm;
  r.cs = r.tile + (size_t)M * N;
  r.bs = r.cs + N;
  r.fr = r.bs + N;
  r.as = r.fr + M;
  r.red = r.as + M;
  return r;
}

// max that keeps a NaN, as jnp.max does (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float x, float y) {
  return (y > x || y != y) ? y : x;
}

// Load one lane's storage tile into shared memory as fp32, with its
// marginals. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void load_lane(const Resident& s, const T* A,
                                          const float* a, const float* b,
                                          int M, int N) {
  const size_t mn = (size_t)M * N;
  for (size_t i = threadIdx.x; i < mn; i += kResThreads)
    s.tile[i] = to_f(A[i]);
  for (int n = threadIdx.x; n < N; n += kResThreads) s.bs[n] = b[n];
  for (int m = threadIdx.x; m < M; m += kResThreads) s.as[m] = a[m];
  __syncthreads();
}

// Store the fp32 tile back, rounded once to the storage dtype. Begins with
// a barrier.
template <typename T>
__device__ __forceinline__ void store_lane(const Resident& s, T* A, int M,
                                           int N) {
  __syncthreads();
  const size_t mn = (size_t)M * N;
  for (size_t i = threadIdx.x; i < mn; i += kResThreads)
    A[i] = from_f<T>(s.tile[i]);
}

// One Algorithm-1 iteration on the resident tile (uot_resident.py:80-91),
// in place. On entry s.cs holds the carried column sums and s.fr the
// previous row factors; on exit s.cs holds the next column sums and s.fr
// this iteration's row factors. Returns the drift max|frow - prev|, the
// same value in every thread, so loop conditions on it are uniform.
// Thread n (mod kResThreads) owns cs[n] in phases I and IV, so no barrier
// is needed between the end of one iteration and the start of the next.
__device__ __forceinline__ float resident_iteration(const Resident& s, int M,
                                                    int N, float fi,
                                                    int fi_one) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // I: column factors, in place over the carried sums
  for (int n = tid; n < N; n += kResThreads)
    s.cs[n] = safe_pow(s.bs[n], s.cs[n], fi, fi_one);
  __syncthreads();
  // I + II: column rescale and row sums, a warp per row; row factors and
  // the drift against the previous ones
  float drift = 0.f;
  for (int r = warp; r < M; r += kResWarps) {
    float* row = s.tile + (size_t)r * N;
    float sum = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float x = __fmul_rn(row[n], s.cs[n]);
      row[n] = x;
      sum = __fadd_rn(sum, x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    const float f = safe_pow(s.as[r], sum, fi, fi_one);
    drift = nan_max(drift, fabsf(f - s.fr[r]));
    __syncwarp();
    if (lane == 0) s.fr[r] = f;
  }
  if (lane == 0) s.red[warp] = drift;
  __syncthreads();
  // III + IV: row rescale and the next column sums, a thread per column
  // adding the rows in order
  for (int n = tid; n < N; n += kResThreads) {
    float* p = s.tile + n;
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < M; ++r, p += N) {
      const float y = __fmul_rn(*p, s.fr[r]);
      *p = y;
      acc = __fadd_rn(acc, y);
    }
    s.cs[n] = acc;
  }
  float err = s.red[0];
  for (int w = 1; w < kResWarps; ++w) err = nan_max(err, s.red[w]);
  return err;
}

// ---------------------------------------------------------------------------
// Kernel f: the whole solve of each lane, in place on A (B, M, N).
// Replaces src/repro/kernels/uot_resident.py:140 resident_solve
// (pallas_call :160). Per lane: initial column sums from the upcast tile
// (uot_resident.py:93), then iterations while it < num_iters and, with a
// tolerance, err > tol (:102-111); a fixed count without one.
template <typename T>
__global__ void __launch_bounds__(kResThreads, 1)
    resident_solve_kernel(T* __restrict__ A, const float* __restrict__ a,
                          const float* __restrict__ b,
                          float* __restrict__ colsum, int* __restrict__ iters,
                          float* __restrict__ err_out, int M, int N,
                          float fi, int fi_one, int num_iters, float tol,
                          int has_tol) {
  extern __shared__ float smem_f[];
  const int l = blockIdx.x;
  const Resident s = carve(smem_f, M, N);
  T* Al = A + (size_t)l * M * N;
  load_lane<T>(s, Al, a + (size_t)l * M, b + (size_t)l * N, M, N);
  for (int m = threadIdx.x; m < M; m += kResThreads) s.fr[m] = 1.f;
  // Algorithm-1 preprocessing: column sums of the upcast tile, a thread
  // per column (the owner of cs[n] in the loop), rows in order
  for (int n = threadIdx.x; n < N; n += kResThreads) {
    float acc = 0.f;
    for (int r = 0; r < M; ++r) acc = __fadd_rn(acc, s.tile[(size_t)r * N + n]);
    s.cs[n] = acc;
  }
  int it = 0;
  float err = __int_as_float(0x7f800000);  // +inf
  while (it < num_iters && (!has_tol || err > tol)) {
    err = resident_iteration(s, M, N, fi, fi_one);
    ++it;
  }
  store_lane<T>(s, Al, M, N);
  for (int n = threadIdx.x; n < N; n += kResThreads)
    colsum[(size_t)l * N + n] = s.cs[n];
  if (threadIdx.x == 0) {
    iters[l] = it;
    err_out[l] = err;
  }
}

// ---------------------------------------------------------------------------
// Kernel g: advance each lane of a LaneState pool by up to n_iters
// iterations, in place on P, colsum, frow, iters and conv.
// Replaces src/repro/kernels/uot_resident.py:383 resident_stepped
// (pallas_call :413). The reference's per-lane gate (:348-362) is the loop
// condition: active, not converged, it < num_iters, k < n_iters. A lane
// whose gate is closed on entry returns at once, so its tile, colsum,
// frow and iters stay untouched bit for bit. Sub-fp32 storage is rounded
// once per chunk.
template <typename T>
__global__ void __launch_bounds__(kResThreads, 1)
    resident_stepped_kernel(T* __restrict__ P, float* __restrict__ colsum,
                            float* __restrict__ frow, int* __restrict__ iters,
                            uint8_t* __restrict__ conv,
                            const uint8_t* __restrict__ active,
                            const float* __restrict__ a,
                            const float* __restrict__ b, int M, int N,
                            float fi, int fi_one, int n_iters, int num_iters,
                            float tol, int has_tol) {
  const int l = blockIdx.x;
  int it = iters[l];
  if (active[l] == 0 || conv[l] != 0 || it >= num_iters || n_iters <= 0)
    return;
  extern __shared__ float smem_g[];
  const Resident s = carve(smem_g, M, N);
  T* Pl = P + (size_t)l * M * N;
  float* csl = colsum + (size_t)l * N;
  float* frl = frow + (size_t)l * M;
  for (int n = threadIdx.x; n < N; n += kResThreads) s.cs[n] = csl[n];
  for (int m = threadIdx.x; m < M; m += kResThreads) s.fr[m] = frl[m];
  load_lane<T>(s, Pl, a + (size_t)l * M, b + (size_t)l * N, M, N);
  int k = 0;
  bool done = false;
  while (k < n_iters && !done && it < num_iters) {
    const float d = resident_iteration(s, M, N, fi, fi_one);
    ++it;
    ++k;
    if (has_tol) done = d <= tol;
  }
  store_lane<T>(s, Pl, M, N);
  for (int n = threadIdx.x; n < N; n += kResThreads) csl[n] = s.cs[n];
  for (int m = threadIdx.x; m < M; m += kResThreads) frl[m] = s.fr[m];
  if (threadIdx.x == 0) {
    iters[l] = it;
    conv[l] = done ? 1 : 0;
  }
}

bool valid_lanes(int B, int M, int N) {
  return B > 0 && M > 0 && N > 0 && resident_smem_bytes(M, N) <= kSmemLimit;
}

template <typename K>
int set_smem(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_solve(void* A, const float* a, const float* b, float* colsum,
                 int* iters, float* err, int B, int M, int N, float fi,
                 int fi_one, int num_iters, float tol, int has_tol,
                 cudaStream_t stream) {
  const size_t smem = resident_smem_bytes(M, N);
  auto kern = resident_solve_kernel<T>;
  const int e = set_smem(kern, smem);
  if (e != 0) return e;
  kern<<<B, kResThreads, smem, stream>>>(static_cast<T*>(A), a, b, colsum,
                                         iters, err, M, N, fi, fi_one,
                                         num_iters, tol, has_tol);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stepped(void* P, float* colsum, float* frow, int* iters,
                   uint8_t* conv, const uint8_t* active, const float* a,
                   const float* b, int L, int M, int N, float fi, int fi_one,
                   int n_iters, int num_iters, float tol, int has_tol,
                   cudaStream_t stream) {
  const size_t smem = resident_smem_bytes(M, N);
  auto kern = resident_stepped_kernel<T>;
  const int e = set_smem(kern, smem);
  if (e != 0) return e;
  kern<<<L, kResThreads, smem, stream>>>(
      static_cast<T*>(P), colsum, frow, iters, conv, active, a, b, M, N, fi,
      fi_one, n_iters, num_iters, tol, has_tol);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one lane needs, in bytes (ops.resident_fits mirrors it).
extern "C" long long uot_resident_smem_bytes(int M, int N) {
  return (long long)resident_smem_bytes(M, N);
}

// Kernel f. A (B, M, N) fp32 (dtype 0) or bf16 (dtype 1), overwritten with
// the solution; a (B, M), b (B, N) fp32; out: colsum (B, N) fp32, iters
// (B,) int32, err (B,) fp32. has_tol == 0 runs exactly num_iters
// iterations. Returns -1 for shapes whose lane does not fit one block's
// shared memory, -2 for an unknown dtype.
extern "C" int uot_resident_solve(void* A, const float* a, const float* b,
                                  float* colsum, int* iters, float* err,
                                  int B, int M, int N, int dtype, float fi,
                                  int fi_one, int num_iters, float tol,
                                  int has_tol, void* stream) {
  if (!valid_lanes(B, M, N) || num_iters < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_solve<float>(A, a, b, colsum, iters, err, B, M, N, fi,
                               fi_one, num_iters, tol, has_tol, s);
  if (dtype == 1)
    return launch_solve<__nv_bfloat16>(A, a, b, colsum, iters, err, B, M, N,
                                       fi, fi_one, num_iters, tol, has_tol,
                                       s);
  return -2;
}

// Kernel g. P (L, M, N) fp32 or bf16, colsum (L, N) and frow (L, M) fp32,
// iters (L,) int32 and conv (L,) uint8 are updated in place for the lanes
// whose gate is open; active (L,) uint8, a (L, M), b (L, N) fp32 are read.
extern "C" int uot_resident_stepped(void* P, float* colsum, float* frow,
                                    int* iters, uint8_t* conv,
                                    const uint8_t* active, const float* a,
                                    const float* b, int L, int M, int N,
                                    int dtype, float fi, int fi_one,
                                    int n_iters, int num_iters, float tol,
                                    int has_tol, void* stream) {
  if (!valid_lanes(L, M, N)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_stepped<float>(P, colsum, frow, iters, conv, active, a, b,
                                 L, M, N, fi, fi_one, n_iters, num_iters, tol,
                                 has_tol, s);
  if (dtype == 1)
    return launch_stepped<__nv_bfloat16>(P, colsum, frow, iters, conv,
                                         active, a, b, L, M, N, fi, fi_one,
                                         n_iters, num_iters, tol, has_tol, s);
  return -2;
}
