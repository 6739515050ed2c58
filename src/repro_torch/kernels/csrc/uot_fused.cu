// Single-problem MAP-UOT kernels for Hopper (sm_90a): kernels a and b of
// the port, behind ops.solve_fused. Built and bound like uot_batched.cu
// (see there); the launchers return cudaGetLastError(), or a negative code
// for arguments they do not take.
//
// Both are the single-problem instantiation (B = 1) of the streamed
// kernels in uot_stream.cuh, which kernels c, d and e run over a stack.
// One problem has no batch dimension to fill the card with, so the grids
// are cut from the problem's own rows (and, for a, its columns): the
// wrapper's plan (uot_batched.plan_colsum, plan_for at B = 1) aims at one
// wave over 132 SMs.

#include "uot_stream.cuh"

// Kernel a: column sums of one (M, N) problem, (N,) fp32. Replaces
// src/repro/kernels/uot_fused.py:132 colsum (pallas_call :136), whose
// single VMEM accumulator is revisited by sequential grid steps; here
// colsum_partial_kernel's blocks write partial sums that a second launch
// adds in a fixed order. Bound: bytes, M*N*s read once.
// dtype: 0 = float32, 1 = bfloat16. vec: 1, or 16 bytes / itemsize (then
// N is a multiple of vec and the tensors are 16-byte aligned, which the
// wrapper checks). partial: (R, N) fp32 scratch; out: (N,) fp32.
extern "C" int uot_fused_colsum(const void* A, float* partial, float* out,
                                int M, int N, int dtype, int vec,
                                int rows_per_cta, int R, void* stream) {
  return colsum_checked(A, partial, out, 1, M, N, dtype, vec, rows_per_cta,
                        R, stream);
}

// Kernel b: one Algorithm-1 pass over one (M, N) problem, in place, with
// the next column sums (N,). Replaces src/repro/kernels/uot_fused.py:83
// fused_iteration (pallas_call :98). The device code is the single-problem
// instantiation (B = 1, no lane mask) of fused_iter_kernel in
// uot_stream.cuh: row blocks of rows_per_cta rows spread over the SMs,
// per-block partial column sums reduced in a fixed order (no atomics).
// Bound: bytes, 2*M*N*s + O(M+N) per iteration.
extern "C" int uot_fused_iteration(void* A, const float* fcol,
                                   const float* a, float* colsum,
                                   float* partial, int M, int N, int dtype,
                                   int vec, int bm, int rows_per_cta, int R,
                                   int one_pass, float fi, int fi_one,
                                   void* stream) {
  return fused_iteration_checked(A, fcol, a, nullptr, colsum, nullptr,
                                 partial, 1, M, N, dtype, vec, bm,
                                 rows_per_cta, R, one_pass, fi, fi_one,
                                 stream);
}
