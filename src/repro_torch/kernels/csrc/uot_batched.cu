// Batched MAP-UOT kernels for Hopper (sm_90a): kernels c, d and e of the
// port. Built by repro_torch/kernels/_build.py (one nvcc per source, all
// linked into one shared library) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" launchers at the bottom.
// Each launcher runs on the caller's stream, allocates nothing (the Python
// wrapper passes outputs and scratch) and returns cudaGetLastError(), or a
// negative code for arguments it does not take.
//
// Storage is fp32 or bf16; every sum and factor is fp32. A bf16 value is
// upcast once on load and downcast once on store. The device code of c, d
// and e (and of kernels a and b, their B = 1 calls) is in uot_stream.cuh,
// with the notes on column sums across blocks, one-pass and two-pass rows,
// and ragged edges.

#include "uot_stream.cuh"

// Kernel c: per-problem column sums, (B, M, N) -> (B, N) fp32 — the
// colsum_partial_kernel of uot_stream.cuh over the whole stack.
// Replaces src/repro/kernels/uot_batched.py:194 batched_colsum.
// dtype: 0 = float32, 1 = bfloat16. vec: 1, or 16 bytes / itemsize (then
// N must be a multiple of vec and the tensors 16-byte aligned, which the
// wrapper checks). partial: (B, R, N) fp32 scratch; out: (B, N) fp32.
extern "C" int uot_batched_colsum(const void* A, float* partial, float* out,
                                  int B, int M, int N, int dtype, int vec,
                                  int rows_per_cta, int R, void* stream) {
  return colsum_checked(A, partial, out, B, M, N, dtype, vec, rows_per_cta,
                        R, stream);
}

// Kernels d and e: one Algorithm-1 pass, in place on A (B, M, N) — the
// fused_iter_kernel of uot_stream.cuh. mask == nullptr is kernel d,
// replacing src/repro/kernels/uot_batched.py:66 batched_fused_iteration
// (colsum (B, N) written for every lane, frow unused); a (B,) uint8 mask is
// kernel e, replacing :132 batched_fused_iteration_frow (frow (B, M)
// written and colsum updated only for lanes with mask != 0). bm: rows per
// sub-block (a power of two); one_pass: stage the sub-block in shared
// memory.
extern "C" int uot_batched_fused_iteration(
    void* A, const float* fcol, const float* a, const uint8_t* mask,
    float* colsum, float* frow, float* partial, int B, int M, int N,
    int dtype, int vec, int bm, int rows_per_cta, int R, int one_pass,
    float fi, int fi_one, void* stream) {
  return fused_iteration_checked(A, fcol, a, mask, colsum, frow, partial, B,
                                 M, N, dtype, vec, bm, rows_per_cta, R,
                                 one_pass, fi, fi_one, stream);
}

// Defined here once for the whole library.
extern "C" const char* uot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
