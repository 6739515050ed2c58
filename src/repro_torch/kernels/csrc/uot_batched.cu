// Batched MAP-UOT kernels for Hopper (sm_90a): kernels c, d and e of the
// port, and kernels n and o of the u/v potential form. Built by
// repro_torch/kernels/_build.py (one nvcc per source, all linked into one
// shared library) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -Xcompiler -fPIC
// and bound with ctypes through the extern "C" launchers at the bottom.
// Each launcher runs on the caller's stream, allocates nothing (the Python
// wrapper passes outputs and scratch) and returns cudaGetLastError(), or a
// negative code for arguments it does not take.
//
// Storage is fp32 or bf16; every sum and factor is fp32. A bf16 value is
// upcast once on load and downcast once on store. The device code of c, d,
// e, n and o (and of kernels a, b, l and m, their B = 1 calls) is in
// uot_stream.cuh, with the notes on column sums across blocks, one-pass and
// two-pass rows, and ragged edges.

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

// Kernel n: the read-only u/v pass over a stack — the fused_iter_kernel of
// uot_stream.cuh in its UV mode, on the plan of kernel d. Replaces
// src/repro/kernels/uot_batched.py:230 batched_uv_iteration (pallas_call
// :239). K (B, M, N) fp32 or bf16, read only; v (B, N) and a (B, M) fp32;
// writes u (B, M) and K^T u (B, N) fp32 (partial: (B, R, N) scratch, summed
// in a fixed order). Bound: bytes, B*M*N*s read once per iteration.
extern "C" int uot_batched_uv_iteration(const void* K, const float* v,
                                        const float* a, float* u,
                                        float* ktu, float* partial, int B,
                                        int M, int N, int dtype, int vec,
                                        int bm, int rows_per_cta, int R,
                                        int one_pass, float fi, int fi_one,
                                        void* stream) {
  return uv_iteration_checked(K, v, a, u, ktu, partial, B, M, N, dtype, vec,
                              bm, rows_per_cta, R, one_pass, fi, fi_one,
                              stream);
}

// Kernel o: P = (K * u[:, None]) * v[None, :] for every problem of a stack
// — materialize_kernel of uot_stream.cuh. Replaces
// src/repro/kernels/uot_batched.py:268 batched_materialize_coupling
// (pallas_call :274). K (B, M, N) fp32 or bf16 (dtype 0 / 1); u (B, M), v
// (B, N) fp32; P (B, M, N) in out_dtype (0 = float32, 1 = bfloat16). Bound:
// bytes, K read once and P written once.
extern "C" int uot_batched_materialize_coupling(const void* K, const float* u,
                                                const float* v, void* P,
                                                int B, int M, int N,
                                                int dtype, int out_dtype,
                                                int vec, int num_sms,
                                                void* stream) {
  return materialize_checked(K, u, v, P, B, M, N, dtype, out_dtype, vec,
                             num_sms, stream);
}

// Defined here once for the whole library.
extern "C" const char* uot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
