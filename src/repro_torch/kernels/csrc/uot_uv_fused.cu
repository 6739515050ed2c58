// The u/v potential form's single-problem kernels for Hopper (sm_90a):
// kernels l and m of the port, behind ops.solve_uv. Built and bound like
// uot_batched.cu (see there); the launchers return cudaGetLastError(), or a
// negative code for arguments they do not take.
//
// Both are the single-problem instantiation (B = 1) of the stack kernels n
// and o in uot_stream.cuh, as kernels a and b are of c and d: the u/v pass
// is the streamed Algorithm-1 pass in its read-only UV mode, on the plan of
// kernel b (uot_batched.plan_for at B = 1, one wave over 132 SMs).

#include "uot_stream.cuh"

// Kernel l: one u/v iteration's matrix work in a single read of K (M, N):
// u = safe_pow(a, K v, fi) (M,) and K^T u (N,), both fp32. Replaces
// src/repro/kernels/uot_uv_fused.py:52 uv_iteration (pallas_call :61, body
// :32-48), whose K^T u accumulator is one VMEM block revisited by
// sequential grid steps; here each block writes partial column sums that a
// second launch adds in a fixed order (no atomics, the same bits on every
// run). Bound: bytes, M*N*s read once + O(M+N); K is never written.
// dtype: 0 = float32, 1 = bfloat16; vec: 1, or 16 bytes / itemsize (N a
// multiple of vec, the tensors 16-byte aligned, which the wrapper checks).
// partial: (R, N) fp32 scratch.
extern "C" int uot_uv_iteration(const void* K, const float* v,
                                const float* a, float* u, float* ktu,
                                float* partial, int M, int N, int dtype,
                                int vec, int bm, int rows_per_cta, int R,
                                int one_pass, float fi, int fi_one,
                                void* stream) {
  return uv_iteration_checked(K, v, a, u, ktu, partial, 1, M, N, dtype, vec,
                              bm, rows_per_cta, R, one_pass, fi, fi_one,
                              stream);
}

// Kernel m: P = (K * u[:, None]) * v[None, :] for one (M, N) problem, in
// out_dtype (0 = float32, 1 = bfloat16). Replaces
// src/repro/kernels/uot_uv_fused.py:90 materialize_coupling (pallas_call
// :96, body :82-87). Elementwise, the two products rounded in that order,
// so the result equals the plain version bit for bit. Bound: bytes, M*N*s
// read + M*N*s_out written.
extern "C" int uot_materialize_coupling(const void* K, const float* u,
                                        const float* v, void* P, int M,
                                        int N, int dtype, int out_dtype,
                                        int vec, int num_sms, void* stream) {
  return materialize_checked(K, u, v, P, 1, M, N, dtype, out_dtype, vec,
                             num_sms, stream);
}
