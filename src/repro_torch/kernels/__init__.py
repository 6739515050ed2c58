"""Hand-written Hopper kernels of the port and the solvers built on them.

CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use by ``_build``
and bound with ctypes, each kernel beside its plain PyTorch version:

* ``uot_fused`` — kernels a (``colsum``) and b (``fused_iteration``), one
  problem streamed (``csrc/uot_fused.cu``);
* ``uot_batched`` — kernels c (``batched_colsum``), d
  (``batched_fused_iteration``) and e (``batched_fused_iteration_frow``),
  a stack or a lane pool streamed (``csrc/uot_batched.cu``);
* ``uot_resident`` — kernels f (``resident_solve``), g
  (``resident_stepped``) and k (``resident_solve_pc``), each lane's tile
  resident in one block's shared memory (``csrc/uot_resident.cu``);
* ``uot_geometry`` — kernels h (``batched_pc_colsum``), i
  (``batched_pc_first_iteration``) and j (``batched_pc_materialize``), the
  Gibbs tile of a point cloud computed from its coordinates
  (``csrc/uot_geometry.cu``, the tile function in ``csrc/uot_gibbs.cuh``);
* ``uot_uv_fused`` — kernels l (``uv_iteration``) and m
  (``materialize_coupling``) of the u/v potential form, one problem
  (``csrc/uot_uv_fused.cu``); their stack forms n
  (``batched_uv_iteration``) and o (``batched_materialize_coupling``) are
  in ``uot_batched``.

``ops`` holds the single-problem, batched, bucketed, resident and stepped
solvers, their ``geometry=`` paths, the ``impl='auto'`` dispatch and the
u/v solvers; ``ref`` the plain oracles.
"""
from repro_torch.kernels import (ops, ref, uot_batched, uot_fused,
                                 uot_geometry, uot_resident, uot_uv_fused)

__all__ = ["ops", "ref", "uot_batched", "uot_fused", "uot_geometry",
           "uot_resident", "uot_uv_fused"]
