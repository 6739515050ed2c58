"""Hand-written Hopper kernels of the port and the solvers built on them.

CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use by ``_build``
and bound with ctypes, each kernel beside its plain PyTorch version:

* ``uot_fused`` — kernels a (``colsum``) and b (``fused_iteration``), one
  problem streamed (``csrc/uot_fused.cu``);
* ``uot_batched`` — kernels c (``batched_colsum``), d
  (``batched_fused_iteration``) and e (``batched_fused_iteration_frow``),
  a stack or a lane pool streamed (``csrc/uot_batched.cu``);
* ``uot_resident`` — kernels f (``resident_solve``) and g
  (``resident_stepped``), each lane's tile resident in one block's shared
  memory (``csrc/uot_resident.cu``).

``ops`` holds the single-problem, batched, bucketed, resident and stepped
solvers and the ``impl='auto'`` dispatch; ``ref`` the plain oracles.
"""
from repro_torch.kernels import ops, ref, uot_batched, uot_fused, uot_resident

__all__ = ["ops", "ref", "uot_batched", "uot_fused", "uot_resident"]
