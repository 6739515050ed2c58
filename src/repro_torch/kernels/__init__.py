"""Hand-written Hopper kernels of the port and the solvers built on them.

``uot_batched`` holds kernels c (``batched_colsum``), d
(``batched_fused_iteration``) and e (``batched_fused_iteration_frow``):
CUDA C++ for ``sm_90a`` in ``csrc/uot_batched.cu``, built at first use by
``_build`` and bound with ctypes, each beside its plain PyTorch version.
``ops`` holds the batched, bucketed and stepped solvers; ``ref`` the
plain oracles.
"""
from repro_torch.kernels import ops, ref, uot_batched

__all__ = ["ops", "ref", "uot_batched"]
