"""UOT core semantics (PyTorch port of ``repro.core``): the problem and
config, the plain solvers the kernels are held to, the log-domain
containment tier, admission health checks, and the iteration predictor."""
from repro_torch.core.problem import (UOTConfig, UOTProblem, gibbs_kernel,
                                      rescale_factors, uot_cost)
from repro_torch.core.sinkhorn_baseline import sinkhorn_uot_baseline
from repro_torch.core.sinkhorn_fused import (sinkhorn_uot_fused,
                                             sinkhorn_uot_fused_batched)
from repro_torch.core.log_domain import sinkhorn_uot_log
from repro_torch.core.convergence import lane_factor_drift
from repro_torch.core.health import (InvalidProblemError, escalate_log_solve,
                                     escalation_config, uv_amplification_log,
                                     uv_safe, validate_problem)
from repro_torch.core.predict import IterPredictor, analytic_iters

__all__ = [
    "UOTConfig", "UOTProblem", "gibbs_kernel", "rescale_factors", "uot_cost",
    "sinkhorn_uot_baseline", "sinkhorn_uot_fused",
    "sinkhorn_uot_fused_batched", "sinkhorn_uot_log", "lane_factor_drift",
    "InvalidProblemError", "escalate_log_solve", "escalation_config",
    "uv_amplification_log", "uv_safe", "validate_problem", "IterPredictor",
    "analytic_iters",
]
