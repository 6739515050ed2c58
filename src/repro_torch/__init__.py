"""MAP-UOT on PyTorch and CUDA (NVIDIA Hopper): the port of ``repro``.

Subpackages mirror the JAX reference: ``core`` (problem, plain solvers,
health, predictor), ``kernels`` (hand-written CUDA kernels, their plain
versions, and the batched / bucketed / stepped solvers), ``obs``
(registry, tracer, phase timer) and ``serve`` (``UOTBatchEngine``,
``UOTScheduler``). ``convert`` carries configs and lane pools across from
the reference as numpy. Entry points run on the card unless the caller
passes ``device='cpu'``.
"""
