"""jepa_tpu_torch: the V-JEPA serving path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``jepa_tpu`` (JAX/Pallas on TPU), which stays in the repository
as the numerical reference. This package imports torch and numpy only.
Entry points: ``jepa_tpu_torch.api.load_encoder`` / ``load_classifier``.
Kernels: ``csrc/`` (built at first use by ``ops/_build.py``).
"""
