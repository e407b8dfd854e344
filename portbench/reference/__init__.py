"""Plain PyTorch references of the cells' models, fp32 with TF32 off. They
import neither jax, jepa_tpu nor jepa_tpu_torch, and take nothing the
program made: the benchmark hands them the same weights, clips and masks."""
