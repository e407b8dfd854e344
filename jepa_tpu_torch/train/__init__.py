"""Pretraining: losses, optimizer, the train step (counterpart of jepa_tpu/train)."""
