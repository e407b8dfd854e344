"""Mask generators (counterpart of jepa_tpu/masks)."""
