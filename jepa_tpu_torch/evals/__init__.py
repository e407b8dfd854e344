"""Frozen-encoder attentive-probe evals (video and image)."""
