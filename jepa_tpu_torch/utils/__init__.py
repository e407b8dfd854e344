"""Checkpoint loading and weight transfer."""
