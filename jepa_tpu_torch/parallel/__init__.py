"""Data-parallel runtime: process groups (``dist``) and the per-process
layout of the data and ZeRO-1 axes (``mesh``)."""
