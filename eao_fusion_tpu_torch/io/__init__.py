"""Synthetic sequences and trajectory evaluation."""
