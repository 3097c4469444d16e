"""The PyTorch / CUDA port's benchmark (see PERF.md)."""
