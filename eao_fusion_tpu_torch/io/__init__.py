"""Dataset I/O: TUM files, IMU samples, checkpoints, the native frame
loader, synthetic sequences, and trajectory evaluation."""
