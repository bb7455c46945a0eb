"""Operation and byte counts from shapes alone: one function a file,
read by the per-layer metrics."""
