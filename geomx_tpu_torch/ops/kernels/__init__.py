"""Hand-written GPU kernels (Triton), built at their first launch."""
