"""Hand-written GPU kernels (Triton, and CUDA C++ bound with ctypes),
built at their first launch."""
