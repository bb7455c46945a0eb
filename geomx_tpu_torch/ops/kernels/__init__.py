"""Hand-written GPU kernels (CUDA C++ built with nvcc and bound with
ctypes), built at their first launch."""
