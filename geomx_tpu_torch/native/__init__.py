from geomx_tpu_torch.native.bindings import lib, available  # noqa: F401
