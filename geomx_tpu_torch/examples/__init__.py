"""Runnable examples of the port (``python -m geomx_tpu_torch.examples.cnn``)."""
