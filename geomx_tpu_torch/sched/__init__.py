from geomx_tpu_torch.sched.tsengine import TsScheduler, TsClient  # noqa: F401
