from geomx_tpu_torch.optim.server_opt import (  # noqa: F401
    AdaDelta, AdaGrad, Adam, DCASGD, Nag, RmsProp, ServerOptimizer, Sgd,
    Signum, make_optimizer, spec_of,
)
