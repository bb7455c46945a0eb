"""How the harness builds a configuration's model in the port: one
module a family, named by the configuration file's ``family``, with
``grad_fn(config, device)`` returning the port's ``grad_fn(params, x,
y) -> (loss, acc, grads)``."""
