from geomx_tpu_torch.models.cnn import CNN, create_cnn_state  # noqa: F401

# name → factory registry (the port carries the CNN so far)
MODEL_REGISTRY = {
    "cnn": create_cnn_state,
}


def create_model_state(name: str, seed: int = 0, **kw):
    """Look up a family by name and build ``(model, params, grad_fn)``."""
    try:
        factory = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choose from {sorted(MODEL_REGISTRY)}"
        ) from None
    return factory(seed, **kw)
