from geomx_tpu_torch.models.cnn import CNN, create_cnn_state  # noqa: F401
from geomx_tpu_torch.models.resnet import (  # noqa: F401
    ResNet, create_resnet_state)
from geomx_tpu_torch.models.zoo import (  # noqa: F401
    MLP, MobileNet, SqueezeNet, VGG, create_mlp_state,
    create_mobilenet_state, create_squeezenet_state, create_vgg_state,
)

# name → factory registry, the JAX package's six families
MODEL_REGISTRY = {
    "cnn": create_cnn_state,
    "resnet": create_resnet_state,
    "mlp": create_mlp_state,
    "vgg": create_vgg_state,
    "mobilenet": create_mobilenet_state,
    "squeezenet": create_squeezenet_state,
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
