"""Models of the port."""

from .resnet import (  # noqa: F401
    ResNet,
    ResNetConfig,
    resnet50_init,
    resnet_apply,
    resnet_loss,
)
from .transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    checkpoint_policy,
    remat_from_env,
    transformer_apply,
    transformer_flops_per_token,
    transformer_hidden,
    transformer_init,
    transformer_loss,
)
