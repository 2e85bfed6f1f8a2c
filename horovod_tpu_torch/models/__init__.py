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
from .vgg import (  # noqa: F401
    VGG,
    VGGConfig,
    vgg16_init,
    vgg_apply,
    vgg_loss,
)
from .mlp import MLP, mlp_apply, mlp_init, mlp_loss  # noqa: F401
