"""Models of the port."""

from .resnet import (  # noqa: F401
    ResNet,
    ResNetConfig,
    resnet50_init,
    resnet_apply,
    resnet_loss,
)
