"""The model zoo of ``horovod_tpu/models`` in PyTorch: the Transformer
(GPT-2, BERT, Llama shapes), ViT-B/16, ResNet-50/101, VGG-16, Inception
V3 and the MNIST ConvNet. Images are NCHW; each model's carrier in
:mod:`.convert` takes the JAX model's tree across."""

from .inception import InceptionV3  # noqa: F401
from .mnist import MNISTConvNet  # noqa: F401
from .resnet import ResNet, ResNet50, ResNet101  # noqa: F401
from .transformer import (  # noqa: F401
    Transformer,
    TransformerConfig,
    init_cache,
)
from .vgg import VGG, VGG16  # noqa: F401
from .vit import ViT, ViTConfig  # noqa: F401
