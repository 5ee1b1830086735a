"""The port's model zoo: the counterpart of ``horovod_tpu/models``."""

from __future__ import annotations


def get_model(name: str, **kwargs):
    """Factory keyed by the benchmark names the reference's scripts use
    (``resnet50``, ``vgg16``, ``inception3``, ...), normalised as the JAX
    package's ``get_model`` does: lower case, ``-`` and ``_`` dropped."""
    name = name.lower().replace("-", "").replace("_", "")
    from . import inception, resnet, vgg

    zoo = {
        "resnet18": resnet.ResNet18,
        "resnet34": resnet.ResNet34,
        "resnet50": resnet.ResNet50,
        "resnet101": resnet.ResNet101,
        "resnet152": resnet.ResNet152,
        "vgg11": vgg.VGG11,
        "vgg16": vgg.VGG16,
        "vgg19": vgg.VGG19,
        "inception3": inception.InceptionV3,
        "inceptionv3": inception.InceptionV3,
    }
    if name not in zoo:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(zoo)}"
        )
    return zoo[name](**kwargs)
