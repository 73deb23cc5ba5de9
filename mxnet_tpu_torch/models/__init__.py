"""Model zoo of the port: Symbol constructors for the reference's training
configs, each the JAX package's (``mxnet_tpu/models/``) node for node.

``get_symbol(name, **kwargs)`` and ``_ZOO`` have the JAX package's names and
aliases (``mxnet_tpu/models/__init__.py:15-49``).
"""
from . import (lenet, mlp, alexnet, vgg, resnet, inception_bn, inception_v3,  # noqa: F401
               lstm, transformer, vgg16_ssd, recommender)


_ZOO = {
    "lenet": lenet.get_symbol,
    "mlp": mlp.get_symbol,
    "alexnet": alexnet.get_symbol,
    "vgg": vgg.get_symbol,
    "vgg16": lambda **kw: vgg.get_symbol(num_layers=16, **kw),
    "vgg19": lambda **kw: vgg.get_symbol(num_layers=19, **kw),
    "inception-bn": inception_bn.get_symbol,
    "inception_bn": inception_bn.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "inception_v3": inception_v3.get_symbol,
    "resnet": resnet.get_symbol,
    "resnet-18": lambda **kw: resnet.get_symbol(num_layers=18, **kw),
    "resnet-34": lambda **kw: resnet.get_symbol(num_layers=34, **kw),
    "resnet-50": lambda **kw: resnet.get_symbol(num_layers=50, **kw),
    "resnet-101": lambda **kw: resnet.get_symbol(num_layers=101, **kw),
    "resnet-152": lambda **kw: resnet.get_symbol(num_layers=152, **kw),
    "lstm": lstm.get_symbol,
    "transformer": transformer.get_symbol,
    "transformer_mt": transformer.get_symbol_mt,
    "vgg16-ssd-300": vgg16_ssd.get_symbol,
    "vgg16-ssd-300-train": vgg16_ssd.get_symbol_train,
    "recommender": recommender.get_symbol,
    "dlrm": recommender.get_symbol,
}


def get_symbol(name, **kwargs):
    """Build a named network Symbol (reference: each symbols/<net>.py
    get_symbol). kwargs are passed to the network constructor
    (num_classes, image_shape, num_layers, dtype, ...)."""
    key = name.lower()
    if key not in _ZOO:
        raise ValueError("unknown model %r (have: %s)" % (name, sorted(_ZOO)))
    return _ZOO[key](**kwargs)
