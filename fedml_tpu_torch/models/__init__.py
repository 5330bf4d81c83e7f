"""PyTorch model zoo, the counterpart of ``fedml_tpu.models``.

All modules share one calling convention: ``module(x, train=bool,
generator=torch.Generator | None)`` with the JAX package's NHWC image
layout at the input (the transformer and the LSTMs take integer tokens
``[B, T]``). ``create_model`` mirrors the reference's factory
(fedml_experiments/distributed/fedavg/main_fedavg.py:229-266).
"""

from math import prod
from typing import Optional, Sequence

from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.models.lr import LogisticRegression


def create_model(model_name: str, output_dim: int = 10,
                 input_shape: Optional[Sequence[int]] = None, **kw):
    """Model factory with reference naming, in the JAX package's order.
    ``input_shape`` is one example's feature shape; ``lr`` needs it to size
    its layer, and VGG its classifier (``(H, W, C)``; 32x32 without it).
    ``transformer`` and ``rnn_seq`` take ``output_dim`` as their vocab
    size and ``kw`` as the model's fields (``width``, ``depth``,
    ``attn_fn``...); ``rnn`` and ``rnn_stackoverflow`` ignore
    ``output_dim``, as the JAX package's factory does."""
    if model_name == "lr":
        if input_shape is None:
            raise ValueError("model 'lr' needs input_shape")
        return LogisticRegression(prod(input_shape), output_dim)
    if model_name == "cnn":
        return CNN_DropOut(only_digits=(output_dim == 10))
    if model_name in ("resnet18_gn", "resnet18"):
        from fedml_tpu_torch.models.resnet_gn import resnet18_gn
        return resnet18_gn(num_classes=output_dim, **kw)
    if model_name == "resnet56":
        from fedml_tpu_torch.models.resnet import resnet56
        return resnet56(num_classes=output_dim, **kw)
    if model_name == "resnet110":
        from fedml_tpu_torch.models.resnet import resnet110
        return resnet110(num_classes=output_dim, **kw)
    if model_name == "mobilenet":
        from fedml_tpu_torch.models.mobilenet import MobileNet
        return MobileNet(num_classes=output_dim, **kw)
    if model_name == "mobilenet_v3":
        from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3
        return MobileNetV3(num_classes=output_dim, **kw)
    if model_name == "rnn":
        from fedml_tpu_torch.models.rnn import RNN_OriginalFedAvg
        return RNN_OriginalFedAvg(**kw)
    if model_name == "rnn_seq":
        # every position scored over output_dim chars: the shakespeare
        # loaders emit whole shifted target sequences for the nwp head
        from fedml_tpu_torch.models.rnn import RNN_OriginalFedAvg
        return RNN_OriginalFedAvg(
            **{"vocab_size": output_dim, "seq_output": True, **kw})
    if model_name == "rnn_stackoverflow":
        from fedml_tpu_torch.models.rnn import RNN_StackOverflow
        return RNN_StackOverflow(**kw)
    if model_name == "transformer":
        from fedml_tpu_torch.models.transformer import TransformerLM
        return TransformerLM(vocab_size=output_dim, **kw)
    if model_name in ("vgg11", "vgg13", "vgg16", "vgg19"):
        from fedml_tpu_torch.models.vgg import VGG
        if input_shape is not None:
            kw = {"image_size": tuple(input_shape[:2]), **kw}
        return VGG(arch=model_name, num_classes=output_dim, **kw)
    if model_name.startswith("efficientnet"):
        from fedml_tpu_torch.models.efficientnet import efficientnet
        return efficientnet(model_name, num_classes=output_dim)
    if model_name == "segnet":
        from fedml_tpu_torch.models.segnet import SegNet
        return SegNet(num_classes=output_dim, **kw)
    if model_name == "resnet8_gkt":
        from fedml_tpu_torch.models.resnet_gkt import resnet8_56
        return resnet8_56(num_classes=output_dim)
    if model_name == "resnet56_gkt_server":
        from fedml_tpu_torch.models.resnet_gkt import resnet56_server
        return resnet56_server(num_classes=output_dim)
    if model_name == "darts":
        from fedml_tpu_torch.models.darts import DartsNetwork
        return DartsNetwork(num_classes=output_dim, **kw)
    raise ValueError(f"unknown model: {model_name!r}")
