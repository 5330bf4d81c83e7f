"""PyTorch model zoo, the counterpart of ``fedml_tpu.models``.

All modules share one calling convention: ``module(x, train=bool,
generator=torch.Generator | None)`` with the JAX package's NHWC image
layout at the input (the transformer takes integer tokens ``[B, T]``). ``create_model`` mirrors the reference's factory
(fedml_experiments/distributed/fedavg/main_fedavg.py:229-266).
"""

from math import prod
from typing import Optional, Sequence

from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.models.lr import LogisticRegression


def create_model(model_name: str, output_dim: int = 10,
                 input_shape: Optional[Sequence[int]] = None, **kw):
    """Model factory with reference naming. ``input_shape`` is one
    example's feature shape; ``lr`` needs it to size its layer.
    ``transformer`` takes ``output_dim`` as its vocab size and ``kw`` as
    :class:`TransformerLM` fields (``width``, ``depth``, ``attn_fn``...)."""
    if model_name == "lr":
        if input_shape is None:
            raise ValueError("model 'lr' needs input_shape")
        return LogisticRegression(prod(input_shape), output_dim)
    if model_name == "cnn":
        return CNN_DropOut(only_digits=(output_dim == 10))
    if model_name == "transformer":
        from fedml_tpu_torch.models.transformer import TransformerLM
        return TransformerLM(vocab_size=output_dim, **kw)
    raise ValueError(f"unknown model: {model_name!r}")
