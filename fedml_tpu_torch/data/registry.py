"""Dataset dispatch by name, the experiment layer's ``load_data``.

The port's subset of ``fedml_tpu.data.registry``: the synthetic federations
(``blob``, the CLI default, ``powerlaw_blob``, ``synthetic``, ``img_blob``,
``seg_shapes`` and ``token_blob``) and the generated reference-scale flagships
(``femnist_gen``, ``fed_cifar100_gen``, ``mnist_gen``, ``shakespeare_gen``,
``stackoverflow_nwp_gen``), each paired with the JAX package's model and
task. Names match the reference's ``--dataset`` flag values.
"""

from __future__ import annotations

from typing import Callable, Dict

from fedml_tpu_torch.data.base import FederatedDataset


def _blob(data_dir, **kw):
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    return make_blob_federated(
        client_num=kw.get("client_num_in_total", 10),
        partition_method=kw.get("partition_method", "hetero"),
        partition_alpha=kw.get("partition_alpha", 0.5))


def _femnist_gen(data_dir, **kw):
    from fedml_tpu_torch.data.flagship_gen import build_femnist_federation
    return build_femnist_federation(
        client_num=kw.get("client_num_in_total", 3400))


def _synthetic_generated(data_dir, **kw):
    from fedml_tpu_torch.data.synthetic import make_synthetic_federated
    return make_synthetic_federated(
        client_num=kw.get("client_num_in_total", 30))


def _powerlaw_blob(data_dir, **kw):
    from fedml_tpu_torch.data.synthetic import make_powerlaw_blob_federated
    return make_powerlaw_blob_federated(
        client_num=kw.get("client_num_in_total", 1000))


def _img_blob(data_dir, **kw):
    from fedml_tpu_torch.data.synthetic import make_image_blob_federated
    return make_image_blob_federated(
        client_num=kw.get("client_num_in_total", 4),
        partition_method=kw.get("partition_method", "homo"),
        partition_alpha=kw.get("partition_alpha", 0.5))


def _fed_cifar100_gen(data_dir, **kw):
    from fedml_tpu_torch.data.flagship_gen import \
        build_fedcifar100_federation
    return build_fedcifar100_federation(
        client_num=kw.get("client_num_in_total", 500))


def _shakespeare_gen(data_dir, **kw):
    from fedml_tpu_torch.data.leaf_gen import build_shakespeare_federation
    return build_shakespeare_federation(
        client_num=kw.get("client_num_in_total") or 715)


def _stackoverflow_nwp_gen(data_dir, **kw):
    from fedml_tpu_torch.data.flagship_gen import \
        build_stackoverflow_nwp_federation
    return build_stackoverflow_nwp_federation(
        client_num=kw.get("client_num_in_total") or 342477)


def _mnist_gen(data_dir, **kw):
    from fedml_tpu_torch.data.leaf_gen import build_leaf_mnist_federation
    # noise 1.2 puts the >75% anchor past ~65 rounds under the 85% ceiling
    return build_leaf_mnist_federation(
        client_num=kw.get("client_num_in_total", 1000),
        target_acc=kw.get("target_acc", 0.85),
        noise=kw.get("noise", 1.2))


def _seg_shapes(data_dir, **kw):
    from fedml_tpu_torch.data.synthetic import make_shapes_segmentation
    return make_shapes_segmentation(
        client_num=kw.get("client_num_in_total", 4))


def _token_blob(data_dir, **kw):
    from fedml_tpu_torch.data.synthetic import make_token_federated
    return make_token_federated(
        client_num=kw.get("client_num_in_total", 8))


LOADERS: Dict[str, Callable[..., FederatedDataset]] = {
    "blob": _blob,                # test workhorse, the CLI default
    "synthetic": _synthetic_generated,  # LEAF synthetic(1, 1)
    "powerlaw_blob": _powerlaw_blob,    # 1000-client power-law sizes
    "img_blob": _img_blob,        # NHWC color patterns, the CIFAR ResNets
    "token_blob": _token_blob,    # Markov-chain tokens, the transformer LM
    "seg_shapes": _seg_shapes,    # squares and circles, FedSeg's SegNet
    "femnist_gen": _femnist_gen,  # 3400 clients, 62 classes, ceiling 84.9%
    "fed_cifar100_gen": _fed_cifar100_gen,  # 500 clients, 100c, ceil 44.7%
    "mnist_gen": _mnist_gen,      # 1000 clients, 10 classes, ceiling 85%
    "shakespeare_gen": _shakespeare_gen,  # 715 clients, ceiling 56.9%
    "stackoverflow_nwp_gen": _stackoverflow_nwp_gen,  # 342,477 clients
}

# --dataset name -> (model factory name, task head), as the JAX package
# pairs them
DEFAULT_MODEL_AND_TASK = {
    "blob": ("lr", "classification"),
    "synthetic": ("lr", "classification"),
    "powerlaw_blob": ("lr", "classification"),
    "img_blob": ("resnet56", "classification"),
    "token_blob": ("transformer", "nwp"),
    "seg_shapes": ("segnet", "segmentation"),
    "femnist_gen": ("cnn", "classification"),
    "fed_cifar100_gen": ("resnet18_gn", "classification"),
    "mnist_gen": ("lr", "classification"),
    "shakespeare_gen": ("rnn_seq", "nwp"),
    "stackoverflow_nwp_gen": ("rnn_stackoverflow", "nwp"),
}


def load_data(dataset: str, data_dir: str = "", **kw) -> FederatedDataset:
    if dataset not in LOADERS:
        raise ValueError(
            f"unknown dataset {dataset!r}; known: {sorted(LOADERS)}")
    return LOADERS[dataset](data_dir, **kw)
