"""Dataset dispatch by name, the experiment layer's ``load_data``.

The port's subset of ``fedml_tpu.data.registry``: the ``blob`` default and
the generated FEMNIST-shape federation of the main path, and the token
federation of the transformer LM's path. Names match the
reference's ``--dataset`` flag values.
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


def _token_blob(data_dir, **kw):
    from fedml_tpu_torch.data.synthetic import make_token_federated
    return make_token_federated(
        client_num=kw.get("client_num_in_total", 8))


LOADERS: Dict[str, Callable[..., FederatedDataset]] = {
    "blob": _blob,                # test workhorse, the CLI default
    "femnist_gen": _femnist_gen,  # 3400 clients, 62 classes, ceiling 84.9%
    "token_blob": _token_blob,    # Markov-chain tokens, the transformer LM
}

# --dataset name -> (model factory name, task head)
DEFAULT_MODEL_AND_TASK = {
    "blob": ("lr", "classification"),
    "femnist_gen": ("cnn", "classification"),
    "token_blob": ("transformer", "nwp"),
}


def load_data(dataset: str, data_dir: str = "", **kw) -> FederatedDataset:
    if dataset not in LOADERS:
        raise ValueError(
            f"unknown dataset {dataset!r}; known: {sorted(LOADERS)}")
    return LOADERS[dataset](data_dir, **kw)
