"""Byte identity of the port's generated federations with the JAX
package's, at cut client counts: every client's train and test arrays, in
dtype and bytes, the global unions and the class count, for the seven
generators of the cross-device anchors and FedSeg's ``seg_shapes``. The JAX builders' disk cache is off
(``FEDML_GEN_CACHE=""``), so both sides generate."""

import numpy as np
import pytest

from fedml_tpu_torch.data import flagship_gen, leaf_gen, synthetic
from fedml_tpu_torch.data.registry import DEFAULT_MODEL_AND_TASK, LOADERS


def _jax_builders():
    from fedml_tpu.data import flagship_gen as jf
    from fedml_tpu.data import leaf_gen as jl
    from fedml_tpu.data import synthetic as js
    return {
        "fed_cifar100_gen": (jf.build_fedcifar100_federation,
                             flagship_gen.build_fedcifar100_federation,
                             dict(client_num=12)),
        "stackoverflow_nwp_gen": (
            jf.build_stackoverflow_nwp_federation,
            flagship_gen.build_stackoverflow_nwp_federation,
            dict(client_num=300, seed=3)),
        "shakespeare_gen": (jl.build_shakespeare_federation,
                            leaf_gen.build_shakespeare_federation,
                            dict(client_num=15)),
        "mnist_gen": (jl.build_leaf_mnist_federation,
                      leaf_gen.build_leaf_mnist_federation,
                      dict(client_num=40, target_acc=0.85, noise=1.2)),
        "mnist_gen_noise_free": (jl.build_leaf_mnist_federation,
                                 leaf_gen.build_leaf_mnist_federation,
                                 dict(client_num=25, seed=2)),
        "img_blob": (js.make_image_blob_federated,
                     synthetic.make_image_blob_federated,
                     dict(client_num=6, partition_method="hetero",
                          class_num=5, seed=1)),
        "img_blob_homo": (js.make_image_blob_federated,
                          synthetic.make_image_blob_federated,
                          dict(client_num=4)),
        "synthetic": (js.make_synthetic_federated,
                      synthetic.make_synthetic_federated,
                      dict(client_num=8)),
        "powerlaw_blob": (js.make_powerlaw_blob_federated,
                          synthetic.make_powerlaw_blob_federated,
                          dict(client_num=120, max_samples=64)),
        "seg_shapes": (js.make_shapes_segmentation,
                       synthetic.make_shapes_segmentation,
                       dict(client_num=3, samples_per_client=6)),
        "seg_shapes_48": (js.make_shapes_segmentation,
                          synthetic.make_shapes_segmentation,
                          dict(client_num=2, image_size=48, seed=5)),
    }


CASES = ["fed_cifar100_gen", "stackoverflow_nwp_gen", "shakespeare_gen",
         "mnist_gen", "mnist_gen_noise_free", "img_blob", "img_blob_homo",
         "synthetic", "powerlaw_blob", "seg_shapes", "seg_shapes_48"]


def _assert_same_federation(got, want):
    assert got.class_num == want.class_num
    assert got.client_num == want.client_num
    for c in range(want.client_num):
        for part in ("train_data_local_dict", "test_data_local_dict"):
            for a, b in zip(getattr(got, part)[c], getattr(want, part)[c]):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes(), (part, c)
    for part in ("train_data_global", "test_data_global"):
        for a, b in zip(getattr(got, part), getattr(want, part)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_generator_is_byte_identical_to_jax(case, monkeypatch):
    monkeypatch.setenv("FEDML_GEN_CACHE", "")
    jax_fn, port_fn, kw = _jax_builders()[case]
    _assert_same_federation(port_fn(**kw), jax_fn(**kw))


def test_registry_pairs_each_dataset_as_the_jax_package():
    from fedml_tpu.data.registry import \
        DEFAULT_MODEL_AND_TASK as JAX_PAIRS
    for name in LOADERS:
        assert DEFAULT_MODEL_AND_TASK[name] == JAX_PAIRS[name], name
    assert set(LOADERS) >= {"fed_cifar100_gen", "shakespeare_gen",
                            "stackoverflow_nwp_gen", "mnist_gen", "img_blob",
                            "synthetic", "powerlaw_blob"}


def test_shapes_of_the_anchor_federations():
    so = flagship_gen.build_stackoverflow_nwp_federation(client_num=50)
    x, y = so.train_data_global
    assert so.class_num == 10004 and x.shape[1:] == (21,)
    assert x.dtype == np.int32 and (x[:, 0] == 10002).all()
    assert np.array_equal(x[:, 1:], y[:, :-1]) and (y[:, -1] == 10003).all()
    sh = leaf_gen.build_shakespeare_federation(client_num=5)
    x, y = sh.train_data_global
    assert sh.class_num == 90 and x.shape[1:] == (80,)
    assert np.array_equal(x[:, 1:], y[:, :-1]) and x.min() >= 1
    cf = flagship_gen.build_fedcifar100_federation(client_num=3)
    assert cf.class_num == 100
    assert cf.train_data_global[0].shape == (240, 24, 24, 3)
    seg = LOADERS["seg_shapes"]("", client_num_in_total=2)
    x, y = seg.train_data_global
    assert seg.class_num == 3 and x.shape == (32, 32, 32, 3)
    assert y.shape == (32, 32, 32) and set(np.unique(y)) == {0, 1, 2}
    with pytest.raises(ValueError, match="image_size"):
        synthetic.make_shapes_segmentation(image_size=12)
