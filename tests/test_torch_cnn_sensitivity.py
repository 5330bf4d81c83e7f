"""How far the CNN main path's rounds part under a 1-ulp change, in both
packages (ROADMAP Queue 3, item B).

Three FedAvg rounds of the main path's CNN (FEMNIST-shaped
``femnist_gen`` clients, lr 0.1, batch 20, no dropout, no shuffling) run
in each package from the JAX initialization, then from the same weights
with one conv1 weight moved up by 1 ulp. A package's *split* is the max
abs difference of its two final models. The test holds the port's split
within a factor of 10 of JAX's (both ways), so the port is no more
sensitive to a rounding change than the reference.

It also pins where the two packages' runs part on this data: on the
first batch of client 2 the conv weight gradients of JAX's f32 path and
of the port's with oneDNN off agree with a float64 reference at 1e-5
(relative to the gradient's max). PyTorch's oneDNN convolution is not
held: on some hosts its f32 weight gradient of that batch is 0.4% off
(ROADMAP Queue 3).

To keep the file short, each of 2 clients holds its first 40 samples (2
steps a round). ``PYTHONPATH=. python tests/test_torch_cnn_sensitivity.py
--client_num 2 --samples 0`` runs the probe on whole clients (16 and 5
steps a round, about 80 s) and prints the splits.
"""

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.flagship_gen import build_femnist_federation
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fedavg import _CNNNoDropout, _FlaxCNNNoDropout

TRAIN = dict(epochs=1, batch_size=20, lr=0.1, shuffle=False)
ROUNDS = 3
#: the largest ratio allowed between the two packages' splits
SPLIT_FACTOR = 10.0


def _clients(client_num, samples):
    src = build_femnist_federation(client_num=client_num, seed=0)

    def cut(d):
        return {c: tuple(a[:samples] if samples else a for a in d[c])
                for c in range(client_num)}
    return cut(src.train_data_local_dict), cut(src.test_data_local_dict)


def _max_diff(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def splits(client_num=2, samples=40):
    """Each package's final model from the shared weights and from the
    1-ulp change; returns ``(jax_split, port_split, port_vs_jax)``."""
    train, test = _clients(client_num, samples)
    rounds = dict(comm_round=ROUNDS, client_num_per_round=client_num,
                  frequency_of_the_test=10**9)
    ref = JaxFedAvgAPI(JaxFederatedDataset.from_client_arrays(train, test,
                                                              62),
                       _FlaxCNNNoDropout(), config=JaxFedAvgConfig(
                           train=JaxTrainConfig(**TRAIN), **rounds))
    model = _CNNNoDropout(only_digits=False)
    api = FedAvgAPI(FederatedDataset.from_client_arrays(train, test, 62),
                    model, config=FedAvgConfig(train=TrainConfig(**TRAIN),
                                               **rounds), device="cpu")
    init = jax.tree.map(np.asarray, ref.variables)
    moved = jax.tree.map(np.copy, init)
    k = moved["params"]["Conv_0"]["kernel"]
    k[0, 0, 0, 0] = np.nextafter(k[0, 0, 0, 0], np.float32(np.inf))

    def run_jax(v):
        ref.variables = jax.tree.map(jnp.asarray, v)
        for r in range(ROUNDS):
            ref.run_round(r)
        return {n: t.numpy() for n, t in flax_to_state_dict(
            jax.tree.map(np.asarray, ref.variables), model).items()}

    def run_port(v):
        api.variables = flax_to_state_dict(v, model)
        for r in range(ROUNDS):
            api.run_round(r)
        return {n: t.numpy().copy() for n, t in api.variables.items()}
    jax_a, jax_b = run_jax(init), run_jax(moved)
    port_a, port_b = run_port(init), run_port(moved)
    return (_max_diff(jax_a, jax_b), _max_diff(port_a, port_b),
            _max_diff(port_a, jax_a))


def test_the_port_parts_under_a_1_ulp_change_as_far_as_jax():
    jax_split, port_split, _ = splits()
    assert jax_split > 0.0 and port_split > 0.0
    assert port_split <= SPLIT_FACTOR * jax_split
    assert jax_split <= SPLIT_FACTOR * port_split


def conv_gradient_errors():
    """The conv layers' gradients of the first batch of 20 of client 2
    at the JAX init, each path's max abs error against the port's
    float64 gradient, relative to that gradient's max: JAX's f32 path,
    the port's f32 path with oneDNN on and with it off."""
    train, _ = _clients(3, 20)
    x, y = train[2]
    flax_cnn = _FlaxCNNNoDropout()
    variables = flax_cnn.init(jax.random.key(0), jnp.asarray(x[:1]))

    def loss(p):
        logits = flax_cnn.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
    model = _CNNNoDropout(only_digits=False)
    want = flax_to_state_dict(jax.tree.map(np.asarray, {
        "params": jax.jit(jax.grad(loss))(variables["params"])}), model)
    state = flax_to_state_dict(jax.tree.map(np.asarray, variables), model)

    def grads(dtype):
        m = _CNNNoDropout(only_digits=False).to(dtype)
        m.load_state_dict({n: v.to(dtype) for n, v in state.items()})
        torch.nn.functional.cross_entropy(
            m(torch.from_numpy(x).to(dtype)),
            torch.from_numpy(y).long()).backward()
        return {n: p.grad.double() for n, p in m.named_parameters()}
    f64 = grads(torch.float64)
    paths = {"jax": {n: g.double() for n, g in want.items()},
             "onednn": grads(torch.float32)}
    with torch.backends.mkldnn.flags(enabled=False):
        paths["onednn_off"] = grads(torch.float32)
    return {path: {n: float((g[n] - f64[n]).abs().max()
                            / f64[n].abs().max())
                   for n in ("conv1.weight", "conv1.bias", "conv2.weight")}
            for path, g in paths.items()}


def test_conv_gradients_of_one_batch_against_float64():
    errors = conv_gradient_errors()
    for path in ("jax", "onednn_off"):
        assert max(errors[path].values()) <= 1e-5, (path, errors)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--client_num", type=int, default=2)
    p.add_argument("--samples", type=int, default=40,
                   help="samples a client keeps (0: all)")
    a = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    j, t, d = splits(a.client_num, a.samples)
    print(f"clients {a.client_num}, samples {a.samples or 'all'}: JAX split "
          f"{j:.3g}, port split {t:.3g}, port vs JAX {d:.3g}")
    for path, errs in conv_gradient_errors().items():
        print(f"client 2's first batch, {path} vs float64: " + ", ".join(
            f"{n} {e:.3g}" for n, e in errs.items()))
    sys.exit(0)
