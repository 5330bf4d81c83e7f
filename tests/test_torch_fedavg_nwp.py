"""The transformer LM's federated next-token round against the JAX package.

The token federation is byte-identical to the JAX package's for the same
arguments. One FedAvg ``nwp`` round on a tiny TransformerLM (shuffle off, no
dropout, so no RNG stream enters the trajectory) starts from the same
converted weights on both sides. The port runs ``make_flash_attention(16,
16)``, whose wrappers take their plain versions on the CPU; the JAX side
runs ``attn_fn=None`` (its reference attention): the Pallas kernel in
interpret mode under the round's vmap costs tens of seconds of compilation,
and tests/test_torch_flash_attention.py already holds the port's flash path
to the Pallas kernels. Parameters after the round at rtol 1e-4, atol 1e-5
(attention and dense layers sum in another order in torch than in XLA, and
the flash path's online softmax in yet another; the error grows through two
SGD steps per client).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.data.synthetic import make_token_federated as jax_tokens
from fedml_tpu.models.transformer import TransformerLM as FlaxLM
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.registry import DEFAULT_MODEL_AND_TASK
from fedml_tpu_torch.data.synthetic import make_token_federated
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops.flash_attention import make_flash_attention
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import flax_to_state_dict
from fedml_tpu_torch.utils.metrics import read_metrics

TOKENS = dict(client_num=4, vocab_size=40, seq_len=16,
              sequences_per_client=8, seed=3)
LM = dict(vocab_size=40, width=32, depth=2, num_heads=2, max_len=16)


class _NumpyInitLM:
    """The flax LM whose ``init`` draws the variables from numpy (their tree
    traced with ``eval_shape``, never run): the JAX FedAvgAPI initializes op
    by op, which costs seconds for a transformer. ``apply`` is flax's."""

    def __init__(self, seed=0, **cfg):
        self.module, self.seed = FlaxLM(**cfg), seed

    def init(self, key, x, train=False):
        shapes = jax.eval_shape(functools.partial(self.module.init,
                                                  train=train), key, x)
        rng = np.random.RandomState(self.seed)
        return jax.tree.map(
            lambda sd: jnp.asarray(0.3 * rng.randn(*sd.shape), jnp.float32),
            shapes)

    def apply(self, *args, **kw):
        return self.module.apply(*args, **kw)


def test_token_federation_is_identical_to_jax():
    got, want = make_token_federated(**TOKENS), jax_tokens(**TOKENS)
    assert got.class_num == want.class_num == 40
    assert got.train_data_local_num_dict == want.train_data_local_num_dict
    for c in range(TOKENS["client_num"]):
        for split in ("train_data_local_dict", "test_data_local_dict"):
            for a, b in zip(getattr(got, split)[c], getattr(want, split)[c]):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    for a, b in zip(got.test_data_global, want.test_data_global):
        np.testing.assert_array_equal(a, b)
    assert DEFAULT_MODEL_AND_TASK["token_blob"] == ("transformer", "nwp")


def test_one_nwp_round_matches_jax_fedavg():
    kw = dict(epochs=1, batch_size=4, lr=0.1, shuffle=False)
    rounds = dict(comm_round=1, client_num_per_round=3,
                  frequency_of_the_test=100)
    ref = JaxFedAvgAPI(jax_tokens(**TOKENS), _NumpyInitLM(**LM), task="nwp",
                       config=JaxFedAvgConfig(train=JaxTrainConfig(**kw),
                                              **rounds))
    model = TransformerLM(**LM, attn_fn=make_flash_attention(16, 16))
    api = FedAvgAPI(make_token_federated(**TOKENS), model, task="nwp",
                    config=FedAvgConfig(train=TrainConfig(**kw), **rounds),
                    device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    want_idxs, want_stats = ref.run_round(0)
    idxs, stats = api.run_round(0)
    assert list(idxs) == list(want_idxs)
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables), model)
    assert list(api.variables) == list(want)
    for k in want:
        np.testing.assert_allclose(api.variables[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in want_stats:
        np.testing.assert_allclose(float(stats[k]), float(want_stats[k]),
                                   rtol=1e-4)
    got, want_eval = api.evaluate(0), ref.evaluate(0)
    for k in ("train_loss", "test_loss", "train_acc", "test_acc"):
        np.testing.assert_allclose(got[k], want_eval[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_main_runs_one_token_blob_round_on_cpu(tmp_path):
    final = main_fedavg.main([
        "--dataset", "token_blob", "--client_num_in_total", "4",
        "--client_num_per_round", "2", "--batch_size", "16",
        "--comm_round", "1", "--frequency_of_the_test", "1",
        "--lr", "0.1", "--device", "cpu", "--run_dir", str(tmp_path)])
    assert final["round"] == 0
    assert np.isfinite(final["test_loss"])
    # per-token accounting: 4 clients x 8 test sequences x 32 tokens, less
    # the pad-id targets
    assert 0 < final["test_total"] <= 4 * 8 * 32
    assert [r["round"] for r in read_metrics(str(tmp_path))] == [0]
