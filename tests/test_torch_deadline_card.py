"""The deadline and quorum servers' partial close on the card: one launch
of the aggregation kernel a round at C = the round's reporters, against
the streaming fold of the same run (rtol 1e-5, atol 1e-6). The file
imports no JAX, so it collects on a machine without it; on the CPU every
case skips (tests/test_torch_faults.py and tests/test_torch_fedavg_async.py
hold the same closes to the JAX package there).

Run on the card: ``python -m pytest tests/test_torch_deadline_card.py -m
gpu -q``.
"""

import pytest
import torch

from fedml_tpu_torch.algorithms import fedavg_async as pasync
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig

BLOB = dict(client_num=6, dim=32, class_num=4, seed=2)
TRAIN = dict(epochs=1, batch_size=16, lr=0.1, shuffle=False)
SILOS = 3
TOL = dict(rtol=1e-5, atol=1e-6)
#: silo 3 loses its round-1 reply (its endpoint's second reply)
DROP_R1 = "seed=1;drop:direction=send,sender=3,msg_type=4,after=1,max_count=1"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the aggregation kernel runs only "
                    "on the card)")
    return torch.device("cuda")


def _runs(server_cls, device, **server_kw):
    """The same plan twice: the buffered close through the kernel's front
    end, and the streaming fold; returns the C of every kernel close, its
    launches, and both final models."""
    from fedml_tpu_torch.ops import aggregate
    ds = make_blob_federated(**BLOB)
    model = create_model("lr", ds.class_num, input_shape=(32,))
    closes, finals, launches = [], {}, {}

    def kernel(stacked, weights):
        closes.append(int(weights.shape[0]))
        return aggregate.tree_weighted_mean_fused(stacked, weights)
    for name, fn in (("kernel", kernel), ("fold", None)):
        def factory(size, com, _agg, global_model, on_round_done, fn=fn):
            return server_cls(
                0, size, com, cs.FedAvgAggregator(size - 1, aggregate_fn=fn),
                3, ds.client_num, global_model, on_round_done=on_round_done,
                **server_kw)
        before = aggregate.weighted_mean_flat.launches
        finals[name] = cs.launch_federation(
            ds, model, "classification", SILOS, TrainConfig(**TRAIN),
            factory, fault_plan=DROP_R1, device=device,
            join_timeout_s=60)[0]
        launches[name] = aggregate.weighted_mean_flat.launches - before
    return closes, launches, finals


@pytest.mark.gpu
def test_the_deadline_close_runs_the_kernel_on_the_card(cuda_device):
    closes, launches, finals = _runs(cs.FedAvgServerManager, cuda_device,
                                     round_deadline_s=0.5)
    # round 1 closes at its deadline over two reports, and silo 3 stays out
    assert closes == [3, 2, 2] and launches == {"kernel": 3, "fold": 0}
    for k, v in finals["fold"].items():
        torch.testing.assert_close(finals["kernel"][k], v, **TOL)


@pytest.mark.gpu
def test_the_quorum_close_runs_the_kernel_on_the_card(cuda_device):
    closes, launches, finals = _runs(pasync.QuorumFedAvgServerManager,
                                     cuda_device, quorum=2,
                                     round_deadline_s=0.5)
    # the quorum server evicts no one: round 2 is whole again
    assert closes == [3, 2, 3] and launches == {"kernel": 3, "fold": 0}
    for k, v in finals["fold"].items():
        torch.testing.assert_close(finals["kernel"][k], v, **TOL)
