"""The port's FedOpt against the JAX package's: the server optimizers
against optax, FedOptAPI rounds against JAX's (params and optimizer state,
carried across by the converter), and the fused driver against the host
loop. The JAX side is imported inside the tests that use it, so that this
file's gpu test also collects where flax and optax are not installed.

Tolerances: the optimizers alone rtol 1e-6, atol 1e-6 (one f32 op order;
XLA's and torch's ``pow``, ``rsqrt`` and norms round an ulp apart now and
then); the LR federations atol 1e-5, the existing LR parity tolerance
(f32 reduction order of the forward and backward). The fused driver equals
the host loop bit for bit.
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fedavg import (FedAvgAPI, FedAvgConfig,
                                               FusedRounds)
from fedml_tpu_torch.algorithms.fedopt import (OPTIMIZER_REPO, FedOptAPI,
                                               FedOptConfig,
                                               FedOptFusedRounds,
                                               get_server_optimizer)
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import (flax_to_state_dict,
                                           optax_state_to_port)

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(5, 3), (7,), (2, 4, 3)]
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
# every optimizer of the repo, sgd also with momentum
OPTIMIZERS = [("sgd", {}), ("sgd", {"momentum": 0.9})] + [
    (name, {}) for name in sorted(OPTIMIZER_REPO) if name != "sgd"]


@pytest.mark.parametrize("name, kw", OPTIMIZERS,
                         ids=[n + ("-momentum" if k else "")
                              for n, k in OPTIMIZERS])
def test_server_optimizer_matches_optax(name, kw):
    import jax
    import jax.numpy as jnp
    import optax

    from fedml_tpu.algorithms.fedopt import \
        get_server_optimizer as jax_server_optimizer
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = jax_server_optimizer(name, 0.05, **kw)
    jp = [jnp.asarray(a) for a in init]
    js = tx.init(jp)
    opt = get_server_optimizer(name, 0.05, **kw)
    tp = [torch.from_numpy(a.copy()) for a in init]
    ts = opt.init(tp)
    for _ in range(6):
        g = [rng.randn(*s).astype(np.float32) for s in SHAPES]
        u, js = tx.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = opt.update([torch.from_numpy(a) for a in g], ts, tp)
        tp = torch._foreach_add(tp, tu)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)
    # the state, field by field under optax's names
    want = {}
    for node in jax.tree.leaves(js, is_leaf=lambda n: hasattr(n, "_fields")):
        if hasattr(node, "_fields"):
            want.update(node._asdict())
    assert list(want) == list(ts)
    for k, v in want.items():
        if isinstance(v, list):
            for a, b in zip(ts[k], v):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **OPT_TOL)
        else:
            assert ts[k].dtype == torch.int32 and int(ts[k]) == int(v)


def test_unknown_server_optimizer_raises():
    with pytest.raises(ValueError, match="bogus"):
        get_server_optimizer("bogus", 0.1)


def _pair(server_optimizer, server_lr=0.05, per_round=3, **extra):
    import jax

    from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOptAPI
    from fedml_tpu.algorithms.fedopt import FedOptConfig as JaxFedOptConfig
    from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
    from fedml_tpu.models.lr import LogisticRegression as FlaxLR
    from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
    kw = dict(epochs=2, batch_size=16, lr=0.1, shuffle=False)
    rounds = dict(comm_round=3, client_num_per_round=per_round,
                  frequency_of_the_test=100,
                  server_optimizer=server_optimizer, server_lr=server_lr,
                  **extra)
    jds = jax_blob(client_num=6, seed=1)
    ref = JaxFedOptAPI(jds, FlaxLR(num_classes=jds.class_num),
                       config=JaxFedOptConfig(train=JaxTrainConfig(**kw),
                                              **rounds))
    ds = make_blob_federated(client_num=6, seed=1)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    api = FedOptAPI(ds, model, config=FedOptConfig(train=TrainConfig(**kw),
                                                   **rounds), device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    api.server_opt_state = optax_state_to_port(ref.server_opt_state, model)
    return ref, api, model


@pytest.mark.parametrize("server_optimizer, extra", [
    ("adam", {}), ("yogi", {}), ("adagrad", {}), ("lamb", {}),
    ("sgd", {"server_momentum": 0.9})],
    ids=["adam", "yogi", "adagrad", "lamb", "sgd-momentum"])
def test_rounds_match_jax_fedopt(server_optimizer, extra):
    import jax
    ref, api, model = _pair(server_optimizer, **extra)
    for r in range(3):
        want_idxs, want_stats = ref.run_round(r)
        idxs, stats = api.run_round(r)
        assert list(idxs) == list(want_idxs)
        want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables),
                                  model)
        for k in want:
            np.testing.assert_allclose(api.variables[k].numpy(),
                                       want[k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
        for k in want_stats:
            np.testing.assert_allclose(float(stats[k]),
                                       float(want_stats[k]), rtol=1e-5)
    want_state = optax_state_to_port(ref.server_opt_state, model)
    for k, v in want_state.items():
        if torch.is_tensor(v):
            assert torch.equal(api.server_opt_state[k], v), k
        else:
            for a, b in zip(api.server_opt_state[k], v):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                           rtol=0, err_msg=k)


def test_sgd_server_lr1_equals_fedavg():
    ds = make_blob_federated(client_num=6, seed=0)
    tc = TrainConfig(epochs=1, batch_size=16, lr=0.1, shuffle=False)
    shared = dict(comm_round=3, client_num_per_round=6,
                  frequency_of_the_test=100, train=tc)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    fedavg = FedAvgAPI(ds, model, config=FedAvgConfig(**shared),
                       device="cpu")
    fedopt = FedOptAPI(ds, model, config=FedOptConfig(
        server_optimizer="sgd", server_lr=1.0, **shared), device="cpu")
    for r in range(3):
        fedavg.run_round(r)
        fedopt.run_round(r)
    for k in fedavg.variables:
        # w - 1.0 * (w - avg) is avg up to the rounding of w's ulp
        np.testing.assert_allclose(fedopt.variables[k].numpy(),
                                   fedavg.variables[k].numpy(), atol=1e-6,
                                   rtol=0)


def _api(ds, per_round, server_optimizer="adam", **train):
    tc = dict(epochs=2, batch_size=8, lr=0.1, momentum=0.9)
    tc.update(train)
    return FedOptAPI(
        ds, create_model("lr", ds.class_num, input_shape=(20,)),
        device="cpu", config=FedOptConfig(
            comm_round=6, client_num_per_round=per_round,
            frequency_of_the_test=100, server_optimizer=server_optimizer,
            server_lr=0.02, train=TrainConfig(**tc)))


def _same(a, b):
    leaves = (torch.utils._pytree.tree_leaves((a.variables,
                                               a.server_opt_state)),
              torch.utils._pytree.tree_leaves((b.variables,
                                               b.server_opt_state)))
    return len(leaves[0]) == len(leaves[1]) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(*leaves))


@pytest.mark.parametrize("per_round, server_optimizer", [
    (3, "adam"), (8, "yogi"), (3, "lamb")],
    ids=["block-adam", "full-yogi", "block-lamb"])
def test_fused_equals_host_loop_bit_for_bit(per_round, server_optimizer):
    ds = make_blob_federated(client_num=8, seed=3)
    host, fused_api = (_api(ds, per_round, server_optimizer)
                       for _ in range(2))
    fused = fused_api.fused_rounds()
    assert type(fused) is FedOptFusedRounds
    assert fused.mode == ("full" if per_round == 8 else "block")
    host_stats = [host.run_round(r)[1] for r in range(6)]
    stats = fused.run_rounds(0, 4)
    more = fused.run_rounds(4, 2)
    assert _same(host, fused_api)
    assert int(fused_api.server_opt_state["count"]) == 6
    for k in stats:
        got = torch.cat([stats[k], more[k]])
        assert torch.equal(got, torch.stack([s[k] for s in host_stats]))


def test_device_mode_fused_equals_the_host_body_on_its_cohorts():
    """Device sampling draws its own cohorts and batch orders; on those
    inputs the fused (gated) round equals the host loop's round body,
    which skips padding-only steps on the host, bit for bit."""
    ds = make_blob_federated(client_num=8, seed=4)
    host, fused_api = (_api(ds, 3, "adam", shuffle=True) for _ in range(2))
    body = FedOptAPI._fedopt_round
    host._fedopt_round = lambda *a, gated=False, **k: body(
        host, *a, gated=False, **k)
    host.fused_rounds(device_sampling=True).run_rounds(0, 4)
    fused = fused_api.fused_rounds(device_sampling=True)
    assert fused.mode == "device"
    fused.run_rounds(0, 4)
    assert _same(host, fused_api)


def test_plain_fused_rounds_on_fedopt_raises():
    ds = make_blob_federated(client_num=4, seed=9)
    api = _api(ds, 4)
    with pytest.raises(TypeError, match="FedOptFusedRounds"):
        FusedRounds(api)
    assert type(api.fused_rounds()) is FedOptFusedRounds


def test_fedadam_learns():
    ds = make_blob_federated(client_num=10, seed=1)
    api = FedOptAPI(ds, create_model("lr", ds.class_num, input_shape=(20,)),
                    device="cpu", config=FedOptConfig(
                        comm_round=20, client_num_per_round=5,
                        frequency_of_the_test=19, server_optimizer="adam",
                        server_lr=0.1,
                        train=TrainConfig(epochs=1, batch_size=32, lr=0.1)))
    final = api.fused_rounds().train(max_rounds_per_dispatch=5)
    assert final["test_acc"] > 0.85, final


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the aggregation "
                    "kernel run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fedopt_capture_equals_host_loop_on_the_card(cuda_device,
                                                     monkeypatch):
    """The server Adam step inside the captured round: its state advances
    in the graph's static carry, one aggregation launch a replay, and the
    block equals the host loop (cuDNN deterministic)."""
    from fedml_tpu_torch.ops import aggregate
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = make_blob_federated(client_num=8, seed=5)

    def api():
        return FedOptAPI(ds, create_model("lr", ds.class_num,
                                          input_shape=(20,)),
                         device="cuda", config=FedOptConfig(
                             comm_round=4, client_num_per_round=3,
                             server_optimizer="adam", server_lr=0.02,
                             train=TrainConfig(epochs=2, batch_size=8,
                                               lr=0.1)))
    host, fused_api = api(), api()
    for r in range(4):
        host.run_round(r)
    fused = fused_api.fused_rounds()
    before = aggregate.weighted_mean_flat.launches
    fused.run_rounds(0, 4)
    graphs = fused.graphs.values()
    assert all(g.launches[aggregate.weighted_mean_flat] == 1
               for g in graphs)
    assert (aggregate.weighted_mean_flat.launches - before
            == 4 + len(graphs))
    assert int(fused_api.server_opt_state["count"]) == 4
    leaves = [torch.utils._pytree.tree_leaves((a.variables,
                                               a.server_opt_state))
              for a in (host, fused_api)]
    diff = max(float((x.double() - y.double()).abs().max())
               for x, y in zip(*leaves))
    assert diff <= 1e-6, diff
