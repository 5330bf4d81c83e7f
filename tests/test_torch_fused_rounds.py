"""FusedRounds: R FedAvg rounds per dispatch (on a GPU, replays of a
captured CUDA graph of the round; on the CPU the same gated round body in
a loop), mirroring the JAX package's tests/test_fused_rounds.py FedAvg
cases.

The fused trajectory is the host loop's bit for bit, with shuffle and
dropout on: the host loop skips padding-only steps and the fused body
gates them into no-ops, and both draw dropout masks from a counter hash of
the step's seed. Against the JAX package's ``FusedRounds`` (shuffle and
dropout off, the seed chains differ) the LR block agrees at atol 1e-5, the
existing LR parity tolerance.
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fedavg import (FedAvgAPI, FedAvgConfig,
                                               FusedRounds)
from fedml_tpu_torch.core.sampling import (device_round_key,
                                           device_sample_clients)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops import aggregate
from fedml_tpu_torch.parallel.graphs import GraphCache
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                device_batch_schedule)
from fedml_tpu_torch.utils.convert import flax_to_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One CPU thread for these tests: the suite runs in parallel workers,
    and many-threaded CPU convolutions in each oversubscribe the cores
    (the bit-for-bit comparisons hold at any thread count; both sides of
    each run under the same one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image_ds(sizes, seed=0):
    rng = np.random.RandomState(seed)
    train, test = {}, {}
    for c, n in enumerate(sizes):
        x = rng.rand(n, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 62, n).astype(np.int32)
        train[c], test[c] = (x, y), (x[:3], y[:3])
    return FederatedDataset.from_client_arrays(train, test, 62)


CNN_SIZES = [6, 30, 9, 12, 4, 17]


def _api(ds, model="lr", device="cpu", delete_client=None, **kw):
    train = dict(epochs=2, batch_size=8, lr=0.1)
    train.update(kw.pop("train", {}))
    cfg = dict(comm_round=6, client_num_per_round=ds.client_num,
               frequency_of_the_test=100, train=TrainConfig(**train))
    cfg.update(kw)
    module = (create_model("cnn", 62) if model == "cnn" else
              create_model("lr", ds.class_num, input_shape=(20,)))
    return FedAvgAPI(ds, module, device=device, delete_client=delete_client,
                     config=FedAvgConfig(**cfg))


def _equal(a, b):
    return all(torch.equal(a.variables[k].cpu(), b.variables[k].cpu())
               for k in a.variables)


@pytest.mark.parametrize("case", [
    # block mode, the CNN with dropout and shuffle
    dict(model="cnn", per_round=3, train={}),
    # full participation, the CNN with dropout and shuffle
    dict(model="cnn", per_round=6, train=dict(epochs=1, batch_size=4)),
    # block mode under amsgrad, accumulation and the LR decay schedule
    dict(model="lr", per_round=3, train=dict(
        client_optimizer="adam", wd=1e-4, accum_steps=2, lr=0.05),
        lr_decay_round=0.8),
    # full participation under momentum
    dict(model="lr", per_round=8, train=dict(momentum=0.9))],
    ids=["cnn-block", "cnn-full", "lr-block-adam-accum", "lr-full-momentum"])
def test_fused_equals_host_loop_bit_for_bit(case):
    ds = (_image_ds(CNN_SIZES) if case["model"] == "cnn"
          else make_blob_federated(client_num=8, seed=0))
    train = dict(case["train"])
    if "lr_decay_round" in case:
        train["lr_decay_round"] = case["lr_decay_round"]
    host = _api(ds, case["model"], client_num_per_round=case["per_round"],
                train=train)
    fused_api = _api(ds, case["model"],
                     client_num_per_round=case["per_round"], train=train)
    fused = fused_api.fused_rounds()
    assert fused.mode == ("full" if case["per_round"] == ds.client_num
                          else "block")
    rounds = 2 if case["model"] == "cnn" else 6
    host_stats = [host.run_round(r)[1] for r in range(rounds)]
    stats = fused.run_rounds(0, rounds)
    assert _equal(host, fused_api)
    for k in stats:
        assert stats[k].shape == (rounds,)
        assert torch.equal(stats[k], torch.stack([s[k] for s in host_stats]))


@pytest.mark.parametrize("train_kw", [
    dict(), dict(momentum=0.9),
    dict(client_optimizer="adam", wd=1e-4, accum_steps=2)],
    ids=["sgd", "momentum", "adam-accum"])
def test_gated_padding_only_batches_are_true_noops(train_kw):
    """The fused body's gated steps: ten padding-only batches appended to a
    client move nothing (params, momentum, amsgrad's count, MultiSteps'
    window), and the gated walk gives the skipping walk's bits."""
    from fedml_tpu_torch.trainer.functional import make_local_train
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.int32)
    model = create_model("lr", 3, input_shape=(4,))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    local = make_local_train(model, "classification", TrainConfig(
        epochs=2, batch_size=4, lr=0.1, shuffle=True, **train_kw))
    ref, ref_stats = local(init, torch.from_numpy(x), torch.from_numpy(y),
                           torch.ones(8), seed=3)
    xp = torch.from_numpy(np.concatenate([x, np.zeros((40, 4), np.float32)]))
    yp = torch.from_numpy(np.concatenate([y, np.zeros(40, np.int32)]))
    mp = torch.from_numpy(np.concatenate([np.ones(8), np.zeros(40)])
                          .astype(np.float32))
    for gated in (False, True):
        out, stats = local(init, xp, yp, mp, seed=3, gated=gated)
        assert all(torch.equal(ref[k], out[k]) for k in ref)
        assert all(torch.equal(ref_stats[k], stats[k]) for k in ref_stats)


def test_resuming_mid_stream_matches():
    ds = make_blob_federated(client_num=8, seed=1)
    a, b = (_api(ds, client_num_per_round=3, train=dict(momentum=0.9))
            for _ in range(2))
    a.fused_rounds().run_rounds(0, 4)
    fb = b.fused_rounds()
    fb.run_rounds(0, 2)
    fb.run_rounds(2, 2)
    assert _equal(a, b)


@pytest.mark.parametrize("per_round", [3, 8])
def test_train_eval_cadence_and_chunking_match_host_loop(per_round):
    ds = make_blob_federated(client_num=8, seed=2)
    kw = dict(client_num_per_round=per_round, comm_round=7,
              frequency_of_the_test=3)
    host, fused_api, capped = _api(ds, **kw), _api(ds, **kw), _api(ds, **kw)
    host.train()
    fused_api.fused_rounds().train()
    chunks = []
    driver = capped.fused_rounds()
    run = driver.run_rounds

    def spy(r0, rounds):
        chunks.append((r0, rounds))
        return run(r0, rounds)
    driver.run_rounds = spy
    driver.train(max_rounds_per_dispatch=2)
    assert chunks == [(0, 1), (1, 2), (3, 1), (4, 2), (6, 1)]
    for api in (fused_api, capped):
        assert ([r["round"] for r in api.history]
                == [r["round"] for r in host.history] == [0, 3, 6])
        assert _equal(host, api)
        for h, f in zip(host.history, api.history):
            for k in ("test_acc", "test_loss", "train_loss",
                      "train_loss_local"):
                assert h[k] == f[k], k
    assert {"phase_pack_ms", "phase_dispatch_ms"} <= set(capped.history[-1])


def test_chunked_train_learns():
    ds = make_blob_federated(client_num=8, seed=2)
    api = _api(ds, comm_round=12, frequency_of_the_test=4)
    final = api.fused_rounds().train(max_rounds_per_dispatch=3)
    assert final["test_acc"] > 0.9, final
    assert [r["round"] for r in api.history] == [0, 4, 8, 11]


def test_block_honors_delete_client():
    ds = make_blob_federated(client_num=8, seed=14)
    kw = dict(client_num_per_round=4, comm_round=5, delete_client=2)
    host, fused_api = _api(ds, **kw), _api(ds, **kw)
    for r in range(5):
        idxs, _ = host.run_round(r)
        assert 2 not in set(int(i) for i in idxs)
    fused_api.fused_rounds().run_rounds(0, 5)
    assert _equal(host, fused_api)


@pytest.mark.parametrize("device_sampling, per_round",
                         [(False, 8), (True, 4)])
def test_delete_client_refused_outside_block_mode(device_sampling,
                                                  per_round):
    ds = make_blob_federated(client_num=8, seed=4)
    api = _api(ds, client_num_per_round=per_round, delete_client=2)
    with pytest.raises(ValueError, match="delete_client"):
        api.fused_rounds(device_sampling=device_sampling)


def test_block_respects_global_pack_policy():
    # client 0, the largest, sits out rounds 0-2 of 3-of-6 sampling, so the
    # block's cohort bucket is smaller than the global pad
    ds = _image_ds([60] + CNN_SIZES[1:], seed=3)
    a = _api(ds, "cnn", client_num_per_round=3, pack="global")
    b = _api(ds, "cnn", client_num_per_round=3, pack="cohort")
    seen = []
    for api in (a, b):
        driver = api.fused_rounds()
        block = driver._block_inputs(0, 3)
        seen.append(block["x"].shape[2])
        driver.run_rounds(0, 3)
    assert seen[0] == ds.padded_len(8) > seen[1]
    assert _equal(a, b)  # padding never changes the math


def test_mispairing_refused():
    ds = make_blob_federated(client_num=4, seed=5)
    api = _api(ds)
    assert type(api.fused_rounds()) is FusedRounds

    class OtherDriver(FusedRounds):
        pass

    with pytest.raises(TypeError, match="pairs with FusedRounds"):
        OtherDriver(api)

    class NoFusionAPI(FedAvgAPI):
        _fused_driver_cls = None

    other = NoFusionAPI(ds, create_model("lr", ds.class_num,
                                         input_shape=(20,)), device="cpu")
    with pytest.raises(TypeError, match="cannot fuse"):
        other.fused_rounds()
    with pytest.raises(TypeError, match="no fused driver"):
        FusedRounds(other)


def test_device_sampling_learns_with_distinct_cohorts():
    ds = make_blob_federated(client_num=16, seed=5, n_samples=3000)
    api = _api(ds, comm_round=20, client_num_per_round=4,
               frequency_of_the_test=10, train=dict(batch_size=16))
    fused = api.fused_rounds(device_sampling=True)
    assert fused.mode == "device"
    draws = set()
    for r in range(6):
        idx = device_sample_clients(
            device_round_key(api.config.seed, torch.tensor(r)), 16, 4)
        assert len(set(idx.tolist())) == 4 and idx.max() < 16
        draws.add(tuple(idx.tolist()))
    assert len(draws) > 1
    final = fused.train(max_rounds_per_dispatch=5)
    assert final["test_acc"] > 0.85, final


def test_device_batch_schedule_is_a_padding_invariant_order():
    mask = np.zeros((2, 24), np.float32)
    mask[0, :13], mask[1, :5] = 1, 1
    seeds = torch.tensor([11, 12])
    long = device_batch_schedule(seeds, torch.from_numpy(mask), 3, 4, True,
                                 accum_steps=2)
    short = device_batch_schedule(seeds, torch.from_numpy(mask[:, :16]), 3,
                                  4, True, accum_steps=2)
    for c, n in enumerate((13, 5)):
        for e in range(3):
            a = long.batch_idx[c, e * 6:(e + 1) * 6].reshape(-1)
            b = short.batch_idx[c, e * 4:(e + 1) * 4].reshape(-1)
            assert torch.equal(a[:n], b[:n])
            assert sorted(a[:n].tolist()) == list(range(n))
            assert torch.equal(long.step_seeds[c, e * 6:e * 6 + 4],
                               short.step_seeds[c, e * 4:(e + 1) * 4])
    real = long.has_real[0].tolist()
    assert real == ([True] * 4 + [False] * 2) * 3
    assert long.emit[0].tolist() == ([False, True] * 2 + [False] * 2) * 3


def test_port_block_matches_jax_fused_block():
    # the JAX side is imported here, so that this file's gpu tests also
    # collect where flax is not installed
    import jax

    from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
    from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
    from fedml_tpu.algorithms.fedavg import FusedRounds as JaxFusedRounds
    from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
    from fedml_tpu.models.lr import LogisticRegression as FlaxLR
    from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig

    kw = dict(epochs=2, batch_size=16, lr=0.1, shuffle=False)
    rounds = dict(comm_round=4, client_num_per_round=3,
                  frequency_of_the_test=100)
    jds = jax_blob(client_num=6, seed=1)
    ref = JaxFedAvgAPI(jds, FlaxLR(num_classes=jds.class_num),
                       config=JaxFedAvgConfig(train=JaxTrainConfig(**kw),
                                              **rounds))
    ds = make_blob_federated(client_num=6, seed=1)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    api = FedAvgAPI(ds, model, config=FedAvgConfig(train=TrainConfig(**kw),
                                                   **rounds), device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    want_stats = JaxFusedRounds(ref).run_rounds(0, 4)
    stats = api.fused_rounds().run_rounds(0, 4)
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables), model)
    for k in want:
        np.testing.assert_allclose(api.variables[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    for k in want_stats:
        np.testing.assert_allclose(stats[k].numpy(),
                                   np.asarray(want_stats[k]), rtol=1e-5)


def test_cost_analysis_names_its_roadmap_item():
    api = _api(make_blob_federated(client_num=4, seed=5))
    with pytest.raises(NotImplementedError, match="item 24"):
        api.fused_rounds().cost_analysis()


def test_graph_cache_is_bounded_least_recently_used_first():
    cache, built = GraphCache(capacity=2), []

    def build(key):
        built.append(key)
        return key

    for key in ("a", "b", "a", "c", "b"):
        cache.get(key, lambda: build(key))
    assert built == ["a", "b", "c", "b"] and len(cache) == 2
    assert cache.values() == ["c", "b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the aggregation "
                    "kernel run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_one_model_template_serves_apis_on_the_card(cuda_device):
    """An API moves its module template to the card; a second API built
    from the same template initializes it on the CPU again, as the first
    did, and starts from the same weights."""
    ds = make_blob_federated(client_num=4, seed=6)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    a = FedAvgAPI(ds, model, device="cuda")
    b = FedAvgAPI(ds, model, device="cuda")
    assert _equal(a, b)


@pytest.mark.gpu
def test_cuda_graph_rounds_equal_host_loop(cuda_device, monkeypatch):
    # cuDNN's deterministic algorithms: the two runs of the same
    # convolutions then give the same bits
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = _image_ds(CNN_SIZES, seed=4)
    host = _api(ds, "cnn", "cuda", client_num_per_round=3)
    fused_api = _api(ds, "cnn", "cuda", client_num_per_round=3)
    for r in range(4):
        host.run_round(r)
    fused = fused_api.fused_rounds()
    before = aggregate.weighted_mean_flat.launches
    fused.run_rounds(0, 2)
    fused.run_rounds(2, 2)
    graphs = fused.graphs.values()
    assert sum(g.replays for g in graphs) == 4 and all(
        g.launches[aggregate.weighted_mean_flat] == 1 for g in graphs)
    # each capture's warm-up round launches once more than the replays;
    # the capture itself launches nothing and counts nothing
    assert (aggregate.weighted_mean_flat.launches - before
            == 4 + len(graphs))
    diff = max(float((host.variables[k] - fused_api.variables[k]).abs().max())
               for k in host.variables)
    assert diff <= 1e-6, diff


@pytest.mark.gpu
def test_efficientnet_fused_block_equals_host_loop(cuda_device,
                                                   monkeypatch):
    """EfficientNet-b0 (BN statistics, drop-connect and the head's dropout
    on, shuffle on) over a captured block and the host loop: the masks come
    from the counter hash, so the replayed graph draws the host loop's."""
    from fedml_tpu_torch.data.synthetic import make_image_blob_federated
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = make_image_blob_federated(client_num=4, samples_per_client=10,
                                   image_size=32, seed=3)
    cfg = FedAvgConfig(comm_round=2, client_num_per_round=3,
                       frequency_of_the_test=100, train=TrainConfig(
                           epochs=1, batch_size=4, lr=0.05))
    host, fused_api = (FedAvgAPI(ds, create_model("efficientnet-b0",
                                                  ds.class_num),
                                 device="cuda", config=cfg)
                       for _ in range(2))
    start = {k: v.clone() for k, v in host.variables.items()}
    for r in range(2):
        host.run_round(r)
    fused_api.fused_rounds().run_rounds(0, 2)
    diff = max(float((host.variables[k] - fused_api.variables[k]).abs().max())
               for k in host.variables)
    assert diff <= 1e-6, diff
    assert not torch.equal(host.variables["blocks.1.bn2.running_var"],
                           start["blocks.1.bn2.running_var"])
