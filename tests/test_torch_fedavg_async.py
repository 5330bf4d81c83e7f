"""The port's quorum and FedAsync servers against the JAX package's.

Without threads, a scripted sequence of replies is fed to both packages'
handlers: FedAsync's global model (rtol 1e-5, atol 1e-6) and its
``update_log`` (exactly), and the quorum server's partial close, which is
held three ways: the aggregation kernel's plain version (the buffered
close), the streaming fold and JAX's ``aggregate_available``. With
threads, runs that a fault plan or a single silo makes deterministic: a
1-silo FedAsync run, and a quorum run whose round-1 straggler is a
dropped reply. No run waits on a sleeping straggler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg_async as jasync
from fedml_tpu.algorithms.fedavg_cross_silo import \
    FedAvgAggregator as JaxAggregator
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms import fedavg_async as pasync
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops.aggregate import tree_weighted_mean_fused
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import flax_to_state_dict
from fedml_tpu_torch.utils.metrics import read_metrics

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLOB = dict(client_num=6, dim=32, class_num=4, seed=1)
TRAIN = dict(epochs=1, batch_size=16, lr=0.1, shuffle=False)
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_KEY = cs.MSG_ARG_KEY_MODEL_PARAMS


@pytest.mark.parametrize("alpha, poly_a", [(0.6, 0.5), (0.5, 1.0),
                                           (0.9, 0.25)])
def test_staleness_weight_matches_jax(alpha, poly_a):
    ours = pasync.AsyncFedAvgServerManager.staleness_weight
    theirs = jasync.AsyncFedAvgServerManager.staleness_weight

    class Cfg:
        pass
    cfg = Cfg()
    cfg.alpha, cfg.poly_a = alpha, poly_a
    for s in range(12):
        assert ours(cfg, s) == theirs(cfg, s) == alpha * (s + 1) ** -poly_a


class _Outbox:
    """A stub endpoint of either package: keeps what the server sends."""

    def __init__(self):
        self.sent = []
        self.bytes_sent = self.bytes_received = 0

    def add_observer(self, obs):
        pass

    def send_message(self, msg):
        self.sent.append(msg)

    def broadcast(self, msgs, on_error=None):
        self.sent.extend(msgs)
        return {"enqueued": len(msgs), "max_queue_depth": 0}

    def stop_receive_message(self):
        pass


def _flax_init():
    jds = jax_blob(**BLOB)
    module = FlaxLR(num_classes=jds.class_num)
    return jds, module, module.init(
        jax.random.key(0), jnp.asarray(jds.train_data_global[0][:1]),
        train=False)


def _port_model(ds):
    return create_model("lr", ds.class_num,
                        input_shape=ds.train_data_global[0].shape[1:])


def _scripted_updates(jinit, n, seed=3):
    """``n`` replies as flax trees from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda x: rng.normal(size=np.shape(x)).astype(
        np.float32), jax.tree.map(np.asarray, jinit)) for _ in range(n)]


def _reply(msg_cls, rank, version, model, n=10.0):
    msg = msg_cls(cs.MSG_TYPE_C2S_SEND_MODEL, rank, 0)
    msg.add(MODEL_KEY, model)
    msg.add(cs.MSG_ARG_KEY_NUM_SAMPLES, n)
    msg.add(cs.MSG_ARG_KEY_ROUND, version)
    return msg


def test_scripted_fedasync_replies_match_jax():
    """Replies at various staleness, fed to both servers' handlers: the
    same global model after every merge, the same ``update_log`` and the
    same re-dispatches, and FINISH once the budget is spent."""
    jds, _, jinit = _flax_init()
    ds = make_blob_federated(**BLOB)
    model = _port_model(ds)
    updates = _scripted_updates(jinit, 6)
    script = [(1, 0), (2, 0), (3, 0), (1, 1), (2, 2), (3, 1)]
    jout, pout = _Outbox(), _Outbox()
    jserver = jasync.AsyncFedAvgServerManager(
        0, 4, jout, JaxAggregator(3), client_num_in_total=ds.client_num,
        global_model=jinit, alpha=0.5, poly_a=0.5, max_updates=6)
    pserver = pasync.AsyncFedAvgServerManager(
        0, 4, pout, cs.FedAvgAggregator(3),
        client_num_in_total=ds.client_num,
        global_model=flax_to_state_dict(jax.tree.map(np.asarray, jinit),
                                        model),
        alpha=0.5, poly_a=0.5, max_updates=6)
    for (rank, version), upd in zip(script, updates):
        jserver.handle_message_receive_model_from_client(
            _reply(JMessage, rank, version, upd))
        pserver.handle_message_receive_model_from_client(
            _reply(Message, rank, version, {
                k: v.numpy() for k, v in flax_to_state_dict(upd,
                                                            model).items()}))
        want = flax_to_state_dict(jax.tree.map(np.asarray,
                                               jserver.global_model), model)
        for k in want:
            torch.testing.assert_close(pserver.global_model[k], want[k],
                                       **TOL)
    assert pserver.update_log == jserver.update_log
    assert [u["staleness"] for u in pserver.update_log] == [0, 1, 2, 2, 2, 4]

    def sent(out):
        return [(m.get_type(), m.get_receiver_id(),
                 m.get_params().get(cs.MSG_ARG_KEY_CLIENT_INDEX),
                 m.get_params().get(cs.MSG_ARG_KEY_ROUND)) for m in out.sent]
    assert sent(pout) == sent(jout)
    assert [t for t, *_ in sent(pout)][-3:] == [cs.MSG_TYPE_S2C_FINISH] * 3
    # past the budget a reply is ignored
    pserver.handle_message_receive_model_from_client(
        _reply(Message, 1, 6, {k: v.numpy() for k, v in
                               pserver.global_model.items()}))
    assert pserver.version == 6


def test_fedasync_refuses_a_compressed_update_loudly():
    ds = make_blob_federated(**BLOB)
    out = _Outbox()
    server = pasync.AsyncFedAvgServerManager(
        0, 3, out, cs.FedAvgAggregator(2), client_num_in_total=6,
        global_model={"w": torch.zeros(4)}, compression="delta_int8")
    assert server._policy.name == "none"
    from fedml_tpu_torch.comm.compression import compress_delta
    payload = compress_delta({"w": torch.ones(4)}, {"w": torch.zeros(4)},
                             torch.Generator().manual_seed(0))
    server.handle_message_receive_model_from_client(
        _reply(Message, 1, 0, payload))
    assert isinstance(server.config_error, ValueError)
    assert [m.get_type() for m in out.sent] == [cs.MSG_TYPE_S2C_FINISH] * 2
    del ds


def _tick(msg_cls, round_idx):
    msg = msg_cls(cs.MSG_TYPE_ROUND_TIMEOUT, 0, 0)
    msg.add(cs.MSG_ARG_KEY_ROUND, round_idx)
    return msg


def test_quorum_close_through_the_kernels_plain_version_matches_jax():
    """Two of three silos report round 0 (out of order), the deadline
    tick closes it at quorum 2: the buffered close through the
    aggregation kernel's front end (its plain version on the CPU), the
    streaming fold and JAX's ``aggregate_available`` agree; the third
    silo's late reply is discarded as stale by both packages."""
    jds, _, jinit = _flax_init()
    ds = make_blob_federated(**BLOB)
    model = _port_model(ds)
    upd = _scripted_updates(jinit, 3, seed=7)
    weights = {3: 30.0, 1: 10.0, 2: 20.0}
    init_sd = flax_to_state_dict(jax.tree.map(np.asarray, jinit), model)

    def drive(server, msg_cls, convert):
        server.register_message_receive_handlers()
        server.send_init_msg()
        for rank in (3, 1):
            server.receive_message(4, _reply(msg_cls, rank, 0, convert(
                upd[rank - 1]), weights[rank]))
        server.receive_message(9, _tick(msg_cls, 0))
        server.receive_message(4, _reply(msg_cls, 2, 0, convert(upd[1]),
                                         weights[2]))
        server.finish()
        return server

    def to_port(tree):
        return {k: v.numpy() for k, v in flax_to_state_dict(
            tree, model).items()}
    runs = {}
    for name, agg in (("kernel", cs.FedAvgAggregator(
            3, aggregate_fn=tree_weighted_mean_fused)),
            ("fold", cs.FedAvgAggregator(3))):
        runs[name] = drive(pasync.QuorumFedAvgServerManager(
            0, 4, _Outbox(), agg, 2, ds.client_num,
            {k: v.clone() for k, v in init_sd.items()}, quorum=2,
            round_deadline_s=30.0), Message, to_port)
    jserver = drive(jasync.QuorumFedAvgServerManager(
        0, 4, _Outbox(), JaxAggregator(3), 2, ds.client_num, jinit,
        quorum=2, round_deadline_s=30.0), JMessage, lambda t: t)
    want = flax_to_state_dict(jax.tree.map(np.asarray,
                                           jserver.global_model), model)
    oracle = {k: (10.0 * flax_to_state_dict(upd[0], model)[k].double()
                  + 30.0 * flax_to_state_dict(upd[2], model)[k].double())
              / 40.0 for k in want}
    for name, server in runs.items():
        assert server.partial_rounds == jserver.partial_rounds == [0]
        assert server.ft_counters["stale_replies"] == \
            jserver.ft_counters["stale_replies"] == 1
        assert server.round_idx == 1
        for k in want:
            torch.testing.assert_close(server.global_model[k], want[k],
                                       **TOL)
            torch.testing.assert_close(server.global_model[k],
                                       oracle[k].float(), **TOL)
    assert runs["kernel"].aggregator.received_count() == 0


def test_quorum_validation_and_the_extension_cap():
    with pytest.raises(ValueError, match="quorum"):
        pasync.QuorumFedAvgServerManager(
            0, 4, _Outbox(), cs.FedAvgAggregator(3), 1, 6,
            {"w": torch.zeros(2)}, quorum=5)
    server = pasync.QuorumFedAvgServerManager(
        0, 3, _Outbox(), cs.FedAvgAggregator(2), 2, 6, {"w": torch.zeros(2)},
        quorum=2, round_deadline_s=30.0, max_deadline_extensions=1)
    server.register_message_receive_handlers()
    server.send_init_msg()
    server.receive_message(9, _tick(Message, 0))
    assert server.scheduling_error is None
    server.receive_message(9, _tick(Message, 0))
    assert "below quorum (0/2 updates)" in str(server.scheduling_error)
    assert server.ft_counters["deadline_extensions"] == 2


def _jax_async(mode, **kw):
    jds, module, jinit = _flax_init()
    _, history, server = jasync.run_fedavg_async(
        jds, module, mode=mode, train_cfg=JaxTrainConfig(**TRAIN),
        wire_codec=True, **kw)
    return jinit, history, server


def _port_async(mode, jinit, **kw):
    ds = make_blob_federated(**BLOB)
    model = _port_model(ds)
    init = flax_to_state_dict(jax.tree.map(np.asarray, jinit), model)
    final, history, server = pasync.run_fedavg_async(
        ds, model, mode=mode, train_cfg=TrainConfig(**TRAIN), device="cpu",
        init_variables=init, join_timeout_s=60, **kw)
    return model, final, history, server


def test_one_silo_fedasync_run_matches_jax():
    jinit, jhist, jserver = _jax_async("fedasync", worker_num=1,
                                       max_updates=5, alpha=0.5)
    model, final, hist, server = _port_async("fedasync", jinit,
                                             worker_num=1, max_updates=5,
                                             alpha=0.5)
    assert server.update_log == jserver.update_log
    assert [u["staleness"] for u in server.update_log] == [0] * 5
    assert [r["round"] for r in hist] == [r["round"] for r in jhist] == [
        1, 2, 3, 4, 5]
    want = flax_to_state_dict(jax.tree.map(np.asarray,
                                           jserver.global_model), model)
    for k in want:
        torch.testing.assert_close(final[k], want[k], **TOL)


def test_quorum_run_with_a_dropped_reply_matches_jax():
    """Silo 3's round-1 reply is lost: round 1 closes at its deadline on
    the other two (quorum 2), the only possible close, in both packages."""
    plan = "seed=1;drop:direction=send,sender=3,msg_type=4,after=1,max_count=1"
    kw = dict(worker_num=3, comm_round=3, quorum=2, round_deadline_s=0.3,
              fault_plan=plan)
    jinit, jhist, jserver = _jax_async("quorum", **kw)
    model, final, hist, server = _port_async("quorum", jinit, **kw)
    assert server.partial_rounds == jserver.partial_rounds == [1]
    assert server.ft_counters["deadline_extensions"] == \
        jserver.ft_counters["deadline_extensions"] == 0
    want = flax_to_state_dict(jax.tree.map(np.asarray,
                                           jserver.global_model), model)
    for k in want:
        torch.testing.assert_close(final[k], want[k], **TOL)
    for got, exp in zip(hist, jhist):
        assert got["round"] == exp["round"]
        np.testing.assert_allclose(got["test_loss"], exp["test_loss"],
                                   rtol=1e-5, atol=1e-7)


def test_fedasync_on_several_silos_logs_its_mixes():
    ds = make_blob_federated(**BLOB)
    _, history, server = pasync.run_fedavg_async(
        ds, _port_model(ds), mode="fedasync", worker_num=3, max_updates=9,
        alpha=0.5, poly_a=0.5, train_cfg=TrainConfig(**TRAIN),
        device="cpu", join_timeout_s=60, compression="delta_int8")
    assert server.version == 9 and len(server.update_log) == 9
    for u in server.update_log:
        assert u["mix"] == 0.5 * (u["staleness"] + 1) ** -0.5
    assert len({u["worker"] for u in server.update_log}) >= 2
    assert [r["round"] for r in history] == list(range(1, 10))


@pytest.mark.parametrize("mode, extra", [
    ("quorum", ["--quorum", "2", "--round_deadline_s", "0.3",
                "--fault_plan",
                "drop:direction=send,sender=3,msg_type=4,after=1,"
                "max_count=1"]),
    ("fedasync", ["--max_updates", "6", "--async_alpha", "0.5"])])
def test_fed_launch_runs_fedavg_async(mode, extra, tmp_path):
    final = fed_launch.main([
        "--algo", "fedavg_async", "--async_mode", mode, "--dataset", "blob",
        "--client_num_in_total", "6", "--client_num_per_round", "3",
        "--comm_round", "3", "--batch_size", "16", "--lr", "0.1",
        "--device", "cpu", *extra, "--run_dir", str(tmp_path / "run")])
    assert np.isfinite(final["test_loss"])
    if mode == "quorum":
        assert final["partial_rounds"] == [1] and final["round"] == 2
    else:
        assert final["updates"] == 6 and final["round"] == 6
        assert final["mean_staleness"] >= 0.0
    assert read_metrics(str(tmp_path / "run"))


@pytest.mark.parametrize("name, value", [
    ("server_checkpoint_dir", "ck"), ("checkpoint_sync", True),
    ("pace_steering", True), ("join_rate_limit", 2.0)])
def test_control_plane_options_raise_naming_item_23(name, value):
    ds = make_blob_federated(**BLOB)
    with pytest.raises(NotImplementedError, match="item 23"):
        pasync.run_fedavg_async(ds, _port_model(ds), device="cpu",
                                **{name: value})


def test_an_unknown_mode_is_refused():
    ds = make_blob_federated(**BLOB)
    with pytest.raises(ValueError, match="unknown async mode"):
        pasync.run_fedavg_async(ds, _port_model(ds), mode="gossip",
                                device="cpu")
