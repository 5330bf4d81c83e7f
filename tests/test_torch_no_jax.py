"""fedml_tpu_torch stands alone: it imports no jax, flax, optax, msgpack
(which the card's machine does not have) or fedml_tpu module, and its
CUDA default never falls back to the CPU.

tests/conftest.py imports jax into this process, so the runtime check runs
the port in a subprocess. The child runs torch on one thread, as the
port's tests do (``tests/_torch_threads.py``): beside five other busy test
workers a torch on every core oversubscribes them, and the child's ~6 s
of work took 118 to 187 s.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models import create_model

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^(jax|jaxlib|flax|optax|msgpack)(\.|$)|^fedml_tpu(\.|$)")
#: the JAX package under any module name, but not the port's own
REFERENCE = re.compile(r"\bfedml_tpu(?!_torch)\b")

_CHILD = r"""
import importlib, json, pkgutil, sys
import torch
torch.set_num_threads(1)
import fedml_tpu_torch
for m in pkgutil.walk_packages(fedml_tpu_torch.__path__, "fedml_tpu_torch."):
    importlib.import_module(m.name)
from fedml_tpu_torch.experiments.main_fedavg import main
final = main(["--dataset", "blob", "--client_num_in_total", "4",
              "--client_num_per_round", "2", "--comm_round", "1",
              "--frequency_of_the_test", "1", "--batch_size", "16",
              "--device", "cpu", "--run_dir", sys.argv[1],
              "--obs_dir", sys.argv[1] + "/obs"])
# the flight log through the port's own tools
from fedml_tpu_torch.obs.__main__ import main as obs_main
obs_rc = obs_main(["merge", sys.argv[1] + "/obs"])
# one tiny transformer nwp round through the flash attention's CPU path
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.synthetic import make_token_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops.flash_attention import make_flash_attention
from fedml_tpu_torch.trainer.functional import TrainConfig
ds = make_token_federated(client_num=2, vocab_size=16, seq_len=16,
                          sequences_per_client=4)
lm = create_model("transformer", ds.class_num, width=16, depth=1,
                  num_heads=1, max_len=16,
                  attn_fn=make_flash_attention(16, 16))
api = FedAvgAPI(ds, lm, task="nwp", device="cpu", config=FedAvgConfig(
    comm_round=1, client_num_per_round=2,
    train=TrainConfig(batch_size=2, lr=0.1)))
_, stats = api.run_round(0)
# one round of a small BN ResNet-56 on img_blob and one of the char LSTM
from fedml_tpu_torch.data.leaf_gen import build_shakespeare_federation
from fedml_tpu_torch.data.synthetic import make_image_blob_federated
from fedml_tpu_torch.models.resnet import CifarResNet
ids = make_image_blob_federated(client_num=2, samples_per_client=8,
                                image_size=8)
bn = FedAvgAPI(ids, CifarResNet([1, 1, 1], ids.class_num), device="cpu",
               config=FedAvgConfig(comm_round=1, client_num_per_round=2,
                                   train=TrainConfig(batch_size=4, lr=0.1)))
before = bn.variables["stem_bn.running_var"].clone()
bn.run_round(0)
sds = build_shakespeare_federation(client_num=2, max_windows=12)
rnn = FedAvgAPI(sds, create_model("rnn_seq", sds.class_num, hidden_size=8),
                task="nwp", device="cpu", config=FedAvgConfig(
                    comm_round=1, client_num_per_round=2,
                    train=TrainConfig(batch_size=4, lr=0.5)))
_, rnn_stats = rnn.run_round(0)
slice_c = {"bn_stats_moved": not bool(
               (bn.variables["stem_bn.running_var"] == before).all()),
           "rnn_tokens": float(rnn_stats["count"])}
# one cross-silo round over the compressed wire (top-k + int8 + EF)
from fedml_tpu_torch.algorithms.fedavg_cross_silo import run_fedavg_cross_silo
from fedml_tpu_torch.data.synthetic import make_blob_federated
bds = make_blob_federated(client_num=4, seed=0)
_, hist = run_fedavg_cross_silo(
    bds, create_model("lr", bds.class_num, input_shape=(20,)), worker_num=2,
    comm_round=1, train_cfg=TrainConfig(batch_size=16, lr=0.1),
    compression="topk_ef_int8:0.1", device="cpu")
# the same over loopback TCP with a FedOpt server, saving the round state
# (the server's and each silo's residual) and resuming it, and the routed
# broker built from the port's own router.cpp
import errno, socket, tempfile
from fedml_tpu_torch.native import NativeRouter
ckpt = tempfile.mkdtemp(dir=sys.argv[1])
silo = dict(worker_num=2, train_cfg=TrainConfig(batch_size=16, lr=0.1),
            compression="topk_ef_int8:0.1", device="cpu",
            checkpoint_dir=ckpt, server_optimizer="adam", join_timeout_s=60)
for attempt in range(3):  # free ports may be taken before they are bound
    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    addresses = {r: s.getsockname() for r, s in enumerate(socks)}
    for s in socks:
        s.close()
    try:
        run_fedavg_cross_silo(bds, create_model("lr", bds.class_num,
                                                input_shape=(20,)),
                              comm_round=1, backend="TCP",
                              addresses=addresses, **silo)
        break
    except OSError as exc:
        if exc.errno != errno.EADDRINUSE or attempt == 2:
            raise
_, resumed = run_fedavg_cross_silo(
    bds, create_model("lr", bds.class_num, input_shape=(20,)), comm_round=2,
    resume=True, **silo)
with NativeRouter(token=b"t") as router:
    _, routed = run_fedavg_cross_silo(
        bds, create_model("lr", bds.class_num, input_shape=(20,)),
        worker_num=2, comm_round=1, backend="ROUTED", token=b"t",
        addresses={"router": ("127.0.0.1", router.port)}, device="cpu",
        train_cfg=TrainConfig(batch_size=16, lr=0.1))
# a deadline round that evicts a silo whose reply a fault plan drops, and
# the quorum and FedAsync servers through fed_launch
_, deadline_hist = run_fedavg_cross_silo(
    bds, create_model("lr", bds.class_num, input_shape=(20,)), worker_num=2,
    comm_round=2, train_cfg=TrainConfig(batch_size=16, lr=0.1),
    round_deadline_s=0.3, heartbeat_s=0.1, device="cpu",
    fault_plan="drop:direction=send,sender=2,msg_type=4,after=1,max_count=1")
# the control plane: a server killed before its round-2 broadcast and a
# fresh one that restores its snapshot and finishes the schedule
from fedml_tpu_torch.control.failover_harness import run_simulated_failover
_, ledger, restored = run_simulated_failover(
    tempfile.mkdtemp(dir=sys.argv[1]), rounds=3, crash_at_round=2,
    device="cpu")
assert restored.cp_counters["restores"] == 1, restored.cp_counters
assert [r["round"] for r in ledger] == [0, 1, 2], ledger
hist = hist + resumed + routed + deadline_hist
# two tenant jobs over one shared fabric and one device gate
from fedml_tpu_torch.sched import JobSpec, launch_jobs
tenancy = launch_jobs(
    [JobSpec(id="ta", workers=2, rounds=2, seed=1,
             compression="delta_int8"),
     JobSpec(id="tb", workers=3, rounds=1, seed=2, share=2.0)],
    tempfile.mkdtemp(dir=sys.argv[1]), device="cpu")
tenancy = {j: len(r["ledger"]) for j, r in tenancy["jobs"].items()}
# the rest of the FedAvg family through fed_launch
from fedml_tpu_torch.experiments import fed_launch
algos = {}
for algo, extra in (("fedopt", ["--fused_rounds", "1"]),
                    ("fedavg_robust", ["--defense_type", "weak_dp"]),
                    ("fednova", []), ("hierarchical", []),
                    ("turboaggregate", []), ("centralized", []),
                    ("decentralized", []), ("contribution", [])):
    algos[algo] = sorted(fed_launch.main([
        "--algo", algo, "--dataset", "blob", "--client_num_in_total", "4",
        "--client_num_per_round", "2", "--comm_round", "1",
        "--batch_size", "16", "--device", "cpu", *extra,
        "--run_dir", sys.argv[1] + "/" + algo]))
# FedSeg on SegNet, and a BN zoo model with drop-connect through a round
algos["fedseg"] = sorted(fed_launch.main([
    "--algo", "fedseg", "--dataset", "seg_shapes", "--client_num_in_total",
    "2", "--client_num_per_round", "2", "--comm_round", "1",
    "--batch_size", "8", "--device", "cpu", "--run_dir",
    sys.argv[1] + "/fedseg"]))
eff = FedAvgAPI(ids, create_model("efficientnet-b0", ids.class_num),
                device="cpu", config=FedAvgConfig(
                    comm_round=1, client_num_per_round=2,
                    train=TrainConfig(batch_size=4, lr=0.1)))
eff.run_round(0)
# split learning, vertical FL, FedGKT and one FedNAS search round with its
# genotype retrained through FedAvg
for algo, extra in (("split_nn", ["--dataset", "blob", "--lr", "0.01"]),
                    ("vertical_fl", ["--dataset", "blob"]),
                    ("fedgkt", ["--dataset", "img_blob"]),
                    ("fednas", ["--dataset", "img_blob",
                                "--nas_retrain_rounds", "1"])):
    algos[algo] = sorted(fed_launch.main([
        "--algo", algo, *extra, "--client_num_in_total", "2",
        "--client_num_per_round", "2", "--comm_round", "1",
        "--batch_size", "16", "--device", "cpu",
        "--run_dir", sys.argv[1] + "/" + algo]))
for mode in ("quorum", "fedasync"):
    algos["fedavg_async_" + mode] = sorted(fed_launch.main([
        "--algo", "fedavg_async", "--async_mode", mode, "--dataset", "blob",
        "--client_num_in_total", "4", "--client_num_per_round", "2",
        "--comm_round", "1", "--max_updates", "2", "--batch_size", "16",
        "--device", "cpu", "--run_dir", sys.argv[1] + "/async_" + mode]))
print(json.dumps({"modules": sorted(sys.modules), "round": final["round"],
                  "obs_rc": obs_rc,
                  "lm_tokens": float(stats["count"]),
                  "silo_rounds": [r["round"] for r in hist],
                  "algos": algos, "slice_c": slice_c,
                  "tenancy": tenancy}))
"""


def test_port_round_imports_no_jax_or_reference_package(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["round"] == 0
    assert out["obs_rc"] == 0
    assert out["lm_tokens"] > 0
    assert out["silo_rounds"] == [0, 1, 0, 0, 1]
    assert sorted(out["algos"]) == sorted(
        ["fedopt", "fedavg_robust", "fednova", "hierarchical",
         "turboaggregate", "centralized", "decentralized", "contribution",
         "fedseg", "split_nn", "vertical_fl", "fedgkt", "fednas",
         "fedavg_async_quorum", "fedavg_async_fedasync"])
    assert "partial_rounds" in out["algos"]["fedavg_async_quorum"]
    assert "mean_staleness" in out["algos"]["fedavg_async_fedasync"]
    assert {"genotype", "retrain_test_acc"} <= set(out["algos"]["fednas"])
    assert "test_acc" in out["algos"]["fedgkt"]
    assert "test_mIoU" in out["algos"]["fedseg"]
    assert "regret" in out["algos"]["decentralized"]
    assert "influence" in out["algos"]["contribution"]
    assert out["slice_c"]["bn_stats_moved"]
    assert out["slice_c"]["rnn_tokens"] > 0
    assert out["tenancy"] == {"ta": 2, "tb": 1}
    for m in ("ops.aggregate", "ops.flash_attention", "models.transformer",
              "ops.quantize", "comm.compression",
              "algorithms.fedavg_cross_silo", "algorithms.fedopt",
              "algorithms.fedavg_robust", "algorithms.fednova",
              "algorithms.hierarchical", "algorithms.turboaggregate",
              "algorithms.centralized", "algorithms.decentralized",
              "contribution.loo", "contribution.shap", "core.robust",
              "core.mpc", "core.topology", "data.poisoned",
              "trainer.torch_trainer", "trainer.model_trainer",
              "experiments.fed_launch", "models.resnet", "models.resnet_gn",
              "models.rnn", "data.leaf", "data.leaf_gen",
              "models.mobilenet", "models.mobilenet_v3", "models.vgg",
              "models.efficientnet", "models.segnet", "algorithms.fedseg",
              "models.vfl", "models.resnet_gkt", "models.darts",
              "models.darts_eval", "models.darts_visualize",
              "algorithms.split_nn", "algorithms.vertical_fl",
              "algorithms.fedgkt", "algorithms.fednas", "comm.reliable",
              "comm.tcp", "comm.grpc_backend", "comm.grpc_proto",
              "comm.mqtt", "comm.routed", "native", "utils.checkpoint",
              "utils.context", "state.store", "state.residuals",
              "algorithms.base_framework", "obs", "obs.flight", "obs.merge",
              "obs.perf", "obs.anomaly", "obs.registry", "obs.tail",
              "obs.report", "obs.trend", "obs.__main__", "utils.flops",
              "utils.fsio", "utils.watchdog", "utils.tracing",
              "comm.faults", "algorithms.fedavg_async", "control",
              "control.checkpoint", "control.pace", "control.manifest",
              "control.failover_harness", "sched", "sched.jobs",
              "sched.router", "sched.interleave", "sched.launcher",
              "sched.chaos", "sched.__main__", "comm.fanout_smoke"):
        assert f"fedml_tpu_torch.{m}" in out["modules"]
    bad = [m for m in out["modules"] if FORBIDDEN.match(m)
           or REFERENCE.search(m)]
    assert not bad, bad


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|msgpack|fedml_tpu)"
    r"(?:\.|\s|$)"
    r"|import_module\(\s*['\"](jax|flax|optax|msgpack|fedml_tpu)"
    r"(?:\.|['\"])"
    r"|__import__\(\s*['\"](jax|flax|optax|msgpack|fedml_tpu)"
    r"(?:\.|['\"])",
    re.MULTILINE)


def _port_sources():
    files = sorted((ROOT / "fedml_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_static_scan_finds_no_forbidden_import():
    files = _port_sources()
    assert len(files) > 20
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip())
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not hits, hits


def test_static_scan_catches_a_planted_import():
    planted = "import torch\nfrom fedml_tpu.core import sampling\n"
    assert _IMPORT.search(planted)
    assert _IMPORT.search("    import jax.numpy as jnp\n")
    assert _IMPORT.search("import msgpack\n")
    assert FORBIDDEN.match("msgpack") and FORBIDDEN.match("msgpack.fallback")
    assert not _IMPORT.search("from fedml_tpu_torch.core import sampling\n")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_fedavg_api_default_device_raises_without_cuda(no_cuda):
    ds = make_blob_federated(client_num=4, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FedAvgAPI(ds, create_model("lr", ds.class_num, input_shape=(20,)))


def test_main_default_device_raises_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_fedavg.main(["--comm_round", "1", "--run_dir", str(tmp_path)])
    # nothing was built or written before the refusal
    assert not list(tmp_path.iterdir())
