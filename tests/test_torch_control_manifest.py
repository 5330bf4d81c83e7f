"""The server snapshot's field manifest (``fedml_tpu_torch/control/
manifest.py``): the contract the JAX package's lint rule FT009 enforces,
checked here without porting the analyzer.

An AST walk over the port's round-based server classes finds every
``self.<attr>`` they write outside ``__init__`` (assignments, augmented
and subscript stores, tuple targets, and the in-place container
mutators FT009 lists); each must be in exactly one of
``SERVER_CHECKPOINT_FIELDS`` and ``SERVER_EPHEMERAL_FIELDS``. Then the
captured state's keys equal the JAX capture's on the same fixture."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from fedml_tpu.algorithms import fedavg_async as jasync
from fedml_tpu.algorithms import fedavg_cross_silo as jcs
from fedml_tpu.control import manifest as jmanifest
from fedml_tpu.control.failover_harness import build_fixture as jfixture
from fedml_tpu_torch.algorithms import fedavg_async as pasync
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.control import manifest
from fedml_tpu_torch.control.failover_harness import build_fixture

ROOT = Path(__file__).resolve().parent.parent
MODULES = ("fedml_tpu_torch/algorithms/fedavg_cross_silo.py",
           "fedml_tpu_torch/algorithms/fedavg_async.py")
SERVERS = {"FedAvgServerManager", "FedOptServerManager",
           "QuorumFedAvgServerManager"}
#: FT009's in-place mutators (fedml_tpu/analysis/rules/server_state.py)
MUTATORS = frozenset({"append", "appendleft", "add", "update", "extend",
                      "insert", "setdefault", "pop", "popitem", "clear",
                      "discard", "remove"})
#: where the port's capture is allowed to differ from JAX's: nowhere
DOCUMENTED_KEY_DIFFERENCES: dict = {}


def _self_attr(node):
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _targets(node):
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in MUTATORS:
        targets = [node.func.value]
    else:
        return []
    flat = []
    while targets:
        t = targets.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            targets.extend(t.elts)
        else:
            flat.append(t)
    return flat


def mutated_fields(source: str):
    """{class name: {attr: first line}} of the server classes' writes
    outside ``__init__``."""
    out = {}
    for cls in ast.walk(ast.parse(source)):
        if not isinstance(cls, ast.ClassDef) or not any(
                "ServerManager" in (getattr(b, "id", None)
                                    or getattr(b, "attr", ""))
                for b in cls.bases):
            continue
        if cls.name in manifest.UNCHECKPOINTED_SERVER_CLASSES:
            continue
        found = out.setdefault(cls.name, {})
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef) \
                    or method.name == "__init__":
                continue
            for node in ast.walk(method):
                for t in _targets(node):
                    attr = _self_attr(t)
                    if attr:
                        found.setdefault(attr, node.lineno)
    return out


def test_every_mutated_server_field_is_in_exactly_one_set():
    both = manifest.SERVER_CHECKPOINT_FIELDS & manifest.SERVER_EPHEMERAL_FIELDS
    assert not both, both
    allowed = (manifest.SERVER_CHECKPOINT_FIELDS
               | manifest.SERVER_EPHEMERAL_FIELDS)
    seen = {}
    for rel in MODULES:
        for cls, fields in mutated_fields((ROOT / rel).read_text()).items():
            seen[cls] = fields
            missing = {f: f"{rel}:{line}" for f, line in fields.items()
                       if f not in allowed}
            assert not missing, (cls, missing)
    assert SERVERS <= set(seen)
    assert "AsyncFedAvgServerManager" not in seen  # exempt: no schedule
    # the fields the control plane added are covered
    for f in ("cp_counters", "_model_version", "_gm_capture_cache",
              "_control_restored", "_finished", "_timer"):
        assert f in seen["FedAvgServerManager"], f
    assert "server_opt_state" in seen["FedOptServerManager"]
    assert "partial_rounds" in seen["QuorumFedAvgServerManager"]


def test_the_walk_catches_a_new_field():
    planted = '''
class Planted(FedAvgServerManager):
    def __init__(self):
        self.built = 0
    def handle(self, msg):
        self.round_idx += 1
        self.fresh_counter[msg] = 1
        a, self.other = 1, 2
        self.log.append(msg)
        self.liveness.evictions = 3
'''
    fields = mutated_fields(planted)["Planted"]
    assert set(fields) == {"round_idx", "fresh_counter", "other", "log"}
    allowed = (manifest.SERVER_CHECKPOINT_FIELDS
               | manifest.SERVER_EPHEMERAL_FIELDS)
    assert {"fresh_counter", "other", "log"} - allowed == {
        "fresh_counter", "other", "log"}


def test_the_manifest_keeps_the_jax_names_and_stays_import_light():
    assert jmanifest.SERVER_CHECKPOINT_FIELDS \
        == manifest.SERVER_CHECKPOINT_FIELDS
    # the port's additions are all restart-fresh, each with its reason
    assert jmanifest.SERVER_EPHEMERAL_FIELDS \
        <= manifest.SERVER_EPHEMERAL_FIELDS
    assert manifest.SERVER_EPHEMERAL_FIELDS \
        - jmanifest.SERVER_EPHEMERAL_FIELDS == {
            "_timer_lock", "_finished", "device", "_wire_credited_up",
            "_wire_credited_down", "_wan_pending_joins",
            "_wan_join_deferrals", "_server_tx"}
    assert manifest.UNCHECKPOINTED_SERVER_CLASSES \
        == jmanifest.UNCHECKPOINTED_SERVER_CLASSES
    tree = ast.parse((ROOT / "fedml_tpu_torch/control/manifest.py")
                     .read_text())
    imports = [n for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert all(isinstance(n, ast.ImportFrom) and n.module == "__future__"
               for n in imports)


class _Com:
    sent = ()

    def add_observer(self, obs):
        pass


def _servers(kind):
    ds, module, _ = build_fixture(3)
    gm = cs._initial_model(module, 0, torch.device("cpu"), None)
    jds, jmod, _ = jfixture(3)
    jgm = jmod.init(jax.random.key(0),
                    jnp.asarray(jds.train_data_global[0][:1]), train=False)
    args = (0, 4, _Com())
    if kind == "fedavg":
        return (cs.FedAvgServerManager(*args, cs.FedAvgAggregator(3), 8,
                                       ds.client_num, gm,
                                       round_deadline_s=30.0),
                jcs.FedAvgServerManager(*args, jcs.FedAvgAggregator(3), 8,
                                        jds.client_num, jgm,
                                        round_deadline_s=30.0))
    if kind == "fedopt":
        names = [n for n, _ in module.named_parameters()]
        return (cs.FedOptServerManager(*args, cs.FedAvgAggregator(3), 8,
                                       ds.client_num, gm, param_names=names),
                jcs.FedOptServerManager(*args, jcs.FedAvgAggregator(3), 8,
                                        jds.client_num, jgm))
    return (pasync.QuorumFedAvgServerManager(
                *args, cs.FedAvgAggregator(3), 8, ds.client_num, gm,
                quorum=2),
            jasync.QuorumFedAvgServerManager(
                *args, jcs.FedAvgAggregator(3), 8, jds.client_num, jgm,
                quorum=2))


@pytest.mark.parametrize("kind", ["fedavg", "fedopt", "quorum"])
def test_the_capture_has_the_jax_captures_keys(kind):
    ours, theirs = _servers(kind)
    got, want = ours._capture_control_state(), theirs._capture_control_state()
    assert set(got) ^ set(want) == set(DOCUMENTED_KEY_DIFFERENCES)
    assert set(got["agg_fold"]) == set(want["agg_fold"])
    assert set(got["global_model"]) == set(ours.global_model)
    for key in ("round_idx", "comm_round", "worker_num", "bcast_seq",
                "evict_on_deadline", "live", "evictions", "rejoins",
                "uploaded_flags", "round_deadline_s", "min_quorum_frac",
                "extensions_this_round", "round_cohort", "pace",
                "mirror", "mirror_fp", "pending_models", "pending_weights"):
        assert got[key] == want[key], key
    if kind == "quorum":
        assert got["partial_rounds"] == want["partial_rounds"] == []
        assert got["quorum"] == want["quorum"] == 2
