"""The port's algorithm templates (``algorithms/base_framework.py``) and
federation error context (``utils/context.py``) against the JAX package's.

The JAX templates sum the "information" with ``jnp.add``, so a Python
float comes back as an f32 array there and stays a float64 here: the two
agree to f32 precision (rtol 1e-6), not bit for bit.
"""

import threading

import numpy as np
import pytest

from fedml_tpu_torch.algorithms.base_framework import (
    BaseCentralWorker, run_base_framework_distributed,
    run_decentralized_framework_demo)
from fedml_tpu_torch.utils.context import FederationErrors, federation_guard

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-6, atol=1e-6)


def _local(global_info, round_idx):
    """A template clone: the information is a nest of arrays and floats
    that depends on the round and on what the server sent."""
    b = float(np.asarray(global_info["b"]))
    return {"a": np.ones(3) * (round_idx + 1) + 0.25 * b,
            "b": 2.0, "c": [np.arange(2.0), 0.5 * round_idx]}


INIT = {"a": np.zeros(3), "b": 0.0, "c": [np.zeros(2), 0.0]}


@pytest.mark.parametrize("client_num, max_round, local", [
    (4, 3, None), (3, 2, "nest"), (2, 0, None)])
def test_central_template_matches_jax(client_num, max_round, local):
    from fedml_tpu.algorithms.base_framework import \
        run_base_framework_distributed as jax_run
    kw = dict(client_num=client_num, max_round=max_round)
    if local:
        kw.update(local_fn=_local, init_info=INIT)
    want = jax_run(**kw).global_history
    got = run_base_framework_distributed(**kw).global_history
    assert len(got) == len(want) == max_round
    for g, w in zip(got, want):
        if local:
            np.testing.assert_allclose(g["a"], np.asarray(w["a"]), **F32)
            np.testing.assert_allclose(g["b"], float(w["b"]), **F32)
            np.testing.assert_allclose(g["c"][0], np.asarray(w["c"][0]),
                                       **F32)
            np.testing.assert_allclose(g["c"][1], float(w["c"][1]), **F32)
        else:
            assert g == pytest.approx(float(w)) == float(
                sum(range(1, client_num + 1)))


@pytest.mark.parametrize("worker_num, max_round, neighbor_num", [
    (6, 10, 2), (5, 4, 4), (1, 3, 2)])
def test_decentralized_demo_matches_jax(worker_num, max_round, neighbor_num):
    from fedml_tpu.algorithms.base_framework import \
        run_decentralized_framework_demo as jax_demo
    want = jax_demo(worker_num, max_round, neighbor_num=neighbor_num)
    got = run_decentralized_framework_demo(worker_num, max_round,
                                           neighbor_num=neighbor_num)
    assert all(w.done.is_set() for w in got)
    for g, w in zip(got, want):
        assert g.in_neighbors == w.in_neighbors
        assert g.out_neighbors == w.out_neighbors
        assert len(g.history) == len(w.history) == max_round
        np.testing.assert_allclose(np.asarray(g.history, np.float64),
                                   np.asarray(w.history, np.float64),
                                   rtol=1e-6, atol=1e-6)


def test_decentralized_gossip_reaches_consensus():
    workers = run_decentralized_framework_demo(worker_num=6, max_round=25)
    finals = [w.value for w in workers]
    assert np.std(finals) < 0.05
    assert min(finals) >= 1.0 - 1e-6 and max(finals) <= 6.0 + 1e-6


def test_a_failing_client_raises_on_the_caller():
    def bad(global_info, round_idx):
        raise ValueError("client blew up")
    with pytest.raises(ValueError, match="client blew up"):
        run_base_framework_distributed(client_num=2, max_round=2,
                                       local_fn=bad)


def test_custom_aggregate_sees_the_clients_in_order():
    seen = []

    def agg(infos):
        seen.append(list(infos))
        return max(infos)
    res = run_base_framework_distributed(
        client_num=3, max_round=2, aggregate_fn=agg,
        local_fn=lambda g, r: float(10 * r + 1))
    assert seen == [[1.0, 1.0, 1.0], [11.0, 11.0, 11.0]]
    assert res.global_history == [1.0, 11.0]
    worker = BaseCentralWorker(2)
    worker.add_client_local_result(1, 5.0)
    assert not worker.check_whether_all_receive()
    worker.add_client_local_result(0, 2.0)
    assert worker.check_whether_all_receive() and worker.aggregate() == 7.0


class _Manager:
    def __init__(self, fail=False):
        self.finished = 0
        self.fail = fail

    def finish(self):
        self.finished += 1
        if self.fail:
            raise RuntimeError("already stopped")


def test_federation_guard_records_and_stops_every_manager():
    errors = FederationErrors()
    managers = [_Manager(), _Manager(fail=True), _Manager()]
    with federation_guard(errors, managers, rank=2):
        raise KeyError("rank 2 died")
    assert isinstance(errors.first, KeyError)
    assert [m.finished for m in managers] == [1, 1, 1]
    with federation_guard(errors, managers, rank=3):
        pass  # a clean rank records nothing
    with pytest.raises(KeyError, match="rank 2 died"):
        errors.reraise()


def test_federation_errors_keep_the_first_of_many_threads():
    errors = FederationErrors()
    first = threading.Event()

    def fail(i):
        if i:
            first.wait(5)
        errors.record(RuntimeError(f"rank {i}"))
        if not i:
            first.set()
    threads = [threading.Thread(target=fail, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    assert str(errors.first) == "rank 0"
    FederationErrors().reraise()  # nothing recorded: no raise
