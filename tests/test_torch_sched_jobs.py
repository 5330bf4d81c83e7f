"""The port's job specs (``fedml_tpu_torch/sched/jobs.py``) against the JAX
package's: the same fields and defaults, the same refusals with the same
messages, the same ``to_json``, and fixtures built from the same data."""

import json

import numpy as np
import pytest

from fedml_tpu.sched import jobs as jjobs
from fedml_tpu_torch.sched import jobs as pjobs

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPECS = [
    {"id": "ads", "workers": 3, "rounds": 8, "share": 2.0},
    {"id": "asr", "workers": 2, "rounds": 6},
    {"id": "b.2_x-y", "dataset": "blob", "seed": 7, "dim": 6,
     "class_num": 2, "n_samples": 150, "batch_size": 10, "lr": 0.1,
     "compression": "topk_ef_int8:0.1", "round_deadline_s": 2.0,
     "heartbeat_s": 0.3, "pace_steering": True, "join_rate_limit": 5.0,
     "max_deadline_extensions": None, "clients": 6, "wd": 0.01},
    {"id": "cnn", "dataset": "femnist_gen", "workers": 4, "rounds": 3,
     "batch_size": 20, "compression": "delta_int8", "serve_port": 0},
]

#: (dict, why): each is refused by both packages with the same message
BAD = {
    "unknown_key": {"id": "x", "sahre": 2.0},
    "missing_id": {"workers": 2},
    "bad_id": {"id": "../evil"},
    "empty_id": {"id": ""},
    "zero_workers": {"id": "x", "workers": 0},
    "zero_rounds": {"id": "x", "rounds": 0},
    "zero_share": {"id": "x", "share": 0.0},
    "negative_share": {"id": "x", "share": -1.0},
    "not_an_object": ["id", "x"],
}


def _error(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


def test_fields_and_defaults_are_the_jax_packages():
    assert pjobs._FIELDS == jjobs._FIELDS
    assert pjobs.JobSpec(id="x").to_json() == jjobs.JobSpec(id="x").to_json()


@pytest.mark.parametrize("obj", SPECS, ids=[s["id"] for s in SPECS])
def test_to_json_equal_for_the_same_dict(obj):
    port, ref = pjobs.spec_from_dict(obj), jjobs.spec_from_dict(obj)
    assert port.to_json() == ref.to_json()
    assert pjobs.spec_from_dict(port.to_json()) == port


@pytest.mark.parametrize("name", sorted(BAD))
def test_refusals_match_jax(name):
    obj = BAD[name]
    assert _error(pjobs.spec_from_dict, obj) == _error(
        jjobs.spec_from_dict, obj)


@pytest.mark.parametrize("layout", ["list", "object"])
def test_load_jobs_matches_jax(layout, tmp_path):
    path = tmp_path / "jobs.json"
    path.write_text(json.dumps(SPECS if layout == "list"
                               else {"jobs": SPECS}))
    port, ref = pjobs.load_jobs(str(path)), jjobs.load_jobs(str(path))
    assert [s.to_json() for s in port] == [s.to_json() for s in ref]


@pytest.mark.parametrize("text", [
    json.dumps([{"id": "x"}, {"id": "x"}]),   # duplicate ids
    json.dumps([]), json.dumps({"jobs": []}), json.dumps({"job": [1]}),
    json.dumps([{"id": "x", "rounds": 0}])])
def test_load_jobs_refusals_match_jax(text, tmp_path):
    path = tmp_path / "jobs.json"
    path.write_text(text)
    assert _error(pjobs.load_jobs, str(path)) == _error(
        jjobs.load_jobs, str(path))


def test_blob_fixture_is_the_jax_packages():
    spec = SPECS[2]
    pds, module, task, tcfg = pjobs.build_job_fixture(
        pjobs.spec_from_dict(spec))
    jds, jmod, jtask, jtcfg = jjobs.build_job_fixture(
        jjobs.spec_from_dict(spec))
    assert task == jtask == "classification"
    assert pds.client_num == jds.client_num == 6
    for c in range(pds.client_num):
        for got, want in zip(pds.train_data_local_dict[c],
                             jds.train_data_local_dict[c]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for f in ("epochs", "batch_size", "lr", "wd"):
        assert getattr(tcfg, f) == getattr(jtcfg, f)
    assert sum(p.numel() for p in module.parameters()) == 6 * 2 + 2
    # a pure function of the spec: a second build is a new module on the
    # same data
    again = pjobs.build_job_fixture(pjobs.spec_from_dict(spec))
    assert again[1] is not module
    np.testing.assert_array_equal(again[0].train_data_global[0],
                                  pds.train_data_global[0])
