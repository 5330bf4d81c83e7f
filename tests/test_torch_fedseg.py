"""FedSeg in the port against the JAX package: the segmentation heads (CE
with 255 ignored, focal), the LR schedule in each mode, the confusion
metrics (``SegEvaluator`` and the batched confusion eval on a SegNet), two
``FedSegAPI`` rounds from the same weights under both losses (shuffle
off), and the launcher's ``--algo fedseg`` on the CPU.

Tolerances: head sums and the schedule rtol 1e-6 (the same f32 formulas);
the rounds' params rtol 1e-4, atol 1e-5 (torch and XLA sum a
convolution's terms in another order), their losses rtol 1e-5; the IoU
metrics exactly (the same pixel counts).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.algorithms import fedseg as jax_fedseg
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.data.synthetic import \
    make_shapes_segmentation as jax_shapes
from fedml_tpu.models.segnet import SegNet as FlaxSegNet
from fedml_tpu.trainer import tasks as jax_tasks
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms import fedseg
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
from fedml_tpu_torch.data.synthetic import make_shapes_segmentation
from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.models.segnet import SegNet
from fedml_tpu_torch.trainer import tasks
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import flax_to_state_dict


def _logits_and_targets(seed=0, shape=(3, 5, 6), classes=4):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, classes) * 2).astype(np.float32)
    targets = rng.randint(0, classes, shape).astype(np.int32)
    targets[rng.rand(*shape) < 0.2] = tasks.IGNORE_INDEX
    mask = np.ones(shape[0], np.float32)
    mask[-1] = 0.0  # a padding row
    return logits, targets, mask


@pytest.mark.parametrize("head", ["segmentation", "segmentation_focal"])
def test_heads_match_jax(head):
    logits, targets, mask = _logits_and_targets()
    got = tasks.TASK_HEADS[head](*map(torch.from_numpy,
                                      (logits, targets, mask)))
    want = jax_tasks.TASK_HEADS[head](*map(jnp.asarray,
                                           (logits, targets, mask)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    # ignored pixels and padding rows count nowhere
    valid = (targets != tasks.IGNORE_INDEX) & (mask[:, None, None] > 0)
    assert float(got["count"]) == valid.sum()


def test_focal_is_the_weighted_ce():
    logits, targets, mask = _logits_and_targets(seed=1)
    args = [torch.from_numpy(a) for a in (logits, targets, mask)]
    ce = tasks.segmentation_head(*args)
    # gamma 0, alpha 1: the focal loss is the cross entropy
    focal = tasks.segmentation_focal_head(*args, gamma=0.0, alpha=1.0)
    for k in ce:
        torch.testing.assert_close(focal[k], ce[k])


@pytest.mark.parametrize("mode, kw", [
    ("cos", {}), ("poly", {}), ("step", dict(lr_step=2)),
    ("cos", dict(warmup_epochs=1))], ids=["cos", "poly", "step", "warmup"])
def test_lr_schedule_matches_jax(mode, kw):
    args = (mode, 0.01, 5, 7)
    got = fedseg.make_lr_schedule(*args, **kw)
    want = jax_fedseg.make_lr_schedule(*args, **kw)
    steps = np.arange(0, 35)
    a = np.array([float(got(int(s))) for s in steps])
    b = np.array([float(want(int(s))) for s in steps])
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    assert a[0] == (0.0 if "warmup_epochs" in kw else np.float32(0.01))
    with pytest.raises(NotImplementedError):
        fedseg.make_lr_schedule("linear", 0.01, 5, 7)


def test_evaluator_matches_jax():
    rng = np.random.RandomState(2)
    gt = rng.randint(0, 4, (3, 8, 8)).astype(np.int32)
    gt[0, :2] = tasks.IGNORE_INDEX
    pred = rng.randint(0, 4, (3, 8, 8)).astype(np.int32)
    pred[gt == 1] = 1  # class 1 always right, class 3 never predicted
    pred[pred == 3] = 0
    ev, ref = fedseg.SegEvaluator(4), jax_fedseg.SegEvaluator(4)
    for i in range(3):
        ev.add_batch(gt[i], torch.from_numpy(pred[i]))
        ref.add_batch(gt[i], pred[i])
    assert np.array_equal(ev.confusion_matrix, ref.confusion_matrix)
    for m in ("pixel_accuracy", "pixel_accuracy_class", "mean_iou",
              "frequency_weighted_iou"):
        assert getattr(ev, m)() == getattr(ref, m)(), m
    ev.reset()
    assert not ev.confusion_matrix.any()


def _fast_init(start):
    """flax's ``init`` returning ``start`` (the JAX API inits its model
    eagerly, seconds a model here; its weights are replaced anyway)."""
    return mock.patch.object(FlaxSegNet, "init", lambda *a, **k: start)


def _segnet_start(x, seed=3):
    flax_model = FlaxSegNet(num_classes=3, width=8)
    return flax_model, jax.jit(flax_model.init)(jax.random.key(seed), x)


def test_confusion_eval_matches_jax():
    ds = make_shapes_segmentation(client_num=2, samples_per_client=5)
    x, y = ds.train_data_global  # 10 images: the last batch of 3 is padded
    flax_model, v = _segnet_start(jnp.asarray(x[:1]))
    model = SegNet(3, 8)
    sd = flax_to_state_dict(jax.tree.map(np.asarray, v), model)
    got = fedseg.make_confusion_eval(model, 3, batch_size=3)(
        sd, torch.from_numpy(x), torch.from_numpy(y))
    want = jax_fedseg.make_confusion_eval(flax_model, 3, batch_size=3)(
        v, jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == y.size


@pytest.mark.parametrize("loss_mode", ["ce", "focal"])
def test_two_fedseg_rounds_match_jax(loss_mode):
    kw = dict(epochs=1, batch_size=4, lr=0.1, shuffle=False)
    rounds = dict(comm_round=2, client_num_per_round=2,
                  frequency_of_the_test=1)
    jds = jax_shapes(client_num=3, samples_per_client=6)
    ds = make_shapes_segmentation(client_num=3, samples_per_client=6)
    flax_model, start = _segnet_start(jnp.asarray(
        ds.train_data_global[0][:1]))
    with _fast_init(start):
        ref = jax_fedseg.FedSegAPI(jds, flax_model, config=JaxFedAvgConfig(
            train=JaxTrainConfig(**kw), **rounds), loss_mode=loss_mode)
    model = SegNet(3, 8)
    api = fedseg.FedSegAPI(ds, model, config=FedAvgConfig(
        train=TrainConfig(**kw), **rounds), loss_mode=loss_mode,
        device="cpu")
    api.variables = flax_to_state_dict(jax.tree.map(np.asarray, start),
                                       model)
    for r in range(2):
        want_idxs, _ = ref.run_round(r)
        idxs, _ = api.run_round(r)
        assert list(idxs) == list(want_idxs)
        got, want = api.evaluate(r), ref.evaluate(r)
        assert set(got) == set(want)
        for k in ("test_mIoU", "test_FWIoU", "test_acc_class", "test_acc"):
            assert got[k] == want[k], k
        for k in ("test_loss", "train_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables),
                              model)
    for k in want:
        np.testing.assert_allclose(api.variables[k].numpy(),
                                   want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("seg_loss", ["ce", "focal"])
def test_launcher_runs_fedseg_on_the_cpu(seg_loss, tmp_path):
    final = fed_launch.main([
        "--algo", "fedseg", "--dataset", "seg_shapes", "--seg_loss",
        seg_loss, "--client_num_in_total", "4", "--client_num_per_round",
        "2", "--batch_size", "8", "--lr", "0.1", "--comm_round", "3",
        "--frequency_of_the_test", "1", "--device", "cpu", "--run_dir",
        str(tmp_path / "run")])
    for k in ("test_mIoU", "test_FWIoU", "test_acc_class", "test_loss"):
        assert np.isfinite(final[k]), k
    assert 0.0 <= final["test_mIoU"] <= 1.0


def test_launcher_refuses_fedseg_without_pixel_labels(tmp_path):
    with pytest.raises(SystemExit, match="per-pixel labels"):
        fed_launch.main(["--algo", "fedseg", "--dataset", "blob",
                         "--device", "cpu", "--run_dir",
                         str(tmp_path / "run")])


def test_fedseg_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        fed_launch.main(["--algo", "fedseg", "--dataset", "seg_shapes",
                         "--run_dir", str(tmp_path / "run")])
    with pytest.raises(RuntimeError):
        fedseg.FedSegAPI(make_shapes_segmentation(client_num=2),
                         SegNet(3, 8))
