"""Smoke run of fedml_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

1. finds the card, prints its name and power limit, builds the CUDA kernels
   from csrc/ (printing nvcc's -Xptxas -v lines) and prints the TF32
   settings;
2. holds the aggregation kernel against its plain PyTorch version on the
   card, at the FedAvg CNN's shape [10, 1,206,590] and at edge shapes, and
   times kernel, plain version and one library call with CUDA events;
3. drives the main path through its entry point,
   ``fedml_tpu_torch.experiments.main_fedavg.main``: 5 FedAvg rounds of the
   62-class FEMNIST CNN on femnist_gen (10 clients a round, batch 20, lr
   0.1), checks that the kernel launched once per round and that the test
   loss fell, then times further rounds;
4. runs one logistic-regression round on the card and on the CPU from the
   same weights (TF32 off) and compares the parameters.

Any failure raises, and the script exits non-zero without printing a
result. Before the last line it prints one ``{"kernels": [...]}`` JSON
line; the last line is ``{"ok": true, "device": {...}}``. The full record
goes to runs/chip_smoke/record.json, beside the main path's metrics.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# one H100 SXM (NVIDIA's data sheet): HBM bytes/s and f32 (non-tensor-core)
# FLOP/s, the two peaks that bound the aggregation kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TOL = dict(rtol=1e-5, atol=1e-6)
HEADLINE = (10, 1_206_590)  # clients per round x CNN parameters


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:7.1f}s] {msg}",
          flush=True)


def cuda_time_ms(fn, args_list, iters: int) -> float:
    """Device ms per call: ``iters`` calls cycling through ``args_list``
    (distinct buffers, larger than L2 together) are captured in one CUDA
    graph, so the host's launch overhead is out of the time, then replayed
    once to warm up and once between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # eager warm-up, off the capture
        for a in args_list:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device_and_build():
    import torch
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops.build import load_library

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    t = time.perf_counter()
    lib = load_library("aggregate")
    aggregate._kernel()
    log(f"built {lib.path} in {time.perf_counter() - t:.1f}s")
    for line in lib.build_log.splitlines():
        if "ptxas" in line:
            print(line, flush=True)
    tf32 = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision":
                torch.get_float32_matmul_precision()}
    log(f"TF32 settings for the run: {tf32}")
    return {"smi": smi, "tf32": tf32}


def phase_kernel_vs_plain():
    import torch
    from fedml_tpu_torch.ops.aggregate import (takes_vec4_path,
                                               weighted_mean_flat,
                                               weighted_mean_flat_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def stack(c, d, row_padded):
        ld = -(-d // 4) * 4 if row_padded else d
        buf = torch.randn(c, ld, generator=gen, device=dev)
        w = torch.randint(20, 401, (c,), generator=gen, device=dev).float()
        return buf[:, :d], w

    cases = [("headline", *HEADLINE, True, True),
             ("one_client", 1, HEADLINE[1], True, True),
             ("fifty_clients", 50, HEADLINE[1], True, True),
             ("ragged_contiguous", 7, 1_000_003, False, False)]
    checks, max_abs = [], 0.0
    for name, c, d, row_padded, vec4 in cases:
        x, w = stack(c, d, row_padded)
        got = weighted_mean_flat(x, w)
        torch.cuda.synchronize()
        want = weighted_mean_flat_reference(x, w)
        err = (got - want).abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp(min=1e-30)).max())
        if not torch.allclose(got, want, **TOL):
            raise AssertionError(f"{name} [{c}, {d}]: kernel disagrees with "
                                 f"the plain version (max abs {abs_err})")
        if takes_vec4_path(x, got) != vec4:
            raise AssertionError(f"{name}: expected the "
                                 f"{'16-byte' if vec4 else 'scalar'} path")
        max_abs = max(max_abs, abs_err)
        checks.append({"case": name, "shape": [c, d], "vec4": vec4,
                       "max_abs_err": abs_err, "max_rel_err": rel_err})
        log(f"kernel == plain at {name} [{c}, {d}]: max abs {abs_err:.3g}, "
            f"max rel {rel_err:.3g}")

    # timing at the main path's shape and layout: four distinct stacks
    # (193 MB, beyond the 50 MB L2), as a round finds its stack cold. Each
    # timed call is the whole function from (stack, sample counts): the
    # wrapper's weight normalization (two tiny kernels) is in its time, and
    # in the plain version's and the library call's
    c, d = HEADLINE
    bufs = [stack(c, d, True) for _ in range(4)]
    iters = 200
    ms = cuda_time_ms(weighted_mean_flat, bufs, iters)
    plain_ms = cuda_time_ms(weighted_mean_flat_reference, bufs, iters)
    library_ms = cuda_time_ms(lambda x, w: torch.mv(x.t(), w / w.sum()),
                              bufs, iters)
    nbytes = 4 * (c * d + c + d)  # read x and w once, write out once
    flops = 2 * c * d
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / F32_FLOP_PER_S else "operations")
    log(f"wmean [{c}, {d}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.mv {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB) -> {nbytes / ms / 1e6:.0f} GB/s")
    return {"checks": checks, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


def phase_main_path():
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops.aggregate import flatten_stack
    from fedml_tpu_torch.utils.metrics import read_metrics

    rounds = 5
    flags = ["--dataset", "femnist_gen", "--client_num_in_total", "200",
             "--client_num_per_round", "10", "--batch_size", "20",
             "--epochs", "1", "--lr", "0.1", "--comm_round", str(rounds),
             "--frequency_of_the_test", "4", "--device", "cuda"]
    run_dir = os.path.join(ROOT, "runs", "chip_smoke")
    shutil.rmtree(run_dir, ignore_errors=True)

    aggregate.weighted_mean_flat.launches = 0
    t = time.perf_counter()
    main_fedavg.main(flags + ["--run_dir", run_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = aggregate.weighted_mean_flat.launches

    if launches != rounds:
        raise AssertionError(f"aggregation kernel launched {launches} times "
                             f"in {rounds} rounds")
    recs = read_metrics(run_dir)
    for r in recs:
        for k in ("train_loss", "test_loss", "train_acc", "test_acc"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"round {r['round']}: {k}={r[k]}")
    if [r["round"] for r in recs] != [0, 4]:
        raise AssertionError(f"eval rounds {[r['round'] for r in recs]}")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"test loss did not fall: {recs[0]['test_loss']}"
                             f" -> {recs[-1]['test_loss']}")
    log(f"main path: {rounds} rounds, {launches} kernel launches, test loss "
        f"{recs[0]['test_loss']:.4f} -> {recs[-1]['test_loss']:.4f}, acc "
        f"{recs[0]['test_acc']:.4f} -> {recs[-1]['test_acc']:.4f} "
        f"(wall {wall:.1f}s with data build and eval)")

    # rounds/s on the same configuration, through the same API
    args = main_fedavg.add_federated_args(
        argparse.ArgumentParser()).parse_args(flags)
    ds, model, task = main_fedavg.build_dataset_and_model(args)
    api = FedAvgAPI(ds, model, task=task, device="cuda", config=FedAvgConfig(
        comm_round=12, client_num_per_round=10, frequency_of_the_test=100,
        train=main_fedavg.make_train_config(args)))
    api.run_round(0)
    api.run_round(1)
    torch.cuda.synchronize()
    timed = 10
    t = time.perf_counter()
    for r in range(2, 2 + timed):
        api.run_round(r)
    torch.cuda.synchronize()
    rps = timed / (time.perf_counter() - t)
    phases = {k: v * 1e3 for k, v in api.timer.means().items()}
    name = torch.cuda.get_device_name(0)
    log(f"{rps:.3f} rounds/s on {name} (FEMNIST CNN, 10 clients x batch 20, "
        f"host loop over clients); phase means ms {phases}")

    # the front end's flatten copy of one round's stacked state dicts
    stacked = {k: torch.stack([v] * 10) for k, v in api.variables.items()}
    flatten_ms = cuda_time_ms(flatten_stack, [(stacked,)], 200)
    log(f"front-end flatten of [10, {sum(v.numel() for v in api.variables.values())}]:"
        f" {flatten_ms:.4f} ms")
    return {"launches": launches, "evals": recs, "wall_s": wall,
            "rounds_per_s": rps, "phase_ms": phases,
            "flatten_ms": flatten_ms}


def phase_card_vs_cpu():
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ds = make_blob_federated(client_num=8, seed=0)
        cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                           prefetch_depth=0,
                           train=TrainConfig(epochs=2, batch_size=16, lr=0.1,
                                             shuffle=False))
        apis = [FedAvgAPI(ds, create_model("lr", ds.class_num,
                                           input_shape=(20,)),
                          config=cfg, device=d) for d in ("cuda", "cpu")]
        for k in apis[1].variables:
            if not torch.equal(apis[0].variables[k].cpu(),
                               apis[1].variables[k]):
                raise AssertionError(f"initial {k} differs across devices")
        for api in apis:
            api.run_round(0)
        diff = max(float((apis[0].variables[k].cpu()
                          - apis[1].variables[k]).abs().max())
                   for k in apis[1].variables)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if not diff <= 1e-5:
        raise AssertionError(f"LR round card vs CPU: max abs diff {diff}")
    log(f"LR round, card vs CPU: max abs param diff {diff:.3g} (atol 1e-5)")
    return {"max_abs_diff": diff}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    record = {"device": phase_device_and_build()}
    record["kernel"] = phase_kernel_vs_plain()
    record["main_path"] = phase_main_path()
    record["card_vs_cpu"] = phase_card_vs_cpu()
    k = record["kernel"]
    kernels = {"kernels": [{
        "name": "wmean_f32", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/aggregate.cu",
        "replaces": "fedml_tpu/ops/aggregate.py:27",
        "launches": record["main_path"]["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]}
    with open(os.path.join(ROOT, "runs", "chip_smoke", "record.json"),
              "w") as f:
        json.dump({**record, **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


T0 = time.perf_counter()

if __name__ == "__main__":
    main()
