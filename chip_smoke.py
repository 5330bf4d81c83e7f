"""Smoke run of fedml_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

1. finds the card, prints its name and power limit, builds the CUDA kernels
   from csrc/ (one nvcc per source, all started together, printing nvcc's
   -Xptxas -v lines), reads each flash kernel's registers and spills and,
   where the toolkit has cuobjdump, counts its tensor-core (HMMA)
   instructions (every flash kernel instance must have them), and prints
   the TF32 settings;
2. holds the aggregation kernel against its plain PyTorch version on the
   card, at the FedAvg CNN's shape [10, 1,206,590] and at edge shapes, and
   times kernel, plain version and one library call with CUDA events;
3. drives the CNN path through its entry point,
   ``fedml_tpu_torch.experiments.main_fedavg.main``: 5 FedAvg rounds of the
   62-class FEMNIST CNN on femnist_gen (10 clients a round, batch 20, lr
   0.1), checks that the kernel launched once per round and that the test
   loss fell, then times further rounds;
4. runs one logistic-regression round on the card and on the CPU from the
   same weights (TF32 off) and compares the parameters;
4a. drives the same path through ``main_fedavg.main --fused_rounds 5``
   (10 rounds, each a replay of a captured CUDA graph of the round with
   the aggregation kernel inside), checks the kernel's launches (one a
   round, plus a warm-up and a capture launch a graph) and that the test
   loss fell; runs the same cohorts through the host loop and a fused
   block with shuffle and dropout on (cuDNN deterministic) and bounds the
   difference by 1e-6; then times the host loop and fused blocks (median
   and spread of three runs of 10 rounds), profiles each (device ms and
   launch calls a round; the profiler must see one aggregation kernel a
   fused round, as the driver counts) and prints each graph's capture
   time and memory pool;
4b. the same in bf16 off f32 masters (the JAX headline's
   ``bench_fedavg_cnn_fused_headline``), and one bf16 round against an f32
   round from the same weights;
4c. device-sampled fused rounds (cohorts and batch orders drawn on the
   card): distinct cohorts without replacement, and the test loss falls;
5. holds the three flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions on the card, at the LM path's shape [4, 2048, 4,
   64] f32 causal and at edge shapes (D = 128 at S = 2048, a ragged S,
   bf16 at the path's shape, rows that take the kernels' scalar copy
   path), and times kernels, plain versions and
   scaled_dot_product_attention (the library yardstick only: its forward
   for the forward kernel, its backward alone for the backward pair);
6. drives the LM path through ``FedAvgAPI``: 3 FedAvg nwp rounds of the
   full-width TransformerLM (vocab 1024, width 256, depth 4, 4 heads, S =
   2048) with ``make_flash_attention(128, 128)`` on a token federation (4
   clients a round, batch 4, SGD lr 0.3, evaluation at rounds 0 and 2),
   checks every kernel's launch count against the schedule and that the
   test loss fell, then times rounds and the centralized train step with
   the kernels and with SDPA as ``attn_fn``;
7. runs one small transformer round on the card and on the CPU from the
   same weights (TF32 off) and compares the parameters;
7a. runs 2 rounds of the full-width LM in bf16 (the flash kernels' bf16
   instances; launches 12 a step), times 3 more, and one small bf16
   transformer round on the card and on the CPU;
8. holds the int8 quantize kernel (also with its residual output, top-k's
   error-feedback residual in the same launch) and the dequantize kernel
   (also with a minuend) against their plain versions on the card, bit for
   bit, at the CNN's D = 1,206,590, at the top-k survivors' k = 60,330 and
   at edge shapes (D in {1, 511, 512, 513, 2570}, an all-zero block,
   values spanning 1e-30..1e30, random bits with the top bit set, NaN and
   infinite blocks, misaligned views at D and k for the scalar paths),
   checks that torch.mul on the zero-padded [rows, 512] layout gives the
   dequantize's bits, and times kernels, plain versions, that library
   call, an int8 -> f32 copy_ and an empty kernel (the floor of one CUDA
   graph node) at D and k;
9. drives the cross-silo path through ``main_fedavg.main --backend
   inproc``: 2 rounds of ``--compression none``, then 5 rounds each of
   ``delta_int8`` and ``topk_ef_int8:0.05`` of the FEMNIST CNN over 10
   silos, checks both kernels' launch counts against the schedule (54 / 94
   under each: a top-k encode is one quantize launch), that the
   test loss fell, and the uplink frames' array bytes, and prints rounds/s,
   the codec and fold times and the wire bytes a round against ``none``;
10. runs one cross-silo LR round on the card and on the CPU from the same
   weights (TF32 off) under ``none`` and ``topk_ef`` (no random bits) and
   compares the parameters;
11. drives FedOpt with a server Adam on the CNN through
   ``fedml_tpu_torch.experiments.fed_launch.main --algo fedopt``, 10 rounds
   through the host loop and 10 with ``--fused_rounds 5`` (the server step
   inside the captured round), checks the aggregation launches (one a
   round, one more a capture's warm-up round) and that the test loss fell,
   holds a fused block to the host loop (params and Adam state, 1e-6,
   cuDNN deterministic) and a round of server SGD at lr 1 to FedAvg's
   (1e-6), then times both as in 4a;
12. runs the rest of the slice through ``fed_launch.main`` for 2-3 rounds:
   ``fedavg_robust`` on the CNN under every defense (and a fused block
   under ``weak_dp`` against its host loop), ``fednova``, ``hierarchical``
   and ``turboaggregate`` on the CNN, ``centralized``, ``decentralized``
   and ``contribution`` on LR, checking finite metrics, each one's
   aggregation launches and a falling loss where the JAX tests assert one;
13. runs one LR round of FedOpt, FedNova and robust median on the card and
   on the CPU from the same weights (TF32 off) and compares the parameters
   and server state.

Any failure raises, and the script exits non-zero without printing a
result. Before the last line it prints one ``{"kernels": [...]}`` JSON
line; the last line is ``{"ok": true, "device": {...}}``. The full record
goes to runs/chip_smoke/record.json, beside the main path's metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
# one H100 SXM (NVIDIA's data sheet): HBM bytes/s, f32 (non-tensor-core)
# FLOP/s and dense TF32 tensor-core FLOP/s; f32-accurate 3xTF32 takes
# three TF32 products for each f32 one
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TOL = dict(rtol=1e-5, atol=1e-6)
HEADLINE = (10, 1_206_590)  # clients per round x CNN parameters
LM_SHAPE = (4, 2048, 4, 64)  # B, S, H, D of the LM path's attention
LM = dict(vocab_size=1024, width=256, depth=4, num_heads=4, max_len=2048)
LM_LR = 0.3
FLASH_TOL = dict(rtol=1e-4, atol=1e-4)  # f32; bf16 takes 2e-2
SILO_K = 60_330  # top-k survivors of the CNN's delta at keep-fraction 0.05
# the main path's flags (FEMNIST CNN, 200 clients, 10 a round, batch 20)
MAIN_CLIENTS = 200
MAIN_FLAGS = ["--dataset", "femnist_gen", "--client_num_in_total",
              str(MAIN_CLIENTS), "--client_num_per_round", "10",
              "--batch_size", "20", "--epochs", "1", "--lr", "0.1",
              "--device", "cuda"]
FUSED_R = 5  # rounds a fused dispatch
# FedOpt's server Adam step (Reddi et al., 2021, tune it near 1e-2.5 for
# the EMNIST CNN)
FEDOPT_LR = 0.003
# server SGD at lr 1 against FedAvg after one CNN round: w - 1.0 * (w -
# avg) is avg within an ulp of w (3.7e-9 on the card and in a CPU run at a
# cut size; a second round's max pools can route a gradient elsewhere on
# such a difference: 3.5e-4 in that CPU run)
FEDOPT_SGD_TOL = 1e-6
ROBUST_DEFENSES = ("none", "norm_diff_clipping", "weak_dp", "median",
                   "trimmed_mean", "krum")
SLICE_ROUNDS = 3  # rounds of each phase-12 run on the CNN
# bf16 against f32 after one main-path round: its relative L2 distance may
# be at most this multiple of an f32 round's from weights perturbed by
# 2**-9 (a round of ~17 SGD steps at lr 0.1 moves a bf16-sized error
# across ReLU and dropout boundaries: both land ~4% apart in a CPU run)
BF16_VS_F32_FACTOR = 2.0
# ... and at least this multiple of it: a round that ignored compute_dtype
# would land next to the f32 round (the card measured 0.375 of it, 0.0081
# against 0.0216; an f32 round differs from itself only by cuDNN's
# nondeterministic sums)
BF16_VS_F32_MIN_FACTOR = 0.125
# a bf16 transformer round, card against CPU: cuBLAS's and the CPU's bf16
# products round at other places, as the port and XLA do on the CPU
# (tests/test_torch_mixed_precision.py, LM: rtol 1e-2, atol 1e-3, there
# measured 1.4e-4), with twice the room for the flash kernels' bf16 path
LM_BF16_TOL = dict(rtol=2e-2, atol=2e-3)


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


def cuda_time_eager_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` run eagerly ``iters`` times between
    CUDA events after one warm-up call (for calls that a CUDA graph cannot
    capture, such as autograd through a library operator; each call takes
    milliseconds, so the host's launch time is a small part of it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device_and_build():
    import torch
    from fedml_tpu_torch.ops import aggregate, flash_attention, quantize
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
    # one nvcc per source, all started together (each waits in its thread)
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(load_library, ["aggregate", "flash_attention",
                                            "quantize"]))
    aggregate._kernel()
    flash_attention._kernel()
    quantize._kernel()
    log(f"built {[lib.path for lib in libs]} in "
        f"{time.perf_counter() - t:.1f}s (in parallel)")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "ptxas" in line:
                print(line, flush=True)
    flash_report = _flash_kernel_report(libs[1])
    tf32 = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision":
                torch.get_float32_matmul_precision()}
    log(f"TF32 settings for the run: {tf32}")
    return {"smi": smi, "tf32": tf32, "flash_kernels": flash_report}


_FLASH_FN = (r"(flash_(?:fwd|bwd_dkdv|bwd_dq)_kernel)I(\w+?)Li(\d+)E")


def _flash_label(m) -> str:
    """``flash_bwd_dq_kernel<f32,64>`` from a match of ``_FLASH_FN``."""
    dtype = "bf16" if "bfloat16" in m.group(2) else "f32"
    return f"{m.group(1)}<{dtype},{m.group(3)}>"


def _flash_kernel_report(lib):
    """Registers and spill bytes of every flash kernel instance (from the
    build's -Xptxas -v lines, when this process built the library) and its
    count of tensor-core instructions (HMMA/HGMMA in cuobjdump -sass, where
    the toolkit has cuobjdump). Raises if an instance has none."""
    import re
    report, fn = {}, None
    for line in lib.build_log.splitlines():
        m = re.search(_FLASH_FN, line)
        if "Compiling entry function" in line:
            fn = _flash_label(m) if m else None
            if fn:
                report[fn] = {}
        elif fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[fn]["registers"] = int(m.group(1))
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(cuobjdump):
        log("cuobjdump not found: tensor-core instructions not counted")
        return report
    sass = subprocess.run([cuobjdump, "-sass", lib.path], capture_output=True,
                          text=True, check=True).stdout
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(_FLASH_FN, line)
            fn = _flash_label(m) if m else None
            if fn:
                report.setdefault(fn, {})["tensor_core_instructions"] = 0
        elif fn and re.search(r"\bHG?MMA\b", line):
            report[fn]["tensor_core_instructions"] += 1
    for fn in sorted(report):
        log(f"{fn}: {report[fn]}")
        if report[fn].get("tensor_core_instructions") == 0:
            raise AssertionError(f"{fn} has no tensor-core instruction")
    return report


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
    flags = MAIN_FLAGS + ["--comm_round", str(rounds),
                          "--frequency_of_the_test", "4"]
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


def _flash_work(b, s, h, d, causal, elem_bytes=4):
    """(FLOP, bytes) of each flash kernel on these inputs: FLOP of the
    [S,S]xD products over the (query, key) pairs the causal mask leaves
    visible (all S*S without it), bytes of each input read once and each
    output written once."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tensor = b * s * h * d * elem_bytes
    rows = b * h * s * 4  # one f32 per row: lse, delta
    return {"fwd": (2 * 2 * d * pairs, 4 * tensor + rows),
            "dkdv": (4 * 2 * d * pairs, 6 * tensor + 2 * rows),
            "dq": (3 * 2 * d * pairs, 5 * tensor + 2 * rows)}


def _bounds(flops, nbytes):
    """The least time at each rate: f32 on CUDA cores, f32-accurate 3xTF32
    and one-pass TF32 on the tensor cores. ``bound_ms`` is the 3xTF32 one,
    the fastest route to f32 accuracy on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_3x = 3 * flops / TF32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_3x),
            "bound_ms_f32": 1e3 * max(t_bytes, flops / F32_FLOP_PER_S),
            "bound_ms_3xtf32": 1e3 * max(t_bytes, t_3x),
            "bound_ms_tf32": 1e3 * max(t_bytes, flops / TF32_FLOP_PER_S),
            "bound_by": "bytes" if t_bytes >= t_3x else "operations"}


def phase_flash_vs_plain():
    import torch
    import torch.nn.functional as F
    from fedml_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def inputs(b, s, h, d, dtype=torch.float32, strided=False):
        if strided == "misaligned":  # one element into a buffer
            return [torch.randn(b * s * h * d + 1, generator=gen,
                                device=dev)[1:].view(b, s, h, d)
                    for _ in range(4)]
        if strided:  # q, k, v as views of one qkv projection
            qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=dev)
            q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, -1))
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                       for _ in range(3))
        do = torch.randn(b, s, h, d, generator=gen, device=dev)
        return [t.to(dtype) for t in (q, k, v, do)]

    def rel(got, want):
        err = (got.float() - want.float()).abs()
        return (float(err.max()),
                float((err / want.float().abs().clamp(min=1e-6)).max()))

    # path_shape is the path's own layout: q, k, v as views of one
    # [4, 2048, 768] qkv projection (row stride 3 * width)
    cases = [("path_shape", LM_SHAPE, True, torch.float32, True),
             ("not_causal", LM_SHAPE, False, torch.float32, False),
             ("s32_below_tile", (2, 32, 4, 64), True, torch.float32, False),
             ("d16_ragged_s48", (2, 48, 4, 16), True, torch.float32, False),
             ("d128", (2, 256, 4, 128), True, torch.float32, False),
             ("bf16", (2, 256, 4, 64), True, torch.bfloat16, False),
             ("contiguous", (2, 512, 4, 64), True, torch.float32, False),
             # the tensor-core backward's risky tilings
             ("d128_s2048", (2, 2048, 4, 128), True, torch.float32, False),
             ("ragged_s1000", (2, 1000, 4, 64), True, torch.float32, False),
             ("bf16_path_shape", LM_SHAPE, True, torch.bfloat16, True),
             ("scalar_copy_path", (2, 200, 4, 64), True, torch.float32,
              "misaligned")]
    # the largest errors of the f32 cases (the kernels' JSON entries) and
    # of the bf16 ones, which take their own tolerance
    checks = []
    max_abs = {dt: {"fwd": 0.0, "dkdv": 0.0, "dq": 0.0}
               for dt in (torch.float32, torch.bfloat16)}
    for name, shape, causal, dtype, strided in cases:
        q, k, v, do = inputs(*shape, dtype=dtype, strided=strided)
        if fa.takes_async_copies(q, k, v, do) != (strided != "misaligned"):
            raise AssertionError(f"{name}: expected the other copy path "
                                 f"of the kernels")
        out, lse = fa.flash_fwd(q, k, v, causal)
        want_out, want_lse = fa.fwd_reference(q, k, v, causal)
        delta = fa.attention_delta(want_out, do)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, want_lse, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, causal)
        want_dk, want_dv = fa.bwd_dkdv_reference(q, k, v, do, want_lse,
                                                 delta, causal)
        want_dq = fa.bwd_dq_reference(q, k, v, do, want_lse, delta, causal)
        torch.cuda.synchronize()
        tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
               else FLASH_TOL)
        errs = {}
        for what, kern, got, want in (
                ("out", "fwd", out, want_out), ("lse", "fwd", lse, want_lse),
                ("dk", "dkdv", dk, want_dk), ("dv", "dkdv", dv, want_dv),
                ("dq", "dq", dq, want_dq)):
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"{name} {what}: {got.dtype} "
                                     f"{tuple(got.shape)} vs {want.dtype} "
                                     f"{tuple(want.shape)}")
            if not torch.allclose(got.float(), want.float(), **tol):
                raise AssertionError(f"{name} {what}: kernel disagrees with "
                                     f"the plain version {rel(got, want)}")
            errs[what] = rel(got, want)
            max_abs[dtype][kern] = max(max_abs[dtype][kern], errs[what][0])
        checks.append({"case": name, "shape": list(shape), "causal": causal,
                       "dtype": str(dtype), "strided": strided,
                       "max_abs_rel_err": errs})
        log(f"flash kernels == plain at {name} {list(shape)} "
            f"{str(dtype)[6:]}{' causal' if causal else ''}: "
            + ", ".join(f"{w} {a:.2g}/{r:.2g}" for w, (a, r) in errs.items()))

    # timing at the path's shape and layout (q, k, v views of one qkv
    # projection): two input sets, kernels and plain versions captured in
    # CUDA graphs; SDPA on the same values laid out [B, H, S, D]
    # (contiguous): its forward, its backward alone (the forward run once
    # outside the timed window) and forward + backward
    b, s, h, d = LM_SHAPE
    sets = []
    for _ in range(2):
        q, k, v, do = inputs(b, s, h, d, strided=True)
        out, lse = fa.fwd_reference(q, k, v, True)
        sets.append((q, k, v, do, lse, fa.attention_delta(out, do)))
    fwd_args = [st[:3] + (True,) for st in sets]
    bwd_args = [st[:3] + (st[3], st[4], st[5], True) for st in sets]
    iters = 20
    t = {"fwd": (cuda_time_ms(fa.flash_fwd, fwd_args, iters),
                 cuda_time_ms(fa.fwd_reference, fwd_args, iters)),
         "dkdv": (cuda_time_ms(fa.flash_bwd_dkdv, bwd_args, iters),
                  cuda_time_ms(fa.bwd_dkdv_reference, bwd_args, iters)),
         "dq": (cuda_time_ms(fa.flash_bwd_dq, bwd_args, iters),
                cuda_time_ms(fa.bwd_dq_reference, bwd_args, iters))}
    q, k, v, do = (x.transpose(1, 2).contiguous() for x in sets[0][:4])
    sdpa_fwd = cuda_time_ms(
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
        [(q, k, v)], iters)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, grad_outputs=do)
    sdpa_both = cuda_time_eager_ms(sdpa_fwd_bwd, iters)
    o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = cuda_time_eager_ms(
        lambda: torch.autograd.grad(o, leaves, grad_outputs=do,
                                    retain_graph=True), iters)
    work = _flash_work(b, s, h, d, True)
    timing = {}
    for kern, (ms, plain_ms) in t.items():
        flops, nbytes = work[kern]
        timing[kern] = {"ms": ms, "plain_ms": plain_ms,
                        "library_ms": sdpa_fwd if kern == "fwd" else sdpa_bwd,
                        "library_fwd_bwd_ms": sdpa_both,
                        "flop": flops, "bytes": nbytes,
                        "tflops": flops / ms / 1e9,
                        **_bounds(flops, nbytes)}
        log(f"flash {kern} {list(LM_SHAPE)} f32 causal: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, SDPA {timing[kern]['library_ms']:.4f}"
            f" ms ({'fwd' if kern == 'fwd' else 'bwd alone'}), bound "
            f"{timing[kern]['bound_ms_f32']:.4f} ms f32 / "
            f"{timing[kern]['bound_ms_3xtf32']:.4f} ms 3xTF32 / "
            f"{timing[kern]['bound_ms_tf32']:.4f} ms TF32 "
            f"({flops / 1e9:.2f} GFLOP) -> {timing[kern]['tflops']:.1f} "
            f"TFLOP/s")
    log(f"flash forward {t['fwd'][0]:.4f} ms against SDPA's forward "
        f"{sdpa_fwd:.4f} ms ({t['fwd'][0] / sdpa_fwd:.3f}x)")
    pair = t["dkdv"][0] + t["dq"][0]
    log(f"flash backward pair (dK/dV + dQ) {pair:.4f} ms against SDPA's "
        f"backward alone {sdpa_bwd:.4f} ms ({pair / sdpa_bwd:.3f}x); SDPA "
        f"forward + backward {sdpa_both:.4f} ms")
    return {"checks": checks, "max_abs_err": max_abs[torch.float32],
            "max_abs_err_bf16": max_abs[torch.bfloat16], "timing": timing,
            "pair_ms": pair, "sdpa_bwd_ms": sdpa_bwd}


def _lm_launches(api, rounds, evals):
    """Launches of each flash kernel that the schedule implies: every real
    SGD step runs each kernel once per layer; every evaluation runs the
    forward once per layer per eval batch of the train and test unions."""
    from fedml_tpu_torch.core.sampling import sample_clients
    cfg = api.config
    bsz = cfg.train.batch_size
    depth = len(api.module.blocks)
    steps = sum(cfg.train.epochs
                * -(-api.dataset.train_data_local_num_dict[int(c)] // bsz)
                for r in range(rounds)
                for c in sample_clients(r, api.dataset.client_num,
                                        cfg.client_num_per_round))
    eval_batches = sum(-(-len(x) // 512) for x in (
        api.dataset.train_data_global[0], api.dataset.test_data_global[0]))
    fwd = depth * (steps + evals * eval_batches)
    return {"fwd": fwd, "dkdv": depth * steps, "dq": depth * steps,
            "steps": steps}


def phase_lm_path():
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.synthetic import make_token_federated
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.trainer.functional import TrainConfig

    t = time.perf_counter()
    ds = make_token_federated(client_num=8, vocab_size=1024, seq_len=2048,
                              sequences_per_client=8, seed=0)
    log(f"token federation built in {time.perf_counter() - t:.1f}s")
    rounds, per_round = 3, 4
    api = FedAvgAPI(ds, TransformerLM(**LM, attn_fn=fa.make_flash_attention(
        128, 128)), task="nwp", device="cuda", config=FedAvgConfig(
            comm_round=rounds, client_num_per_round=per_round,
            frequency_of_the_test=2,
            train=TrainConfig(epochs=1, batch_size=4, lr=LM_LR)))
    kernels = (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq,
               aggregate.weighted_mean_flat)
    for fn in kernels:
        fn.launches = 0
    t = time.perf_counter()
    api.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(zip(("fwd", "dkdv", "dq", "wmean"),
                        (fn.launches for fn in kernels)))

    want = _lm_launches(api, rounds, evals=2)
    for kern in ("fwd", "dkdv", "dq"):
        if launches[kern] != want[kern]:
            raise AssertionError(f"flash {kern} launched {launches[kern]} "
                                 f"times, the schedule implies {want[kern]}")
    if launches["wmean"] != rounds:
        raise AssertionError(f"aggregation kernel launched "
                             f"{launches['wmean']} times in {rounds} rounds")
    recs = api.history
    if [r["round"] for r in recs] != [0, 2]:
        raise AssertionError(f"eval rounds {[r['round'] for r in recs]}")
    for r in recs:
        for k in ("train_loss", "test_loss", "train_acc", "test_acc",
                  "train_loss_local"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"round {r['round']}: {k}={r[k]}")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"LM test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    name = torch.cuda.get_device_name(0)
    log(f"LM path: {rounds} rounds, {want['steps']} SGD steps, launches "
        f"{launches} (schedule {want}), test loss {recs[0]['test_loss']:.4f}"
        f" -> {recs[-1]['test_loss']:.4f} (wall {wall:.1f}s with 2 evals)")

    # one full evaluation batch (512 rows, make_eval's batch) at S = 2048:
    # the train union tiled to 512 sequences; its peak device memory
    x = torch.from_numpy(ds.train_data_global[0]).to("cuda").repeat(8, 1)
    y = torch.from_numpy(ds.train_data_global[1]).to("cuda").repeat(8, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    stats = api._eval_fn(api.variables, x, y, torch.ones(len(x),
                                                         device="cuda"))
    torch.cuda.synchronize()
    eval512 = {"rows": len(x), "s": time.perf_counter() - t,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "peak_above_inputs_gib":
                   (torch.cuda.max_memory_allocated() - base) / 2**30}
    if not math.isfinite(float(stats["loss_sum"])):
        raise AssertionError("eval batch of 512: loss not finite")
    log(f"eval batch [{len(x)}, {x.shape[1]}]: {eval512['s']:.2f}s, peak "
        f"{eval512['peak_gib']:.2f} GiB allocated "
        f"({eval512['peak_above_inputs_gib']:.2f} GiB above what was live)")
    del x, y, stats

    # rounds/s and training tokens/s on the same API, further rounds
    timed = 3
    api.run_round(rounds)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in range(rounds + 1, rounds + 1 + timed):
        api.run_round(r)
    torch.cuda.synchronize()
    rps = timed / (time.perf_counter() - t)
    seq_len = ds.train_data_global[0].shape[1]
    tokens_per_round = sum(
        ds.train_data_local_num_dict[int(c)] * seq_len
        for r in range(rounds + 1, rounds + 1 + timed)
        for c in sample_clients(r, ds.client_num, per_round)) / timed
    log(f"LM rounds: {rps:.3f} rounds/s, {rps * tokens_per_round:.0f} "
        f"training tokens/s on {name} (4 clients x 8 sequences x 2048)")

    # the centralized train step at the bench's shape: [4, 2048] tokens,
    # mean next-token CE, SGD lr 1e-3; the kernels, then SDPA as attn_fn
    tokens = torch.from_numpy(ds.train_data_global[0][:4]).to("cuda")

    def sdpa_attn(q, k, v, causal=True):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal).transpose(1, 2)

    step_tps = {}
    for label, attn in (("flash_kernels", fa.make_flash_attention(128, 128)),
                        ("sdpa", sdpa_attn)):
        model = TransformerLM(**LM, attn_fn=attn).to("cuda")
        params = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}

        def step(params):
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            logits = functional_call(model, leaves, (tokens,))
            loss = F.cross_entropy(logits[:, :-1].reshape(-1, LM["vocab_size"]),
                                   tokens[:, 1:].reshape(-1).long())
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                return {k: v.detach() - 1e-3 * g
                        for (k, v), g in zip(leaves.items(), grads)}
        for _ in range(2):
            params = step(params)
        torch.cuda.synchronize()
        n = 10
        t = time.perf_counter()
        for _ in range(n):
            params = step(params)
        torch.cuda.synchronize()
        step_tps[label] = n * tokens.numel() / (time.perf_counter() - t)
    log(f"centralized step [4, 2048]: {step_tps['flash_kernels']:.0f} "
        f"tokens/s with the kernels, {step_tps['sdpa']:.0f} with SDPA, on "
        f"{name}")
    return {"launches": launches, "schedule": want, "evals": recs,
            "wall_s": wall, "rounds_per_s": rps, "eval_512": eval512,
            "train_tokens_per_s": rps * tokens_per_round,
            "centralized_step_tokens_per_s": step_tps}


def phase_lm_card_vs_cpu():
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.data.synthetic import make_token_federated
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.trainer.functional import TrainConfig

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launched = fa.flash_bwd_dq.launches
    try:
        ds = make_token_federated(client_num=4, vocab_size=64, seq_len=128,
                                  sequences_per_client=8, seed=1)
        cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                           prefetch_depth=0,
                           train=TrainConfig(epochs=1, batch_size=4, lr=0.3,
                                             shuffle=False))
        apis = [FedAvgAPI(ds, TransformerLM(
                    vocab_size=64, width=64, depth=2, num_heads=2,
                    max_len=128, attn_fn=fa.make_flash_attention(128, 128)),
                    task="nwp", config=cfg, device=d)
                for d in ("cuda", "cpu")]
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
    if fa.flash_bwd_dq.launches == launched:
        raise AssertionError("the card's transformer round ran no kernel")
    if not diff <= 1e-4:
        raise AssertionError(f"transformer round card vs CPU: max abs diff "
                             f"{diff}")
    log(f"transformer round, card vs CPU: max abs param diff {diff:.3g} "
        "(atol 1e-4)")
    return {"max_abs_diff": diff}


def _same_bits(a, b) -> bool:
    """Equal bit for bit; for floats, NaN at the same places (the card's
    NaN and the CPU's may differ in payload) and equal bits elsewhere."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
    return bool(torch.equal(a, b))


def _max_abs(a, b) -> float:
    """Largest |a - b| where neither is NaN (0 for no such entry)."""
    import torch
    a, b = a.float(), b.float()
    keep = ~(torch.isnan(a) | torch.isnan(b))
    return float((a[keep] - b[keep]).abs().max()) if keep.any() else 0.0


def _quant_work(d):
    """Bytes each kernel must move for a ``d``-vector (each input read
    once, each output written once) and its f32 operations (about 10 a
    value to quantize: abs, max, divide, shift, convert, scale, floor,
    subtract, compare, add and the clip, and 2 more for the residual; one
    to dequantize, two with a minuend, the residual of top-k's error
    feedback)."""
    blocks = -(-d // 512)
    quant_bytes = 4 * d + 4 * d + d + 4 * blocks
    return {"quant": (10 * d, quant_bytes),
            "quant_res": (12 * d, quant_bytes + 4 * d),
            "dequant": (d, d + 4 * blocks + 4 * d),
            "dequant_sub": (2 * d, d + 4 * blocks + 4 * d + 4 * d)}


def _padded_int8(q, rows):
    """``q`` zero-padded to ``[rows, 512]``, the TPU wrapper's layout."""
    import torch
    qp = torch.zeros(rows * 512, dtype=torch.int8, device=q.device)
    qp[:q.numel()] = q
    return qp.view(rows, 512)


def _library_dequant(qp, scales):
    """One PyTorch call computing the dequantize on the padded layout: the
    int8 -> f32 cast is exact and the product rounds once, so its bits are
    the kernel's."""
    import torch
    return torch.mul(qp, scales[:, None])


def phase_quant_vs_plain():
    import torch
    from fedml_tpu_torch.ops import quantize as tq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    d_cnn = HEADLINE[1]

    def inputs(d, kind="normal", offset=0):
        x = torch.randn(d + offset, generator=gen, device=dev)[offset:]
        if kind == "wide":  # magnitudes spanning 1e-30..1e30
            x = x.sign() * 10.0 ** (torch.rand(d, generator=gen, device=dev)
                                    * 60 - 30)
        if d >= 1024:
            x[512:1024] = 0.0  # an all-zero block
        bits = tq.random_bits(d + offset, gen)[offset:]
        if kind == "top_bit":
            bits = bits | torch.tensor(-2**31, dtype=torch.int32, device=dev)
        if kind == "nan_inf":  # NaN in block 0, +-inf in blocks 2 and 3
            x[3], x[1100], x[1700] = math.nan, math.inf, -math.inf
        return x, bits

    cases = [("cnn_delta", d_cnn, "normal", 0),
             ("topk_survivors", SILO_K, "normal", 0),
             ("wide_range", d_cnn, "wide", 0),
             ("top_bit_set", 70_000, "top_bit", 0),
             ("nan_inf", 2570, "nan_inf", 0),
             ("scalar_path", d_cnn, "normal", 1),
             ("scalar_path_k", SILO_K, "normal", 1)]
    cases += [(f"d{d}", d, "normal", 0) for d in (1, 511, 512, 513, 2570)]
    checks, max_abs = [], {"quant": 0.0, "dequant": 0.0}
    for name, d, kind, offset in cases:
        x, bits = inputs(d, kind, offset)
        q, s = tq.quantize_int8(x, bits)
        # the fused error-feedback residual, from the quantize kernel
        fq, fs, fres = tq.quantize_int8(x, bits, residual=True)
        want_q, want_s = tq.quantize_int8_reference(x, bits)
        q_in = torch.empty(d + offset, dtype=torch.int8, device=dev)[offset:]
        q_in.copy_(want_q)
        out = tq.dequantize_int8(q_in, want_s, d)
        want_out = tq.dequantize_int8_reference(want_q, want_s)
        # the error-feedback residual of the kept values: x - q * scale
        res = tq.dequantize_int8(q_in, want_s, d, subtract_from=x)
        want_res = tq.dequantize_int8_reference(want_q, want_s, x)
        lib_out = _library_dequant(_padded_int8(want_q, tq.num_blocks(d)),
                                   want_s).view(-1)[:d]
        vec = tq.takes_vec_paths(x, bits, q_in, out)
        vec_res = tq.takes_vec_paths(x, bits, q_in, res, x)[1]
        vec_fused = tq.takes_vec_paths(x, bits, fq, out, residual=fres)[0]
        torch.cuda.synchronize()
        ok = {"q": _same_bits(q, want_q), "scales": _same_bits(s, want_s),
              "out": _same_bits(out, want_out),
              "residual": _same_bits(res, want_res),
              "fused_q": _same_bits(fq, want_q),
              "fused_scales": _same_bits(fs, want_s),
              "fused_residual": _same_bits(fres, want_res),
              "library_out": _same_bits(lib_out, want_out)}
        if not all(ok.values()):
            raise AssertionError(f"{name} D={d}: kernel differs from the "
                                 f"plain version in {ok}")
        if (vec != (offset == 0, offset == 0) or vec_res != (offset == 0)
                or vec_fused != (offset == 0)):
            raise AssertionError(f"{name}: vector paths {vec} {vec_res} "
                                 f"{vec_fused}")
        if kind == "nan_inf" and not (
                torch.isnan(s[0]) and torch.isinf(s[2:4]).all()
                and (q[:512] == 0).all() and torch.isnan(out[:512]).all()
                and torch.isnan(out[1024:2048]).all()
                and torch.isnan(fres[:512]).all()
                and torch.isnan(fres[1024:2048]).all()):
            raise AssertionError("a NaN or inf block did not dequantize "
                                 "to NaN")
        max_abs["quant"] = max(max_abs["quant"], _max_abs(q, want_q),
                               _max_abs(fq, want_q))
        max_abs["dequant"] = max(max_abs["dequant"], _max_abs(out, want_out),
                                 _max_abs(res, want_res),
                                 _max_abs(fres, want_res))
        checks.append({"case": name, "d": d,
                       "vec": list(vec) + [vec_res, vec_fused],
                       "bit_exact": True})
        log(f"quantize (and its fused residual), dequantize == plain, bit "
            f"for bit, at {name} D={d}{' (scalar paths)' if offset else ''}")

    # timing at the path's two shapes: 6 input sets at D (65 MB of x and
    # bits, beyond the 50 MB L2; the dequantize's 6 x 1.2 MB of int8 stay
    # in it), 20 at k; kernels and plain versions in CUDA graphs. Beside
    # them the floor of one graph node (an empty kernel), PyTorch's
    # int8 -> f32 copy (the dequantize's bytes through an elementwise
    # pass) and the dequantize's library call (torch.mul on the padded
    # [rows, 512] layout)
    lib = tq._kernel()
    iters = 200
    floor_ms = cuda_time_ms(lambda: lib.fedml_empty_kernel(
        torch.cuda.current_stream().cuda_stream), [()], iters)
    log(f"empty kernel (the floor of one graph node): {floor_ms:.5f} ms")
    timing = {"floor_ms": floor_ms}
    for label, d, sets in (("cnn_delta", d_cnn, 6),
                           ("topk_survivors", SILO_K, 20)):
        qargs = [inputs(d) for _ in range(sets)]
        dargs = [tq.quantize_int8_reference(x, b) + (d,) for x, b in qargs]
        sargs = [a + (x,) for a, (x, _) in zip(dargs, qargs)]
        rows = tq.num_blocks(d)
        padded = [(_padded_int8(q, rows), s) for q, s, _ in dargs]
        copies = [(q, torch.empty(d, device=dev)) for q, _, _ in dargs]

        def plain_fused(x, b):
            q, s = tq.quantize_int8_reference(x, b)
            return q, s, tq.dequantize_int8_reference(q, s, x)
        t = {"quant": (cuda_time_ms(tq.quantize_int8, qargs, iters),
                       cuda_time_ms(tq.quantize_int8_reference, qargs,
                                    iters)),
             "quant_res": (cuda_time_ms(
                 lambda x, b: tq.quantize_int8(x, b, residual=True), qargs,
                 iters), cuda_time_ms(plain_fused, qargs, iters)),
             "dequant": (cuda_time_ms(tq.dequantize_int8, dargs, iters),
                         cuda_time_ms(lambda q, s, d:
                                      tq.dequantize_int8_reference(q, s),
                                      dargs, iters)),
             "dequant_sub": (cuda_time_ms(tq.dequantize_int8, sargs, iters),
                             cuda_time_ms(lambda q, s, d, x:
                                          tq.dequantize_int8_reference(
                                              q, s, x), sargs, iters))}
        library_ms = cuda_time_ms(_library_dequant, padded, iters)
        copy_ms = cuda_time_ms(lambda q, o: o.copy_(q), copies, iters)
        work = _quant_work(d)
        timing[label] = {"library_ms": library_ms, "copy_ms": copy_ms}
        log(f"D={d}: torch.mul on [{rows}, 512] (the dequantize's library "
            f"call) {library_ms:.5f} ms, int8 -> f32 copy_ {copy_ms:.5f} ms")
        for kern, (ms, plain_ms) in t.items():
            ops, nbytes = work[kern]
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = ops / F32_FLOP_PER_S
            timing[label][kern] = {
                "d": d, "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "gb_per_s": nbytes / ms / 1e6}
            log(f"{kern} D={d}: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
                f"ms, bound {1e3 * max(t_bytes, t_ops):.5f} ms "
                f"({nbytes / 1e6:.2f} MB) -> {nbytes / ms / 1e6:.0f} GB/s")
    return {"checks": checks, "max_abs_err": max_abs, "timing": timing}


def _silo_launches(rounds, silos, policy):
    """Launches the schedule implies: one quantize per reply and per
    compressed broadcast (rounds 1..R-1); one dequantize for the server's
    decode of each reply, and per compressed broadcast one for the
    server's mirror and one for each silo's apply. Under top-k + int8 the
    quantize launch also writes the error-feedback residual of the kept
    values (ops/sparsify.py), so an encode launches no dequantize. At 5
    rounds and 10 silos: 54 / 94 under both compressed policies."""
    if policy == "none":
        return {"quant": 0, "dequant": 0}
    encodes = rounds * silos + rounds - 1
    dequant = rounds * silos + (rounds - 1) * (silos + 1)
    return {"quant": encodes, "dequant": dequant}


def phase_cross_silo_path():
    import torch
    from fedml_tpu_torch.comm.compression import compress_for_policy
    from fedml_tpu_torch.comm.policy import parse_policy
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import quantize as tq
    from fedml_tpu_torch.utils.metrics import read_metrics

    silos = HEADLINE[0]
    flags = ["--backend", "inproc", "--dataset", "femnist_gen",
             "--client_num_in_total", "200", "--client_num_per_round",
             str(silos), "--batch_size", "20", "--epochs", "1", "--lr",
             "0.1", "--device", "cuda"]
    runs, launches = {}, {"quant": 0, "dequant": 0}
    tq.quantize_int8.launches = 0
    tq.dequantize_int8.launches = 0
    for policy, rounds in (("none", 2), ("delta_int8", 5),
                           ("topk_ef_int8:0.05", 5)):
        run_dir = os.path.join(ROOT, "runs", "chip_smoke",
                               "silo_" + policy.replace(":", "_"))
        shutil.rmtree(run_dir, ignore_errors=True)
        before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
        t = time.perf_counter()
        main_fedavg.main(flags + ["--comm_round", str(rounds),
                                  "--compression", policy,
                                  "--run_dir", run_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {"quant": tq.quantize_int8.launches - before[0],
               "dequant": tq.dequantize_int8.launches - before[1]}
        want = _silo_launches(rounds, silos, policy)
        if got != want:
            raise AssertionError(f"{policy}: launches {got}, the schedule "
                                 f"implies {want}")
        recs = read_metrics(run_dir)
        hist = [r for r in recs if "round" in r]
        summary = recs[-1]
        if [r["round"] for r in hist] != list(range(rounds)):
            raise AssertionError(f"{policy}: rounds {hist}")
        for r in hist:
            if not math.isfinite(r["test_loss"]):
                raise AssertionError(f"{policy}: {r}")
        if rounds == 5 and not hist[4]["test_loss"] < hist[0]["test_loss"]:
            raise AssertionError(f"{policy}: test loss did not fall "
                                 f"{hist[0]['test_loss']} -> "
                                 f"{hist[4]['test_loss']}")
        steady = summary["round_duration_s"][1:]
        runs[policy] = {
            "launches": got, "wall_s": wall, "history": hist,
            "rounds_per_s": len(steady) / sum(steady),
            "round_duration_s": summary["round_duration_s"],
            "bytes_up_per_round": summary["comm_bytes_up_per_round"],
            "bytes_down_per_round": summary["comm_bytes_down_per_round"],
            "codec_encode_ms": summary.get("gauge_codec_encode_ms"),
            "agg_fold_ms": summary["gauge_agg_fold_ms"],
            "phase_ms_per_round": {
                k[len("phase_"):-len("_ms_per_round")]: v
                for k, v in summary.items()
                if k.startswith("phase_") and k.endswith("_per_round")}}
        launches = {k: launches[k] + got[k] for k in launches}
    base = runs["none"]
    for policy, r in runs.items():
        r["up_ratio_to_none"] = base["bytes_up_per_round"] / \
            r["bytes_up_per_round"]
        r["down_ratio_to_none"] = base["bytes_down_per_round"] / \
            r["bytes_down_per_round"]
        log(f"cross-silo {policy}: launches {r['launches']}, test loss "
            f"{r['history'][0]['test_loss']:.4f} -> "
            f"{r['history'][-1]['test_loss']:.4f}, "
            f"{r['rounds_per_s']:.3f} rounds/s after round 0, wire a round "
            f"up {r['bytes_up_per_round']:.0f} B "
            f"({r['up_ratio_to_none']:.2f}x less than none), down "
            f"{r['bytes_down_per_round']:.0f} B "
            f"({r['down_ratio_to_none']:.2f}x), codec_encode_ms "
            f"{r['codec_encode_ms']}, agg_fold_ms {r['agg_fold_ms']:.3f}, "
            f"phase ms a round {r['phase_ms_per_round']}")

    # one reply's frame arrays at full width: the CNN's state dict and a
    # perturbed copy, encoded as a silo encodes them
    from fedml_tpu_torch.models import CNN_DropOut
    model = CNN_DropOut(only_digits=False).to("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    base_sd = {k: v.detach() for k, v in model.state_dict().items()}
    new_sd = {k: v + 1e-3 * torch.randn(v.shape, generator=gen,
                                        device="cuda")
              for k, v in base_sd.items()}
    frames = {}
    for policy, want in (("delta_int8", 1_216_018),
                         ("topk_ef_int8:0.05", 302_122)):
        payload, _ = compress_for_policy(new_sd, base_sd, None, gen,
                                         parse_policy(policy))
        nbytes = sum(payload[k].nbytes for k in ("i", "q", "s")
                     if k in payload)
        if nbytes != want:
            raise AssertionError(f"{policy}: reply arrays {nbytes} B, "
                                 f"expected {want}")
        frames[policy] = nbytes
        log(f"{policy}: one reply's arrays {nbytes} B "
            f"({4 * HEADLINE[1] / nbytes:.2f}x less than f32)")
    return {"runs": runs, "launches": launches, "reply_array_bytes": frames}


def phase_cross_silo_card_vs_cpu():
    import torch
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        run_fedavg_cross_silo)
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    diffs = {}
    try:
        ds = make_blob_federated(client_num=8, dim=256, class_num=10, seed=2)
        for policy in ("none", "topk_ef"):
            finals = [run_fedavg_cross_silo(
                ds, create_model("lr", ds.class_num, input_shape=(256,)),
                worker_num=4, comm_round=1, compression=policy,
                train_cfg=TrainConfig(epochs=1, batch_size=16, lr=0.1,
                                      shuffle=False), device=d)[0]
                for d in ("cuda", "cpu")]
            diffs[policy] = max(float((finals[0][k].cpu()
                                       - finals[1][k]).abs().max())
                                for k in finals[1])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for policy, diff in diffs.items():
        if not diff <= 1e-5:
            raise AssertionError(f"cross-silo LR round card vs CPU under "
                                 f"{policy}: max abs diff {diff}")
        log(f"cross-silo LR round, card vs CPU, {policy}: max abs param "
            f"diff {diff:.3g} (atol 1e-5)")
    return {"max_abs_diff": diffs}


def _main_api_parts():
    """The main path's dataset, model, task and TrainConfig, from its
    flags, built once for the phases that drive it through FedAvgAPI."""
    from fedml_tpu_torch.experiments import main_fedavg
    args = main_fedavg.add_federated_args(
        argparse.ArgumentParser()).parse_args(MAIN_FLAGS)
    ds, model, task = main_fedavg.build_dataset_and_model(args)
    return ds, model, task, main_fedavg.make_train_config(args)


def _main_api(parts, comm_round, freq=10**9, **train):
    """A FedAvgAPI on the main path's configuration (``train`` overrides
    fields of its TrainConfig)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    return _algo_api(FedAvgAPI, FedAvgConfig, parts, comm_round, freq,
                     **train)


def _algo_api(api_cls, config_cls, parts, comm_round, freq=10**9,
              config=None, **train):
    """An API of the FedAvg family on the main path's configuration
    (``config`` adds fields of its config, ``train`` overrides fields of its
    TrainConfig)."""
    ds, model, task, tc = parts
    return api_cls(ds, model, task=task, device="cuda", config=config_cls(
        comm_round=comm_round, client_num_per_round=HEADLINE[0],
        frequency_of_the_test=freq, train=dataclasses.replace(tc, **train),
        **(config or {})))


def _spread(xs):
    """Median, min and max of repeated measurements."""
    s = sorted(xs)
    return {"median": s[len(s) // 2], "min": s[0], "max": s[-1], "runs": xs}


def _rounds_per_s(run, rounds, reps=3):
    """``run()`` (``rounds`` rounds) timed ``reps`` times, synchronized."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(rounds / (time.perf_counter() - t))
    return _spread(out)


def _profile(run, rounds):
    """``run()`` under torch.profiler: device ms a round (the device's own
    events), launch calls a round, and the aggregation kernel's launches by
    name in the device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    device = [e for e in evs if e.device_type == DeviceType.CUDA
              and dev_us(e) > 0]
    return {
        "device_ms_per_round": sum(dev_us(e) for e in device) / 1e3 / rounds,
        "wmean_kernels": sum(e.count for e in device if "wmean_" in e.key),
        # device kernels whose names say they compute in bf16 (cuDNN's and
        # cuBLAS's bf16 convolutions and GEMMs, and the casts)
        "bf16_kernels": sorted({e.key[:120] for e in device if any(
            t in e.key.lower() for t in ("bf16", "bfloat16"))}),
        "launch_calls_per_round": {
            k: sum(e.count for e in evs if e.key == k) / rounds
            for k in ("cudaLaunchKernel", "cudaGraphLaunch")}}


def _padding_steps(fused, r0):
    """Device ms a round of a fused block as it runs, and of the same block
    with every step made padding-only: a gated step runs the same kernels
    whether its batch is real or not, so the second, over its steps, is
    one step's cost, and that times the block's padding-only steps is
    what they cost a round. Each timed by CUDA events, median of 3."""
    import torch
    block = fused._block_inputs(r0, FUSED_R)
    plan = block["plan"]
    steps, real = plan.has_real.numel(), int(plan.has_real.sum())
    padded = dict(block, plan=plan._replace(
        has_real=torch.zeros_like(plan.has_real),
        emit=torch.zeros_like(plan.emit)))

    def ms(b):
        out = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fused._run_graph(b, FUSED_R)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / FUSED_R)
        return sorted(out)[1]
    block_ms, all_pad_ms = ms(block), ms(padded)
    pad_ms = all_pad_ms / steps * (steps - real)
    return {"steps_per_round": steps / FUSED_R,
            "real_steps_per_round": real / FUSED_R,
            "block_ms_per_round": block_ms,
            "all_padding_ms_per_round": all_pad_ms,
            "padding_ms_per_round": pad_ms,
            "padding_share": pad_ms / block_ms}


def phase_fused_path():
    """The main path through ``--fused_rounds``, its trajectory against the
    host loop's, its launches and rounds/s beside the host loop's."""
    import torch
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.parallel.graphs import CapturedRound
    from fedml_tpu_torch.utils.metrics import read_metrics

    rounds = 2 * FUSED_R
    run_dir = os.path.join(ROOT, "runs", "chip_smoke_fused")
    shutil.rmtree(run_dir, ignore_errors=True)
    captures = CapturedRound.captures
    aggregate.weighted_mean_flat.launches = 0
    t = time.perf_counter()
    main_fedavg.main(MAIN_FLAGS + [
        "--comm_round", str(rounds), "--frequency_of_the_test", str(FUSED_R),
        "--fused_rounds", str(FUSED_R), "--run_dir", run_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = aggregate.weighted_mean_flat.launches
    captures = CapturedRound.captures - captures
    # each capture ran one eager warm-up round (one launch) and recorded
    # one launch that runs at each replay; every fused round is one replay
    if not captures or launches != rounds + captures:
        raise AssertionError(f"fused main path: {launches} aggregation "
                             f"launches in {rounds} rounds and {captures} "
                             "captures")
    recs = read_metrics(run_dir)
    if [r["round"] for r in recs] != [0, FUSED_R, rounds - 1]:
        raise AssertionError(f"fused eval rounds {[r['round'] for r in recs]}")
    for r in recs:
        for k in ("train_loss", "test_loss", "train_loss_local"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"fused round {r['round']}: {k}={r[k]}")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"fused test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    log(f"fused main path: {rounds} rounds in dispatches of {FUSED_R}, "
        f"{captures} captures, {launches} aggregation launches, test loss "
        f"{recs[0]['test_loss']:.4f} -> {recs[-1]['test_loss']:.4f} (wall "
        f"{wall:.1f}s with data build, capture and eval)")

    # the same cohorts through the host loop and a fused block, shuffle
    # and dropout on; cuDNN's deterministic algorithms, so that the two
    # runs of the same convolutions give the same bits
    parts = _main_api_parts()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        host, fused_api = (_main_api(parts, FUSED_R) for _ in range(2))
        for r in range(FUSED_R):
            host.run_round(r)
        fused_api.fused_rounds().run_rounds(0, FUSED_R)
        diff = max(float((host.variables[k] - fused_api.variables[k])
                         .abs().max()) for k in host.variables)
    finally:
        torch.backends.cudnn.deterministic = saved
    if not diff <= 1e-6:
        raise AssertionError(f"fused block vs host loop: max abs diff {diff}")
    log(f"fused block == host loop over {FUSED_R} rounds (shuffle, dropout "
        f"on): max abs param diff {diff:.3g} (bound 1e-6)")

    return {"launches": launches, "captures": captures, "evals": recs,
            "wall_s": wall, "fused_vs_host_max_abs_diff": diff,
            "timing": _host_vs_fused_timing(parts)}


def _host_vs_fused_timing(parts, compute_dtype=None, reps=3,
                          make_api=None, label=None):
    """rounds/s of the host loop and of fused blocks (median and spread of
    ``reps`` runs over the same rounds), each round's launches and device
    time under the profiler, the graphs' capture time and pool bytes.
    ``make_api(parts, comm_round, **train)`` builds the API (FedAvg's by
    default)."""
    import torch
    from fedml_tpu_torch.ops import aggregate

    make_api = make_api or _main_api
    first, timed = 2, 2 * FUSED_R
    span = range(first, first + timed)
    host = make_api(parts, first + timed, compute_dtype=compute_dtype)
    for r in range(first):
        host.run_round(r)
    host_rps = _rounds_per_s(lambda: [host.run_round(r) for r in span],
                             timed, reps)
    # the first two timed rounds under the profiler (two cohorts; their
    # ~8,000 launches a round make the trace's processing the slowest part
    # of this phase): the busy share takes their mean device time against
    # the rate over all the timed rounds
    host_prof = _profile(lambda: [host.run_round(r) for r in span[:2]], 2)

    api = make_api(parts, first + timed, compute_dtype=compute_dtype)
    fused = api.fused_rounds()

    def blocks():
        for r in range(first, first + timed, FUSED_R):
            fused.run_rounds(r, FUSED_R)
    blocks()  # captures the graph of every pad bucket the rounds use
    fused_rps = _rounds_per_s(blocks, timed, reps)
    before = aggregate.weighted_mean_flat.launches
    fused_prof = _profile(lambda: fused.run_rounds(first, FUSED_R), FUSED_R)
    driver = aggregate.weighted_mean_flat.launches - before
    if not fused_prof["wmean_kernels"] == driver == FUSED_R:
        raise AssertionError(
            f"a profiled fused block of {FUSED_R} rounds: the profiler saw "
            f"{fused_prof['wmean_kernels']} aggregation kernels, the driver "
            f"counted {driver}")
    # a new driver's first block, under the profiler: its capture records
    # the kernel without running it, its warm-up round runs it once
    fresh = api.fused_rounds()
    before = aggregate.weighted_mean_flat.launches
    capture_prof = _profile(lambda: fresh.run_rounds(first, FUSED_R),
                            FUSED_R)
    counted = aggregate.weighted_mean_flat.launches - before
    if not (capture_prof["wmean_kernels"] == counted
            == FUSED_R + len(fresh.graphs)):
        raise AssertionError(
            f"a profiled fused block with {len(fresh.graphs)} captures: the "
            f"profiler saw {capture_prof['wmean_kernels']} aggregation "
            f"kernels, the driver counted {counted}, {FUSED_R} rounds")
    padding = _padding_steps(fused, first)
    bf16 = compute_dtype == "bfloat16"
    for name, prof in (("host loop", host_prof), ("fused", fused_prof)):
        if bool(prof["bf16_kernels"]) != bf16:
            raise AssertionError(
                f"{compute_dtype or 'f32'} {name}: bf16 kernels on the "
                f"device: {prof['bf16_kernels'][:8]}")
    graphs = [{"capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
               "wmean_launches_per_replay":
                   g.launches.get(aggregate.weighted_mean_flat, 0)}
              for g in fused.graphs.values()]
    out = {"rounds_per_s": host_rps, **host_prof,
           "busy_share": host_prof["device_ms_per_round"]
           * host_rps["median"] / 1e3,
           "fused": {"rounds_per_s": fused_rps, **fused_prof,
                     "busy_share": fused_prof["device_ms_per_round"]
                     * fused_rps["median"] / 1e3,
                     "driver_wmean_launches": driver, "graphs": graphs,
                     "padding_steps": padding,
                     "with_capture": {
                         "wmean_kernels": capture_prof["wmean_kernels"],
                         "driver_wmean_launches": counted,
                         "captures": len(fresh.graphs)}}}
    label = label or compute_dtype or "f32"
    for name, rec in (("host loop", out), ("fused", out["fused"])):
        rps = rec["rounds_per_s"]
        log(f"{label} {name}: {rps['median']:.3f} rounds/s (min "
            f"{rps['min']:.3f}, max {rps['max']:.3f}, {reps} runs of "
            f"{timed} rounds); device {rec['device_ms_per_round']:.2f} ms a "
            f"round, busy {100 * rec['busy_share']:.1f}%; launch calls a "
            f"round {rec['launch_calls_per_round']}")
    log(f"{label} fused: the profiler saw {fused_prof['wmean_kernels']} "
        f"aggregation kernels in {FUSED_R} rounds (the driver counted "
        f"{driver}); in a block with {len(fresh.graphs)} capture(s), "
        f"{capture_prof['wmean_kernels']} (the driver counted {counted}); "
        f"{len(fused_prof['bf16_kernels'])} bf16 kernel names; graphs "
        "(capture s, pool MiB): "
        + ", ".join(f"({g['capture_s']:.2f}, {g['pool_bytes'] / 2**20:.0f})"
                    for g in graphs))
    log(f"{label} fused: {padding['steps_per_round']:.0f} gated steps a "
        f"round, {padding['real_steps_per_round']:.0f} of them real; the "
        f"block {padding['block_ms_per_round']:.2f} ms a round, all steps "
        f"padding-only {padding['all_padding_ms_per_round']:.2f} ms: the "
        f"padding-only steps cost {padding['padding_ms_per_round']:.2f} ms "
        f"a round ({100 * padding['padding_share']:.0f}% of the block)")
    return out


def phase_fused_bf16():
    """The JAX headline's configuration: the fused main path in bf16 off
    f32 masters."""
    import torch
    from fedml_tpu_torch.experiments import main_fedavg
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.utils.metrics import read_metrics

    rounds = 2 * FUSED_R
    run_dir = os.path.join(ROOT, "runs", "chip_smoke_bf16")
    shutil.rmtree(run_dir, ignore_errors=True)
    aggregate.weighted_mean_flat.launches = 0
    main_fedavg.main(MAIN_FLAGS + [
        "--comm_round", str(rounds), "--frequency_of_the_test", str(FUSED_R),
        "--fused_rounds", str(FUSED_R), "--compute_dtype", "bfloat16",
        "--run_dir", run_dir])
    torch.cuda.synchronize()
    launches = aggregate.weighted_mean_flat.launches
    recs = read_metrics(run_dir)
    if launches < rounds:
        raise AssertionError(f"bf16 fused path: {launches} aggregation "
                             f"launches in {rounds} rounds")
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"bf16 test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    log(f"bf16 fused main path: {rounds} rounds, {launches} aggregation "
        f"launches, test loss {recs[0]['test_loss']:.4f} -> "
        f"{recs[-1]['test_loss']:.4f}")

    # one fused round in bf16 and in f32 from the same weights, beside an
    # f32 round from weights perturbed by 2**-9 relative noise (the rounding
    # of one bf16 cast): the round's own sensitivity to bf16-sized error
    parts = _main_api_parts()
    apis = [_main_api(parts, 1, compute_dtype=d) for d in ("bfloat16", None)]
    perturbed = _main_api(parts, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    perturbed.variables = {
        k: v * (1 + 2.0**-9 * torch.randn(v.shape, generator=gen,
                                           device="cuda"))
        for k, v in perturbed.variables.items()}
    for api in apis + [perturbed]:
        api.fused_rounds().run_rounds(0, 1)

    def rel_l2(a):
        num = sum(float(((a.variables[k] - v) ** 2).sum())
                  for k, v in apis[1].variables.items())
        den = sum(float((v ** 2).sum()) for v in apis[1].variables.values())
        return math.sqrt(num / den)
    diff = max(float((apis[0].variables[k] - v).abs().max())
               for k, v in apis[1].variables.items())
    bf16_l2, ref_l2 = rel_l2(apis[0]), rel_l2(perturbed)
    if not (BF16_VS_F32_MIN_FACTOR * ref_l2 <= bf16_l2
            <= BF16_VS_F32_FACTOR * ref_l2):
        raise AssertionError(
            f"bf16 vs f32 round: relative L2 distance {bf16_l2} outside "
            f"[{BF16_VS_F32_MIN_FACTOR}, {BF16_VS_F32_FACTOR}] x the "
            f"perturbed f32 round's {ref_l2}")
    log(f"one round bf16 vs f32: relative L2 distance {bf16_l2:.4f} (max "
        f"abs {diff:.3g}); an f32 round from 2**-9-perturbed weights "
        f"{ref_l2:.4f} (bounds {BF16_VS_F32_MIN_FACTOR}x and "
        f"{BF16_VS_F32_FACTOR}x)")
    timing = _host_vs_fused_timing(parts, "bfloat16")
    return {"launches": launches, "evals": recs,
            "bf16_vs_f32_max_abs_diff": diff, "bf16_vs_f32_rel_l2": bf16_l2,
            "perturbed_f32_rel_l2": ref_l2, "timing": timing}


def phase_fused_device_mode():
    """Device sampling: the cohorts and batch orders drawn on the card."""
    import torch
    from fedml_tpu_torch.core.sampling import (device_round_key,
                                               device_sample_clients)

    parts = _main_api_parts()
    n, k = parts[0].client_num, HEADLINE[0]
    rounds = 2 * FUSED_R
    api = _main_api(parts, rounds, freq=rounds - 1)
    fused = api.fused_rounds(device_sampling=True)
    cohorts = [device_sample_clients(device_round_key(
        api.config.seed, torch.tensor(r, device="cuda")), n, k).tolist()
        for r in range(rounds)]
    if any(len(set(c)) != k or not 0 <= min(c) <= max(c) < n
           for c in cohorts) or len({tuple(c) for c in cohorts}) < 2:
        raise AssertionError(f"device-sampled cohorts {cohorts}")
    t = time.perf_counter()
    fused.train(max_rounds_per_dispatch=FUSED_R)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    recs = api.history
    if not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"device mode: test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")
    log(f"device-sampled fused rounds: {rounds} rounds, distinct cohorts of "
        f"{k} without replacement, test loss {recs[0]['test_loss']:.4f} -> "
        f"{recs[-1]['test_loss']:.4f} (wall {wall:.1f}s with capture and "
        "eval)")
    return {"cohorts": cohorts, "evals": recs, "wall_s": wall}


def phase_lm_bf16():
    """An LM round in bf16: the three flash kernels on their bf16 path."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.data.synthetic import make_token_federated
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops import flash_attention as fa
    from fedml_tpu_torch.trainer.functional import TrainConfig

    ds = make_token_federated(client_num=8, vocab_size=1024, seq_len=2048,
                              sequences_per_client=8, seed=0)
    rounds, per_round, bsz = 2, 4, 4
    api = FedAvgAPI(ds, TransformerLM(**LM, attn_fn=fa.make_flash_attention(
        128, 128)), task="nwp", device="cuda", config=FedAvgConfig(
            comm_round=rounds + 3, client_num_per_round=per_round,
            frequency_of_the_test=10**9, train=TrainConfig(
                epochs=1, batch_size=bsz, lr=LM_LR,
                compute_dtype="bfloat16")))
    kernels = (fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    for r in range(rounds):
        _, stats = api.run_round(r)
    torch.cuda.synchronize()
    launches = dict(zip(("fwd", "dkdv", "dq"),
                        (fn.launches for fn in kernels)))
    steps = sum(-(-ds.train_data_local_num_dict[int(c)] // bsz)
                for r in range(rounds)
                for c in sample_clients(r, ds.client_num, per_round))
    depth = LM["depth"]
    if launches != {"fwd": depth * steps, "dkdv": depth * steps,
                    "dq": depth * steps}:
        raise AssertionError(f"bf16 LM: flash launches {launches}, the "
                             f"schedule implies {depth} each a step over "
                             f"{steps} steps")
    if not math.isfinite(float(stats["loss_sum"])):
        raise AssertionError("bf16 LM round: loss not finite")
    timed = 3
    rps = _rounds_per_s(lambda: [api.run_round(r) for r in
                                 range(rounds, rounds + timed)], timed, 1)
    tokens = sum(ds.train_data_local_num_dict[int(c)] * 2048
                 for r in range(rounds, rounds + timed)
                 for c in sample_clients(r, ds.client_num, per_round)) / timed
    log(f"bf16 LM: {rounds} rounds, {steps} steps, flash launches "
        f"{launches} ({3 * depth} a step); {rps['median']:.3f} rounds/s, "
        f"{rps['median'] * tokens:.0f} training tokens/s")

    # a small transformer round in bf16, card against CPU, same weights
    small = make_token_federated(client_num=4, vocab_size=64, seq_len=128,
                                 sequences_per_client=8, seed=1)
    cfg = FedAvgConfig(comm_round=1, client_num_per_round=4,
                       prefetch_depth=0, train=TrainConfig(
                           epochs=1, batch_size=4, lr=0.3, shuffle=False,
                           compute_dtype="bfloat16"))
    apis = [FedAvgAPI(small, TransformerLM(
                vocab_size=64, width=64, depth=2, num_heads=2, max_len=128,
                attn_fn=fa.make_flash_attention(128, 128)),
                task="nwp", config=cfg, device=d) for d in ("cuda", "cpu")]
    for a in apis:
        a.run_round(0)
    diff, worst = 0.0, 0.0
    for k, want in apis[1].variables.items():
        d = (apis[0].variables[k].cpu() - want).abs()
        diff = max(diff, float(d.max()))
        worst = max(worst, float((d - LM_BF16_TOL["atol"]
                                  - LM_BF16_TOL["rtol"] * want.abs()).max()))
    if worst > 0:
        raise AssertionError(f"bf16 transformer round card vs CPU: max abs "
                             f"diff {diff} outside {LM_BF16_TOL}")
    log(f"bf16 transformer round, card vs CPU: max abs param diff "
        f"{diff:.3g} (rtol {LM_BF16_TOL['rtol']}, atol "
        f"{LM_BF16_TOL['atol']})")
    return {"launches": launches, "steps": steps, "rounds_per_s": rps,
            "train_tokens_per_s": rps["median"] * tokens,
            "card_vs_cpu_max_abs_diff": diff}


def _fedopt_api(parts, comm_round, freq=10**9, server_optimizer="adam",
                server_lr=FEDOPT_LR, **train):
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, FedOptConfig
    return _algo_api(FedOptAPI, FedOptConfig, parts, comm_round, freq,
                     dict(server_optimizer=server_optimizer,
                          server_lr=server_lr), **train)


def _max_diff(a, b) -> float:
    """Largest absolute difference between two nests of tensors."""
    import torch.utils._pytree as pytree
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} leaves against {len(lb)}")
    return max(float((x.double().cpu() - y.double().cpu()).abs().max())
               for x, y in zip(la, lb))


def _launch_run(module, argv, name):
    """``module.main(argv)`` with the aggregation kernel's count set to 0
    just before and read just after; returns (final record, launches,
    captures, metrics records, wall s)."""
    import torch
    from fedml_tpu_torch.ops import aggregate
    from fedml_tpu_torch.parallel.graphs import CapturedRound
    from fedml_tpu_torch.utils.metrics import read_metrics

    run_dir = os.path.join(ROOT, "runs", name)
    shutil.rmtree(run_dir, ignore_errors=True)
    captures = CapturedRound.captures
    aggregate.weighted_mean_flat.launches = 0
    t = time.perf_counter()
    final = module.main(argv + ["--run_dir", run_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (final, aggregate.weighted_mean_flat.launches,
            CapturedRound.captures - captures, read_metrics(run_dir), wall)


def _check_evals(name, recs, rounds, falls=True):
    """Every eval record finite, at the expected rounds, and (``falls``)
    the test loss lower at the last than at the first."""
    if [r["round"] for r in recs] != rounds:
        raise AssertionError(f"{name}: eval rounds {[r['round'] for r in recs]}"
                             f", want {rounds}")
    for r in recs:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{name} round {r['round']}: {k}={v}")
    if falls and not recs[-1]["test_loss"] < recs[0]["test_loss"]:
        raise AssertionError(f"{name}: test loss did not fall: "
                             f"{recs[0]['test_loss']} -> "
                             f"{recs[-1]['test_loss']}")


def phase_fedopt_path():
    """FedOpt-adam on the CNN through ``fed_launch.main``, host loop and
    fused blocks: launches, the fused block against the host loop (params
    and server state), server SGD at lr 1 against FedAvg, and rounds/s."""
    import torch
    from fedml_tpu_torch.experiments import fed_launch

    rounds = 2 * FUSED_R
    flags = ["--algo", "fedopt", *MAIN_FLAGS, "--server_optimizer", "adam",
             "--server_lr", str(FEDOPT_LR), "--comm_round", str(rounds),
             "--frequency_of_the_test", str(FUSED_R)]
    out = {}
    for label, extra in (("host", []),
                         ("fused", ["--fused_rounds", str(FUSED_R)])):
        _, launches, captures, recs, wall = _launch_run(
            fed_launch, flags + extra, f"chip_smoke_fedopt_{label}")
        # one launch a round; a capture's warm-up round adds one, the
        # capture itself none
        if (label == "fused") != bool(captures) or \
                launches != rounds + captures:
            raise AssertionError(f"fedopt {label}: {launches} aggregation "
                                 f"launches in {rounds} rounds and "
                                 f"{captures} captures")
        _check_evals(f"fedopt {label}", recs, [0, FUSED_R, rounds - 1])
        out[label] = {"launches": launches, "captures": captures,
                      "evals": recs, "wall_s": wall}
        log(f"fedopt-adam {label} through fed_launch: {rounds} rounds, "
            f"{captures} captures, {launches} aggregation launches, test "
            f"loss {recs[0]['test_loss']:.4f} -> {recs[-1]['test_loss']:.4f}"
            f" (wall {wall:.1f}s with data build, capture and eval)")

    parts = _main_api_parts()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        host, fused_api = (_fedopt_api(parts, FUSED_R) for _ in range(2))
        for r in range(FUSED_R):
            host.run_round(r)
        fused_api.fused_rounds().run_rounds(0, FUSED_R)
        diff = _max_diff((host.variables, host.server_opt_state),
                         (fused_api.variables, fused_api.server_opt_state))
        if int(fused_api.server_opt_state["count"]) != FUSED_R:
            raise AssertionError("fused server adam count "
                                 f"{fused_api.server_opt_state['count']}")
        sgd = _fedopt_api(parts, 1, server_optimizer="sgd", server_lr=1.0)
        avg = _main_api(parts, 1)
        sgd.run_round(0)
        avg.run_round(0)
        sgd_diff = _max_diff(sgd.variables, avg.variables)
    finally:
        torch.backends.cudnn.deterministic = saved
    if not diff <= 1e-6:
        raise AssertionError(f"fedopt fused block vs host loop: {diff}")
    if not sgd_diff <= FEDOPT_SGD_TOL:
        raise AssertionError(f"fedopt sgd lr 1 vs fedavg: {sgd_diff}")
    log(f"fedopt fused block == host loop over {FUSED_R} rounds (params and "
        f"adam state): max abs diff {diff:.3g} (bound 1e-6); server sgd at "
        f"lr 1 vs fedavg after a round: {sgd_diff:.3g} (bound "
        f"{FEDOPT_SGD_TOL})")
    out.update(fused_vs_host_max_abs_diff=diff, sgd_vs_fedavg=sgd_diff,
               timing=_host_vs_fused_timing(parts, make_api=_fedopt_api,
                                            label="fedopt-adam f32"))
    return out


def _hierarchical_launches(seed, group_num, group_rounds, rounds):
    """The aggregation launches hierarchical FedAvg makes: a group round a
    launch for every group with sampled clients, and the global mean."""
    from fedml_tpu_torch.core.sampling import (locked_global_numpy_rng,
                                               sample_clients)
    n, k = MAIN_CLIENTS, HEADLINE[0]
    with locked_global_numpy_rng(seed) as rng:
        groups = rng.randint(0, group_num, n)
    return sum(len({int(groups[c]) for c in sample_clients(r, n, k)})
               * group_rounds + 1 for r in range(rounds))


def phase_slice_algorithms():
    """The rest of the slice through ``fed_launch.main`` on the card: the
    robust defenses, FedNova, hierarchical and secure aggregation on the
    CNN, centralized, decentralized and contribution on LR; launches,
    finite metrics and a falling loss where the JAX tests assert one."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.experiments import fed_launch
    from fedml_tpu_torch.ops import aggregate

    rounds = SLICE_ROUNDS
    cnn = MAIN_FLAGS + ["--comm_round", str(rounds),
                        "--frequency_of_the_test", str(rounds - 1)]
    evals = [0, rounds - 1]
    out = {}

    def run(name, algo, flags, launches, falls=True, eval_rounds=evals):
        final, got, _, recs, wall = _launch_run(
            fed_launch, ["--algo", algo, *flags], f"chip_smoke_{name}")
        if got != launches:
            raise AssertionError(f"{name}: {got} aggregation launches, "
                                 f"want {launches}")
        if eval_rounds is not None:
            _check_evals(name, recs, eval_rounds, falls)
        out[name] = {"launches": got, "final": final, "wall_s": wall}
        loss = (f"test loss {recs[0]['test_loss']:.4f} -> "
                f"{recs[-1]['test_loss']:.4f}, "
                if eval_rounds is not None else "")
        log(f"{name}: {loss}{got} aggregation launches (wall {wall:.1f}s)")
        return final

    for defense in ROBUST_DEFENSES:
        rule = defense in ("median", "trimmed_mean", "krum")
        # weak_dp adds noise to every client (the JAX test asserts only
        # that it does); Krum keeps one client's model
        run(f"robust_{defense}", "fedavg_robust",
            cnn + ["--defense_type", defense], 0 if rule else rounds,
            falls=defense not in ("weak_dp", "krum"))
    run("fednova", "fednova", cnn + ["--gmf", "0.5"], rounds)
    run("hierarchical", "hierarchical",
        cnn + ["--group_num", "2", "--group_comm_round", "2"],
        _hierarchical_launches(0, 2, 2, rounds))
    run("turboaggregate", "turboaggregate",
        MAIN_FLAGS + ["--comm_round", "2", "--frequency_of_the_test", "1"],
        0, eval_rounds=[0, 1])
    lr_flags = ["--dataset", "blob", "--client_num_in_total", "8",
                "--client_num_per_round", "4", "--batch_size", "16",
                "--lr", "0.1", "--device", "cuda"]
    cent = run("centralized", "centralized",
               lr_flags + ["--comm_round", str(rounds)], 0, eval_rounds=None)
    if not cent["test_acc"] > 0.8:
        raise AssertionError(f"centralized: {cent}")
    regrets = [run(f"decentralized_{t}", "decentralized",
                   lr_flags + ["--comm_round", str(t)], 0,
                   eval_rounds=None)["regret"] for t in (20, 200)]
    if not all(map(math.isfinite, regrets)) or not regrets[1] < regrets[0]:
        raise AssertionError(f"decentralized regret over 20 and 200 "
                             f"iterations: {regrets}")
    loo = run("contribution", "contribution",
              lr_flags + ["--client_num_in_total", "4", "--comm_round", "2"],
              5 * 2, eval_rounds=None)
    if not all(math.isfinite(v) and v >= 0 for v in loo["influence"]):
        raise AssertionError(f"contribution: {loo}")

    # weak DP's noise in a captured round: the host loop's bits
    parts = _main_api_parts()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        host, fused_api = (_algo_api(
            FedAvgRobustAPI, FedAvgRobustConfig, parts, FUSED_R,
            config=dict(defense_type="weak_dp")) for _ in range(2))
        for r in range(FUSED_R):
            host.run_round(r)
        aggregate.weighted_mean_flat.launches = 0
        fused = fused_api.fused_rounds()
        fused.run_rounds(0, FUSED_R)
        launches = aggregate.weighted_mean_flat.launches
        diff = _max_diff(host.variables, fused_api.variables)
    finally:
        torch.backends.cudnn.deterministic = saved
    if launches != FUSED_R + len(fused.graphs) or not diff <= 1e-6:
        raise AssertionError(f"weak_dp fused block: {launches} launches, "
                             f"max abs diff {diff} against the host loop")
    log(f"weak_dp fused block == host loop over {FUSED_R} rounds: max abs "
        f"diff {diff:.3g} (bound 1e-6), {launches} aggregation launches")
    out["weak_dp_fused"] = {"launches": launches, "max_abs_diff": diff}
    return out


def phase_slice_card_vs_cpu():
    """One LR round of FedOpt (adam), FedNova (momentum, the proximal term,
    server momentum) and robust median on the card and on the CPU from the
    same weights (TF32 off)."""
    import torch
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                          FedAvgRobustConfig)
    from fedml_tpu_torch.algorithms.fednova import FedNovaAPI, FedNovaConfig
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, FedOptConfig
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig

    ds = make_blob_federated(client_num=8, seed=0)
    tc = dict(epochs=2, batch_size=16, lr=0.1, shuffle=False)
    cases = {
        "fedopt": lambda d: FedOptAPI(
            ds, create_model("lr", ds.class_num, input_shape=(20,)),
            device=d, config=FedOptConfig(
                comm_round=1, client_num_per_round=4, prefetch_depth=0,
                server_optimizer="adam", server_lr=0.01,
                train=TrainConfig(**tc))),
        "fednova": lambda d: FedNovaAPI(
            ds, create_model("lr", ds.class_num, input_shape=(20,)),
            device=d, config=FedNovaConfig(
                comm_round=1, client_num_per_round=4, gmf=0.5, mu=0.01,
                train=TrainConfig(momentum=0.9, **tc))),
        "robust_median": lambda d: FedAvgRobustAPI(
            ds, create_model("lr", ds.class_num, input_shape=(20,)),
            device=d, config=FedAvgRobustConfig(
                comm_round=1, client_num_per_round=5, prefetch_depth=0,
                defense_type="median", train=TrainConfig(**tc)))}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, make in cases.items():
            apis = [make(d) for d in ("cuda", "cpu")]
            if _max_diff(apis[0].variables, apis[1].variables) != 0:
                raise AssertionError(f"{name}: initial weights differ")
            for api in apis:
                api.run_round(0)
            state = [(a.variables, getattr(a, "server_opt_state", {}),
                      getattr(a, "momentum_buf", {})) for a in apis]
            out[name] = _max_diff(*state)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    bad = {k: v for k, v in out.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"LR rounds card vs CPU: {bad}")
    log("LR rounds, card vs CPU (params and server state), max abs diff: "
        + ", ".join(f"{k} {v:.3g}" for k, v in out.items()) + " (atol 1e-5)")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    record = {"device": phase_device_and_build()}
    record["kernel"] = phase_kernel_vs_plain()
    record["main_path"] = phase_main_path()
    record["card_vs_cpu"] = phase_card_vs_cpu()
    record["fused_path"] = phase_fused_path()
    record["fused_bf16"] = phase_fused_bf16()
    record["fused_device_mode"] = phase_fused_device_mode()
    record["flash"] = phase_flash_vs_plain()
    record["lm_path"] = phase_lm_path()
    record["lm_card_vs_cpu"] = phase_lm_card_vs_cpu()
    record["lm_bf16"] = phase_lm_bf16()
    record["quant"] = phase_quant_vs_plain()
    record["silo_path"] = phase_cross_silo_path()
    record["silo_card_vs_cpu"] = phase_cross_silo_card_vs_cpu()
    record["fedopt_path"] = phase_fedopt_path()
    record["slice_algorithms"] = phase_slice_algorithms()
    record["slice_card_vs_cpu"] = phase_slice_card_vs_cpu()
    k = record["kernel"]
    kernels = [{
        "name": "wmean_f32", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/aggregate.cu",
        "replaces": "fedml_tpu/ops/aggregate.py:27",
        "launches": record["main_path"]["launches"],
        "launches_fused": record["fused_path"]["launches"],
        "launches_fused_bf16": record["fused_bf16"]["launches"],
        "launches_fedopt": record["fedopt_path"]["host"]["launches"],
        "launches_fedopt_fused": record["fedopt_path"]["fused"]["launches"],
        "launches_slice": {k: v["launches"] for k, v in
                           record["slice_algorithms"].items()},
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]
    for kern, name, line in (("fwd", "flash_fwd", 46),
                             ("dkdv", "flash_bwd_dkdv", 176),
                             ("dq", "flash_bwd_dq", 215)):
        t = record["flash"]["timing"][kern]
        kernels.append({
            "name": f"{name}_f32", "route": "cuda",
            "source": "fedml_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"fedml_tpu/ops/flash_attention.py:{line}",
            "launches": record["lm_path"]["launches"][kern],
            "launches_bf16": record["lm_bf16"]["launches"][kern],
            "max_abs_err": record["flash"]["max_abs_err"][kern],
            "max_abs_err_bf16": record["flash"]["max_abs_err_bf16"][kern],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_fwd_bwd_ms": t["library_fwd_bwd_ms"],
            "bound_ms_f32": t["bound_ms_f32"],
            "bound_ms_3xtf32": t["bound_ms_3xtf32"],
            "bound_ms_tf32": t["bound_ms_tf32"]})
    qt = record["quant"]["timing"]
    for kern, name, line in (("quant", "quantize_int8", 26),
                             ("dequant", "dequantize_int8", 40)):
        t, tk = qt["cnn_delta"][kern], qt["topk_survivors"][kern]
        sub = "quant_res" if kern == "quant" else "dequant_sub"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fedml_tpu_torch/csrc/quantize.cu",
            "replaces": f"fedml_tpu/ops/quantize.py:{line}",
            "launches": record["silo_path"]["launches"][kern],
            "max_abs_err": record["quant"]["max_abs_err"][kern],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": (qt["cnn_delta"]["library_ms"]
                           if kern == "dequant" else None),
            "ms_at_k": tk["ms"], "bound_ms_at_k": tk["bound_ms"],
            "ms_residual_at_k": qt["topk_survivors"][sub]["ms"],
            "bound_ms_residual_at_k": qt["topk_survivors"][sub]["bound_ms"],
            "floor_ms": qt["floor_ms"]})
    kernels[-1]["library_ms_at_k"] = qt["topk_survivors"]["library_ms"]
    kernels[-1]["copy_ms"] = qt["cnn_delta"]["copy_ms"]
    kernels[-1]["copy_ms_at_k"] = qt["topk_survivors"]["copy_ms"]
    kernels = {"kernels": kernels}
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
