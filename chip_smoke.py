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
   compares the parameters.

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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    record = {"device": phase_device_and_build()}
    record["kernel"] = phase_kernel_vs_plain()
    record["main_path"] = phase_main_path()
    record["card_vs_cpu"] = phase_card_vs_cpu()
    record["flash"] = phase_flash_vs_plain()
    record["lm_path"] = phase_lm_path()
    record["lm_card_vs_cpu"] = phase_lm_card_vs_cpu()
    record["quant"] = phase_quant_vs_plain()
    record["silo_path"] = phase_cross_silo_path()
    record["silo_card_vs_cpu"] = phase_cross_silo_card_vs_cpu()
    k = record["kernel"]
    kernels = [{
        "name": "wmean_f32", "route": "cuda",
        "source": "fedml_tpu_torch/csrc/aggregate.cu",
        "replaces": "fedml_tpu/ops/aggregate.py:27",
        "launches": record["main_path"]["launches"],
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
