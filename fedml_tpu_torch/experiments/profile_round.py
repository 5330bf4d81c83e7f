"""Where a FedAvg round's time goes on the card.

Runs one of the port's paths through ``FedAvgAPI`` on CUDA, warms up,
times a few rounds, then runs the same rounds again under
``torch.profiler`` and prints one JSON object: wall time per round, device
time per round summed over the device's own events, the device's busy
share (device time over the unprofiled wall time), the SGD steps the
rounds ran, the share of device time in each of the package's own CUDA
kernels, the kernels that took the most device time, and the host
operators that took the most CPU time of their own.

``--path cnn`` (default): femnist_gen, 200 clients, 10 a round, the
62-class CNN, batch 20, lr 0.1. ``--path lm``: the transformer LM's
federated next-token round, as chip_smoke.py drives it (token federation
of 8 clients x 8 sequences of 2048 tokens, vocab 1024; the full-width
TransformerLM with ``make_flash_attention(128, 128)``; 4 clients a round,
batch 4, lr 0.3).

    python -m fedml_tpu_torch.experiments.profile_round [--path lm] \
        [--rounds 3] [--out runs/profile_round.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


#: name fragments of the package's own CUDA kernels (csrc/)
OWN_KERNELS = ("wmean_", "flash_fwd_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_dq_kernel")


def _path(name):
    """``(dataset, model, task, batch, clients a round, lr)`` of a path."""
    if name == "cnn":
        from fedml_tpu_torch.data.registry import load_data
        from fedml_tpu_torch.models import create_model
        ds = load_data("femnist_gen", client_num_in_total=200)
        return ds, create_model("cnn", ds.class_num), "classification", 20, \
            10, 0.1
    from fedml_tpu_torch.data.synthetic import make_token_federated
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.ops.flash_attention import make_flash_attention
    ds = make_token_federated(client_num=8, vocab_size=1024, seq_len=2048,
                              sequences_per_client=8, seed=0)
    model = TransformerLM(vocab_size=1024, width=256, depth=4, num_heads=4,
                          max_len=2048,
                          attn_fn=make_flash_attention(128, 128))
    return ds, model, "nwp", 4, 4, 0.3


def main(argv=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
    from fedml_tpu_torch.core.sampling import sample_clients
    from fedml_tpu_torch.trainer.functional import TrainConfig

    parser = argparse.ArgumentParser("profile_round")
    parser.add_argument("--path", choices=["cnn", "lm"], default="cnn")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    ds, model, task, bsz, per_round, lr = _path(args.path)
    total = args.warmup + args.rounds
    api = FedAvgAPI(ds, model, task=task, device="cuda",
                    config=FedAvgConfig(comm_round=total,
                                        client_num_per_round=per_round,
                                        frequency_of_the_test=10**9,
                                        train=TrainConfig(batch_size=bsz,
                                                          lr=lr)))
    for r in range(args.warmup):
        api.run_round(r)
    torch.cuda.synchronize()
    steps = sum(-(-ds.train_data_local_num_dict[int(c)] // bsz)
                for r in range(args.warmup, total)
                for c in sample_clients(r, ds.client_num, per_round))
    def timed_rounds():
        t0 = time.perf_counter()
        for r in range(args.warmup, total):
            api.run_round(r)  # the same cohorts in both passes
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = timed_rounds()  # unprofiled: the busy share's denominator
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_profiled = timed_rounds()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the device's own events (kernels, copies, memsets); operator rows
    # repeat their kernels' time and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    device_total_us = sum(device_us(e) for e in events)
    top = sorted(events, key=device_us, reverse=True)[:12]
    # the host side: operators by their own CPU time (profiled run)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    own = {k: sum(device_us(e) for e in events if k in e.key)
           for k in OWN_KERNELS}
    rec = {
        "card": smi.splitlines()[0],
        "path": args.path,
        "rounds": args.rounds,
        "sgd_steps": steps,
        "wall_ms_per_round": 1e3 * wall / args.rounds,
        "wall_ms_per_round_profiled": 1e3 * wall_profiled / args.rounds,
        "device_ms_per_round": (device_total_us / 1e3 / args.rounds
                                if device_total_us else None),
        "device_busy_share": (device_total_us / 1e6 / wall
                              if device_total_us else None),
        "wall_us_per_step": 1e6 * wall / steps,
        # the package's own kernels: share of the device time, ms a round
        "own_kernel_device_share": ({k: v / device_total_us
                                     for k, v in own.items()}
                                    if device_total_us else None),
        "own_kernel_device_ms_per_round": {k: v / 1e3 / args.rounds
                                           for k, v in own.items()},
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms_per_round":
                             device_us(e) / 1e3 / args.rounds}
                        for e in top],
        "top_host_ops": [{"name": e.key[:90], "calls": e.count,
                          "self_cpu_ms_per_round":
                              e.self_cpu_time_total / 1e3 / args.rounds}
                         for e in host],
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
