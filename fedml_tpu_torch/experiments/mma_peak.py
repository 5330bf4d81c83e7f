"""The card's rate for ``mma.sync`` m16n8k8 TF32, the instruction that the
flash kernels run on (``csrc/mma_probe.cu``).

Launches the probe kernel (4 blocks of 8 warps an SM, 8 independent
accumulator chains a warp, register operands only), checks its sums, times
it between CUDA events and prints one JSON object: the card's name and
power limit, the TF32 rate of ``mma.sync`` in TFLOP/s, the f32-accurate
3xTF32 rate it allows (a third of it), and the card's published dense TF32
rate (which needs ``wgmma``) beside it.

    python -m fedml_tpu_torch.experiments.mma_peak [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

#: NVIDIA's data sheet, H100 SXM, dense TF32 tensor-core FLOP/s
PUBLISHED_TF32_FLOP_PER_S = 495e12
_CHAINS = 8  # kChains in csrc/mma_probe.cu
_MMA_FLOP = 2 * 16 * 8 * 8  # one m16n8k8 product


def main(argv=None):
    import torch
    from fedml_tpu_torch.ops.build import load_library
    from fedml_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=4096)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    lib = load_library("mma_probe").lib
    lib.fedml_mma_tf32_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.fedml_mma_tf32_probe.restype = ctypes.c_int
    lib.fedml_mma_probe_error_string.argtypes = [ctypes.c_int]
    lib.fedml_mma_probe_error_string.restype = ctypes.c_char_p

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads = 4 * sms, 256
    out = torch.empty(blocks * threads, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        rc = lib.fedml_mma_tf32_probe(out.data_ptr(), blocks, threads,
                                      args.iters, stream)
        if rc:
            raise RuntimeError("mma probe launch failed: "
                               + lib.fedml_mma_probe_error_string(rc).decode())

    run()
    torch.cuda.synchronize(dev)
    if not bool((out == 32 * _CHAINS * args.iters).all()):
        raise AssertionError("mma probe sums are wrong")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / reps
    flop = blocks * (threads // 32) * _CHAINS * args.iters * _MMA_FLOP
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    tflops = flop / ms / 1e9
    rec = {"card": smi.splitlines()[0], "ms": ms, "flop": flop,
           "mma_sync_tf32_tflops": tflops,
           "mma_sync_3xtf32_tflops": tflops / 3,
           "published_tf32_tflops": PUBLISHED_TF32_FLOP_PER_S / 1e12,
           "share_of_published": tflops * 1e12 / PUBLISHED_TF32_FLOP_PER_S}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
