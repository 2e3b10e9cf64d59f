"""Time K2 and K3 (the flash-attention backward kernels) on one GPU.

    python3 deeplearning_mpi_tpu_torch/cli/time_flash_bwd.py [--root DIR] [--out FILE]

At the training path's shape (bf16 B8 S2048 H12 D64 causal, BHSD) it builds
the backward kernels of the checkout at ``--root`` (default: the one holding
this file), holds dq/dk/dv to their plain version in relative L2, and times
K2, K3 and the backward of ``F.scaled_dot_product_attention`` with CUDA
events. ``--root`` lets one call time two checkouts in turns, each in its own
process (``parent, change, change, parent``). Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device ms per call by CUDA events, behind a sleep kernel that
    holds the card while the host enqueues (so host overhead is not timed)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    parser.add_argument("--out", default=None, help="also write the result JSON here")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash_bwd: CUDA is not available", file=sys.stderr)
        return 1
    from deeplearning_mpi_tpu_torch.ops.kernels import _build
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    logs = _build.build_all(["flash_attention_fwd", "flash_attention_bwd"], force=True)
    ptxas, keep = [], False  # the bf16 kernels' lines of the -Xptxas -v output
    for line in logs["flash_attention_bwd"].splitlines():
        if "Compiling entry function" in line:
            keep = "bf16path" in line
        if keep or ("bf16path" in line and "C75" in line):
            ptxas.append(line.strip())
    B, H, S, D = 8, 12, 2048, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    kw = dict(causal=True, window=None, shift=0, grad_dtype=None, layout="bhsd")
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, out_dtype=None, causal=True,
                                     window=None, shift=0, layout="bhsd")
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, do, lse, **kw)
    rel_l2 = {n: float((g.float() - w.float()).norm() / w.float().norm())
              for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    k2 = time_ms(torch, lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw))
    k3 = time_ms(torch, lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw))
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa = time_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True))
    result = {"root": root, "card": card, "shape": f"B{B} H{H} S{S} D{D} bf16 causal bhsd",
              "k2_ms": k2, "k3_ms": k3, "k2_k3_ms": k2 + k3, "sdpa_bwd_ms": sdpa,
              "rel_l2": rel_l2, "ptxas": ptxas}
    for line in ptxas:
        print(f"ptxas: {line}")
    print(f"{card} | K2 {k2:.4f} ms, K3 {k3:.4f} ms, K2+K3 {k2 + k3:.4f} ms, "
          f"SDPA backward {sdpa:.4f} ms | rel L2 {rel_l2}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in result if k != "ptxas"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
