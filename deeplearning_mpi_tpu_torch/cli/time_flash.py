"""Time K1, K2, K3 (the flash-attention kernels) and K4 (flash-decode) on one GPU.

    python3 deeplearning_mpi_tpu_torch/cli/time_flash.py [--root DIR] [--out FILE]

It builds the kernels of the checkout at ``--root`` (default: the one
holding this file) where they are missing or older than their sources and,
with CUDA events, times
- K1 bf16 as the train step calls it (B8 S2048 H12 D64 causal, BHSD views
  of BSHD storage, with the lse) beside the forward of
  ``F.scaled_dot_product_attention``;
- K1 f32 at the serving prefill shape (B1 S512 H12 D64 causal, BSHD)
  beside SDPA;
- K2 and K3 at the training shape (BHSD) beside SDPA's backward;
- K4 f32 at the serving engine's decode shape (B8 L1024 H12 Hkv12 D64, the
  smoke test's mid-generation fills), warm (one buffer, its 15.7 MB read
  from L2) and L2-cold (8 buffers in turn, 126 MB read a round), beside
  SDPA with a mask (cold); and at L8192 with every row full, Hkv 12 and 4.
Each kernel's output is held to its plain
version in relative L2. ``--root``
lets one call time two checkouts in turns, each in its own process
(``parent, change, change, parent``). The bf16 kernels' ``-Xptxas -v`` lines
are kept (a ``C75xx`` line there means ptxas serialized the ``wgmma``s).
Prints one JSON line last.
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


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def bf16_ptxas(log: str) -> list[str]:
    """The bf16 kernels' lines of an ``-Xptxas -v`` log, and any C75xx line."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "bf16path" in line
        if keep or "C75" in line:
            lines.append(line.strip())
    return lines


#: The smoke test's phase-5 fills at the middle of generation (prompt + 15).
SERVE_FILLS = [143, 527, 215, 399, 175, 463, 271, 335]


def time_k4(torch, F, gen) -> list[dict]:
    """K4 float32 at the serving decode shape (warm, and L2-cold over 8
    buffers in turn) and at L8192 with every row full (Hkv 12 and 4; 400 and
    134 MB a call, cold by size). Bound: the filled K/V rows, q and o over
    3.35 TB/s."""
    import itertools

    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

    rows = []
    for label, L, hkv, fills, copies in (
        ("serve warm", 1024, 12, SERVE_FILLS, 1), ("serve cold", 1024, 12, SERVE_FILLS, 8),
        ("L8192 full", 8192, 12, [8191] * 8, 1), ("L8192 full Hkv4", 8192, 4, [8191] * 8, 1),
    ):
        B, H, D = len(fills), 12, 64
        index = torch.tensor(fills, dtype=torch.int32, device="cuda")
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda")
        bufs = [(torch.randn(B, L, hkv, D, generator=gen, device="cuda"),
                 torch.randn(B, L, hkv, D, generator=gen, device="cuda")) for _ in range(copies)]
        got = fd.flash_decode_cuda(q, *bufs[0], index)
        row = {"shape": label, "B": B, "L": L, "H": H, "Hkv": hkv, "D": D, "copies": copies,
               "rel_l2": rel_l2(got, fd.flash_decode_reference(q, *bufs[0], index))}
        turn = itertools.cycle(bufs)
        row["ms"] = time_ms(torch, lambda: fd.flash_decode_cuda(q, *next(turn), index))
        filled = sum(f + 1 for f in fills)
        row["bound_ms"] = (2 * filled * hkv * D + 2 * B * H * D) * 4 / 3.35e12 * 1e3
        if label == "serve cold":
            pos = torch.arange(L, device="cuda")
            mask = (pos[None, :] <= index[:, None].long())[:, None, None, :]
            sdpa = [(kb.transpose(1, 2), vb.transpose(1, 2)) for kb, vb in bufs]
            turn = itertools.cycle(sdpa)
            qs = q.transpose(1, 2)
            row["sdpa_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(qs, *next(turn), attn_mask=mask))
        rows.append(row)
        del bufs, got
    return rows


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
        print("time_flash: CUDA is not available", file=sys.stderr)
        return 1
    from deeplearning_mpi_tpu_torch.ops.kernels import _build
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    logs = _build.build_all()
    ptxas = {name: bf16_ptxas(log) for name, log in logs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": root, "card": card}

    # K1 bf16, the train step's call.
    B, H, S, D = 8, 12, 2048, 64
    views = [torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16().transpose(1, 2)
             for _ in range(3)]
    fwd = dict(causal=True, window=None, shift=0, return_lse=True, out_dtype=None, layout="bhsd")
    o, _ = fa.flash_attention_cuda(*views, **fwd)
    result["k1_bf16_rel_l2"] = rel_l2(o, fa.flash_attention_reference(*views, **fwd)[0])
    result["k1_bf16_ms"] = time_ms(torch, lambda: fa.flash_attention_cuda(*views, **fwd))
    result["sdpa_fwd_bf16_ms"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(*views, is_causal=True))
    del views, o

    # K1 f32, the serving prefill shape.
    q, k, v = (torch.randn(1, 512, H, D, generator=gen, device="cuda") for _ in range(3))
    pre = dict(causal=True, window=None, shift=0, return_lse=False, out_dtype=None, layout="bshd")
    result["k1_f32_rel_l2"] = rel_l2(fa.flash_attention_cuda(q, k, v, **pre),
                                     fa.flash_attention_reference(q, k, v, **pre))
    result["k1_f32_ms"] = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, **pre))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    result["sdpa_f32_ms"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))

    # K2 and K3 at the training shape.
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    kw = dict(causal=True, window=None, shift=0, grad_dtype=None, layout="bhsd")
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, out_dtype=None, causal=True,
                                     window=None, shift=0, layout="bhsd")
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, do, lse, **kw)
    result["bwd_rel_l2"] = {n: rel_l2(g, w) for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    result["k2_ms"] = time_ms(torch, lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, o, do, lse, **kw))
    result["k3_ms"] = time_ms(
        torch, lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, o, do, lse, delta, **kw))
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    result["sdpa_bwd_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True))

    del q, k, v, do, o, lse, dq, dk, dv, want, qs, ks, vs, out
    result["k4"] = time_k4(torch, F, gen)

    for name, lines in ptxas.items():
        for line in lines:
            print(f"ptxas {name}: {line}")
    print(f"{card} | K1 bf16 {result['k1_bf16_ms']:.4f} ms (SDPA fwd "
          f"{result['sdpa_fwd_bf16_ms']:.4f}), K1 f32 S512 {result['k1_f32_ms']:.4f} ms (SDPA "
          f"{result['sdpa_f32_ms']:.4f}), K2 {result['k2_ms']:.4f} ms, K3 {result['k3_ms']:.4f} ms "
          f"(SDPA bwd {result['sdpa_bwd_ms']:.4f})", flush=True)
    print(f"{card} | " + ", ".join(
        f"K4 {r['shape']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}"
        + (f", SDPA {r['sdpa_ms']:.4f}" if "sdpa_ms" in r else "") + ")" for r in result["k4"]),
        flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**result, "ptxas": ptxas}, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
