"""K4 (flash-decode) on one GPU: phase 4's errors, every case, and the
device time by CUDA kernel.

    python3 deeplearning_mpi_tpu_torch/cli/probe_decode.py [--root DIR] [--out FILE]

For the checkout at ``--root`` (default: the one holding this file) it
1. runs ``chip_smoke.py``'s phase-4 cases (this checkout's ``k4_cases``)
   on that checkout's K4 and prints each case's max abs error and relative
   L2 error, over the whole batch and for the worst batch row, against
   ``DEC_TOL``, without stopping at a case that fails it (a checkout from
   before the split kernel has no ``SPLIT_ROWS``: its split-edge cases use
   128 rows);
2. times K4 at ``time_flash.py``'s K4 shapes under ``torch.profiler`` and
   prints the device time of each CUDA kernel a call launches, beside the
   CUDA-event time per call.
Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--out", default=None, help="also write the result JSON here")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_decode: CUDA is not available", file=sys.stderr)
        return 1
    from deeplearning_mpi_tpu_torch.ops.kernels import flash_decode as fd

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    spec = importlib.util.spec_from_file_location("time_flash", os.path.join(HERE, "time_flash.py"))
    tf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tf)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": os.path.abspath(args.root), "card": cs.gpu_name_and_power(), "cases": []}

    for case in cs.k4_cases(getattr(fd, "SPLIT_ROWS", 128)):
        name, dtype, window = case[0], case[6], case[7]
        q, k, v, index, scales = cs.k4_inputs(torch, gen, fd, case)
        got = fd.flash_decode_cuda(q, k, v, index, window=window, **scales)
        want = fd.flash_decode_reference(q, k, v, index, window=window, **scales)
        tol = cs.DEC_TOL[str(dtype)[6:]]
        ok, err, row_rel = cs.decode_close(got, want, *tol)
        rel = cs.grads_close(got, want, *tol)[2]
        result["cases"].append({"name": name, "max_abs_err": err, "rel_l2": rel,
                                "worst_row_rel_l2": row_rel, "within": ok})
        print(f"K4 {name}: max abs err {err:.3e}, rel L2 {rel:.3e} (batch), {row_rel:.3e} "
              f"(worst row){'' if ok else ' -- outside DEC_TOL'}", flush=True)

    result["breakdown"] = []
    for row in tf.time_k4(torch, torch.nn.functional, gen):
        B, L, H, hkv, D = (row[n] for n in ("B", "L", "H", "Hkv", "D"))
        fills = tf.SERVE_FILLS if row["shape"].startswith("serve") else [L - 1] * B
        index = torch.tensor(fills, dtype=torch.int32, device="cuda")
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda")
        kb, vb = (torch.randn(B, L, hkv, D, generator=gen, device="cuda") for _ in range(2))
        for _ in range(3):
            fd.flash_decode_cuda(q, kb, vb, index)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fd.flash_decode_cuda(q, kb, vb, index)
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / 20
        entry = {"shape": row["shape"], "event_ms": row["ms"], "device_ms": by_name}
        result["breakdown"].append(entry)
        print(f"K4 {row['shape']}: {row['ms']:.4f} ms a call (events); device " + ", ".join(
            f"{n[:60]} {ms:.4f} ms" for n, ms in by_name.items()), flush=True)
        del kb, vb

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"root": result["root"], "card": result["card"],
                      "outside": [c["name"] for c in result["cases"] if not c["within"]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
