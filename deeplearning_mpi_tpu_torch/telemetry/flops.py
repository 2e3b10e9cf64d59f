"""Analytic FLOPs and MFU: the scaling literature's headline metric.

Port of the reference's ``telemetry/flops.py``; the counts are its
arithmetic exactly (``tests/test_torch_telemetry.py`` holds them equal to
1e-12). MFU (model FLOPs utilization) divides the *useful* model FLOPs by
what the hardware could have done in the same wall time:

    mfu = flops_per_step / (step_seconds * n_devices * peak_flops_per_device)

"Useful" is the analytic cost of the model's matmuls and convolutions, not
what the card executed (recompute under remat, padding and masked
positions do not count): PaLM's appendix B convention, comparable across
frameworks. Training costs 3x the forward (the backward takes a matmul for
each input gradient and one for each weight gradient). Attention's score
and value matmuls count the causally visible positions (S/2 on average,
capped by a sliding window): the port's kernels skip the dead half.

``n_devices`` is every device of the run (the world size), and the FLOPs
are those of the GLOBAL batch: one process holds a shard, so the trainer
passes both explicitly.

Peaks are NVIDIA's published dense bf16 tensor-core rates, matched on
``torch.cuda.get_device_name()``, with the ``DMT_PEAK_FLOPS`` override; on
the CPU a nominal constant keeps MFU defined (comparable from run to run
on one host, not a measurement).
"""

from __future__ import annotations

import os
from typing import Any

from deeplearning_mpi_tpu_torch.runtime.collectives import world_size

#: Dense bf16 tensor-core peak, FLOP/s per GPU, by device name (lower case,
#: matched in order). Source: NVIDIA H100 Tensor Core GPU datasheet
#: (nvidia.com, "H100 SXM" and "H100 PCIe" columns: BF16 1,979 and 1,513
#: teraFLOPS "with sparsity"; the dense rate is half).
PEAK_FLOPS: dict[str, float] = {
    "h100 pcie": 756.5e12,
    "h100": 989.4e12,  # H100 SXM5 ("NVIDIA H100 80GB HBM3")
}

#: Nominal CPU "peak": a few vector cores' worth. Arbitrary but stable, so
#: MFU on the CPU is defined and comparable from run to run on one host.
CPU_NOMINAL_PEAK_FLOPS = 200e9

#: NVLink bandwidth per GPU in bytes/s, by device name. Source: the same
#: datasheet ("NVLink: 900GB/s" for the SXM; "600GB/s" for the PCIe card's
#: NVLink bridge). Nominal: what a collective achieves depends on its
#: algorithm and message size; ``DMT_LINK_BANDWIDTH`` overrides.
LINK_BANDWIDTH: dict[str, float] = {
    "h100 pcie": 600e9,
    "h100": 900e9,
}

#: Nominal CPU "interconnect" (gloo over shared memory): stable, not real.
CPU_NOMINAL_LINK_BANDWIDTH = 10e9


def _device_name(device: Any | None) -> str | None:
    """The CUDA device's name (lower case), or None for the CPU. ``device``:
    None (the current CUDA device when CUDA is available), a
    ``torch.device``, an index, or a name string."""
    import torch

    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device.lower()
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device).lower()


def _lookup(table: dict[str, float], name: str) -> float:
    for key, value in table.items():
        if key in name:
            return value
    return table["h100"]  # another card: the port's target, until overridden


def device_peak_flops(device: Any | None = None) -> float:
    """Peak FLOP/s of ``device`` (default: the current CUDA device, else
    the CPU): ``DMT_PEAK_FLOPS`` -> the NVIDIA table by device name -> the
    CPU nominal constant."""
    env = os.environ.get("DMT_PEAK_FLOPS")
    if env:
        return float(env)
    name = _device_name(device)
    return CPU_NOMINAL_PEAK_FLOPS if name is None else _lookup(PEAK_FLOPS, name)


def device_link_bandwidth(device: Any | None = None) -> float:
    """Nominal interconnect bytes/s of ``device``: ``DMT_LINK_BANDWIDTH`` ->
    the NVIDIA table -> the CPU nominal constant."""
    env = os.environ.get("DMT_LINK_BANDWIDTH")
    if env:
        return float(env)
    name = _device_name(device)
    return CPU_NOMINAL_LINK_BANDWIDTH if name is None else _lookup(LINK_BANDWIDTH, name)


def overlap_fraction(
    comm_bytes_per_step: float,
    issued_flops_per_step: float,
    *,
    n_devices: int | None = None,
    peak_flops_per_device: float | None = None,
    link_bandwidth_per_device: float | None = None,
) -> float | None:
    """Estimated fraction of a step's collective time that compute could
    hide: compute time ~ issued FLOPs / (n * peak), collective time ~
    per-device wire bytes / link bandwidth; 1.0 when compute covers the
    collectives (or there are none), compute / comm when they exceed it.
    None on degenerate inputs."""
    if not issued_flops_per_step or issued_flops_per_step <= 0:
        return None
    if comm_bytes_per_step is None or comm_bytes_per_step < 0:
        return None
    if not comm_bytes_per_step:
        return 1.0
    if n_devices is None:
        n_devices = world_size()
    if peak_flops_per_device is None:
        peak_flops_per_device = device_peak_flops()
    if link_bandwidth_per_device is None:
        link_bandwidth_per_device = device_link_bandwidth()
    compute_s = issued_flops_per_step / (n_devices * peak_flops_per_device)
    comm_s = (comm_bytes_per_step / n_devices) / link_bandwidth_per_device
    if comm_s <= 0:
        return 1.0
    return min(1.0, compute_s / comm_s)


# ``xla_cost_analysis`` (the reference's count of the FLOPs and bytes a
# compiled XLA executable will execute) has no counterpart here: the port
# runs eager PyTorch and hand-written CUDA kernels, and no compiler hands it
# a cost model of a whole step. Only the analytic counts below exist; a
# device-side count would have to come from profiler hardware counters,
# which the chip's sandbox does not expose.


def mfu(
    flops_per_step: float,
    step_seconds: float,
    *,
    n_devices: int | None = None,
    peak_flops_per_device: float | None = None,
) -> float | None:
    """Model FLOPs utilization in [0, ~1]; None when inputs are degenerate.
    ``n_devices`` defaults to the world size."""
    if not flops_per_step or not step_seconds or step_seconds <= 0:
        return None
    if n_devices is None:
        n_devices = world_size()
    if peak_flops_per_device is None:
        peak_flops_per_device = device_peak_flops()
    return flops_per_step / (step_seconds * n_devices * peak_flops_per_device)


def mfu_gap_attribution(
    phase_seconds: dict[str, float],
    duration_s: float,
    *,
    mfu_issued: float | None,
    mfu_gap: float | None,
) -> dict[str, float]:
    """Decompose ``mfu_gap`` into the trainer's measured step phases.

    ``mfu_gap = mfu_issued - mfu`` is the utilization lost to everything
    that isn't useful model math. With per-phase wall-clock attribution
    (``train/trainer.py`` tracing: data_wait / h2d / collective_tail / …),
    each non-compute phase's share of the epoch directly forfeits that
    fraction of the *achievable* utilization:

        mfu_gap_<phase> = mfu_issued · (phase_seconds / duration)

    The remainder — remat recompute, padding, kernel inefficiency, and any
    stall the fences didn't isolate — lands in ``mfu_gap_residual`` so the
    returned values sum to ``mfu_gap`` exactly (the report can render the
    decomposition as shares of a closed total). The ``compute`` phase is
    the useful-work bucket and never charged to the gap.

    Returns ``{}`` on degenerate inputs (no duration, or the run didn't
    compute MFU at all) — keys absent, never faked.
    """
    if not duration_s or duration_s <= 0:
        return {}
    if mfu_issued is None or mfu_gap is None:
        return {}
    out: dict[str, float] = {}
    explained = 0.0
    for name, secs in phase_seconds.items():
        if name == "compute":
            continue
        share = mfu_issued * (float(secs) / duration_s)
        out[f"mfu_gap_{name}"] = share
        explained += share
    out["mfu_gap_residual"] = mfu_gap - explained
    return out


# ---------------------------------------------------------------------------
# Transformer / MoE (models/transformer.py, models/moe.py)
# ---------------------------------------------------------------------------

def transformer_fwd_flops(config: Any, batch: int, seq_len: int) -> float:
    """Forward FLOPs for one ``TransformerLM`` batch.

    Counts matmuls only (norms/activations/RoPE are O(d) noise):

    - embedding lookup is a gather (0 FLOPs); the LM head is a matmul,
      2·d·V per token (tied or not, the matmul runs);
    - per block: q/k/v/out projections (GQA-aware: k/v project to
      ``num_kv_heads·head_dim``), attention scores+values at
      2 · 2 · S_visible · H · Dh per token with S_visible the average
      causally-visible positions (S/2, capped by the sliding window), and
      SwiGLU MLP — three matmuls (gate, up, down), 6·d·ff per token;
    - MoE blocks swap the dense MLP for router (2·d·E) + top_k experts'
      worth of SwiGLU (GShard counts only ACTIVE expert FLOPs).
    """
    d = config.d_model
    h = config.num_heads
    hkv = getattr(config, "num_kv_heads", None) or h
    dh = config.head_dim
    ff = config.d_ff
    layers = config.num_layers
    vocab = config.vocab_size
    tokens = batch * seq_len

    window = getattr(config, "attention_window", 0)
    s_visible = seq_len / 2.0
    if window:  # 0/None = full causal attention, no cap
        s_visible = min(s_visible, float(window))

    per_token_block = 0.0
    # Projections: q (d→H·Dh), k+v (d→Hkv·Dh each), out (H·Dh→d).
    per_token_block += 2 * d * (h * dh) * 2       # q + out
    per_token_block += 2 * d * (hkv * dh) * 2     # k + v
    # Attention: scores (2·S_vis·H·Dh) + values (2·S_vis·H·Dh) per token.
    per_token_block += 4 * s_visible * h * dh

    experts = getattr(config, "moe_experts", None) or 0
    if experts:
        top_k = getattr(config, "moe_top_k", 1) or 1
        per_token_block += 2 * d * experts        # router logits
        per_token_block += top_k * 6 * d * ff     # active experts' SwiGLU
    else:
        per_token_block += 6 * d * ff             # gate + up + down

    head = 2 * d * vocab  # LM head matmul per token
    return tokens * (layers * per_token_block + head)


def transformer_train_flops(config: Any, batch: int, seq_len: int) -> float:
    return 3.0 * transformer_fwd_flops(config, batch, seq_len)


def transformer_remat_flops(
    config: Any, batch: int, seq_len: int, *, remat: Any = "none"
) -> float:
    """Extra matmul FLOPs one train step RECOMPUTES under rematerialization.

    These are issued by the hardware but are not model FLOPs — MFU's
    definition excludes them, so they belong on the issued side of the
    ledger (:func:`transformer_issued_flops`), where ``mfu_gap`` makes the
    overhead visible instead of silently inflating utilization.

    Policies (``TransformerLM.remat``):

    - ``"none"``/``False``: nothing recomputed — 0.
    - ``"dots"`` (the reference's ``checkpoint_dots`` policy): matmul
      *outputs* are saved; only the elementwise glue between them is
      recomputed, which this module counts as O(d) noise everywhere — 0
      extra matmul FLOPs, at ~the activation memory of the dots.
    - ``"full"``/``True``: every block's forward is re-executed inside the
      backward pass — one extra forward's worth of block FLOPs. The LM head
      is outside the remat boundary (remat wraps each ``Block``) and is
      not recomputed.
    """
    if isinstance(remat, str):
        remat = remat.lower()
    if remat in ("none", "", None, False):
        return 0.0
    if remat == "dots":
        return 0.0
    if remat in ("full", True):
        head = 2.0 * config.d_model * config.vocab_size * batch * seq_len
        return transformer_fwd_flops(config, batch, seq_len) - head
    raise ValueError(f"unknown remat policy {remat!r}")


def transformer_issued_flops(
    config: Any, batch: int, seq_len: int, *, remat: Any = "none"
) -> float:
    """FLOPs the hardware issues per train step: model train FLOPs plus
    remat recompute. Feed this to ``Trainer(issued_flops_per_step=...)`` /
    ``mfu`` to get ``mfu_issued``; the difference from plain ``mfu`` is the
    remat tax."""
    return transformer_train_flops(config, batch, seq_len) + (
        transformer_remat_flops(config, batch, seq_len, remat=remat)
    )


# ---------------------------------------------------------------------------
# ResNet (models/resnet.py)
# ---------------------------------------------------------------------------

_RESNET_STAGES = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}


def _conv_flops(k: int, cin: int, cout: int, oh: float, ow: float) -> float:
    return 2.0 * k * k * cin * cout * oh * ow


def resnet_fwd_flops(
    arch: str,
    batch: int,
    image_size: int = 32,
    *,
    num_classes: int = 10,
    stem: str = "cifar",
) -> float:
    """Forward FLOPs for one ResNet batch (models/resnet.py topology).

    Walks the stages exactly as the model builds them: stem, then four
    stages of Basic (2×3×3) or Bottleneck (1×1 → 3×3 → 1×1·4) blocks with
    stride 2 at each stage boundary after the first, projection shortcut
    where shape changes, then the Dense head.
    """
    stages, bottleneck = _RESNET_STAGES[arch]
    s = float(image_size)
    flops = 0.0
    cin = 3
    if stem == "imagenet":
        s /= 2  # 7×7 stride-2 stem
        flops += _conv_flops(7, cin, 64, s, s)
        s /= 2  # 3×3 stride-2 maxpool
    else:
        flops += _conv_flops(3, cin, 64, s, s)
    cin = 64
    for stage_idx, num_blocks in enumerate(stages):
        width = 64 * (2 ** stage_idx)
        for block_idx in range(num_blocks):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            s_out = s / stride
            if bottleneck:
                cout = width * 4
                flops += _conv_flops(1, cin, width, s_out, s_out)
                flops += _conv_flops(3, width, width, s_out, s_out)
                flops += _conv_flops(1, width, cout, s_out, s_out)
            else:
                cout = width
                flops += _conv_flops(3, cin, width, s_out, s_out)
                flops += _conv_flops(3, width, cout, s_out, s_out)
            if stride != 1 or cin != cout:
                flops += _conv_flops(1, cin, cout, s_out, s_out)  # projection
            cin, s = cout, s_out
    flops += 2.0 * cin * num_classes  # head
    return batch * flops


def resnet_train_flops(arch: str, batch: int, image_size: int = 32, **kw: Any) -> float:
    return 3.0 * resnet_fwd_flops(arch, batch, image_size, **kw)


# ---------------------------------------------------------------------------
# UNet (models/unet.py)
# ---------------------------------------------------------------------------

def unet_fwd_flops(
    batch: int,
    image_size: int,
    *,
    features: tuple[int, ...] = (64, 128, 256, 512),
    in_channels: int = 1,
    out_channels: int = 2,
    dim: int = 2,
) -> float:
    """Forward FLOPs for one UNet batch (models/unet.py topology).

    Encoder: DoubleConv (2 × conv3^dim) per level + 2× downsample;
    bottleneck DoubleConv at 2·features[-1]; decoder: ConvTranspose
    (2^dim kernel, stride 2, halving channels) then DoubleConv on the
    skip-concatenated input; 1×1 head. ``dim`` generalizes to 3-D (voxel
    counts scale as size^dim, conv kernels as 3^dim).
    """
    def conv(k_vol: float, cin: int, cout: int, vox: float) -> float:
        return 2.0 * k_vol * cin * cout * vox

    k3 = 3.0 ** dim
    kt = 2.0 ** dim
    size = float(image_size)
    vox = size ** dim
    flops = 0.0
    cin = in_channels
    enc_vox = []
    for f in features:
        flops += conv(k3, cin, f, vox) + conv(k3, f, f, vox)
        enc_vox.append(vox)
        cin = f
        size /= 2
        vox = size ** dim
    bott = features[-1] * 2
    flops += conv(k3, cin, bott, vox) + conv(k3, bott, bott, vox)
    cin = bott
    for f, up_vox in zip(reversed(features), reversed(enc_vox)):
        flops += conv(kt, cin, f, up_vox)                 # transposed conv
        flops += conv(k3, 2 * f, f, up_vox) + conv(k3, f, f, up_vox)
        cin = f
    flops += conv(1.0, cin, out_channels, enc_vox[0])     # 1×1 head
    return batch * flops


def unet_train_flops(batch: int, image_size: int, **kw: Any) -> float:
    return 3.0 * unet_fwd_flops(batch, image_size, **kw)
