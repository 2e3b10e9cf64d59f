"""Weight-only int8 quantization for LM inference.

Port of ``deeplearning_mpi_tpu/ops/quant.py``. The seven big matmul
weights of each block are stored as int8 plus one float32 scale per output
channel (``scale[o] = max|W[:, o]| / 127``, so ``|w - q * scale| <=
scale / 2``); activations, norms, the embedding and the tied head stay in
the compute dtype. Checkpoints stay full precision: a trained state is
converted after restore (:func:`quantize_lm_params`). The product is
``x @ q`` in the compute dtype with the scale applied to the ``[..., out]``
result, as the reference computes it outside any Pallas kernel (int8 values
are exact in bfloat16).

:func:`quantize_kv` / :func:`dequantize_kv` are the host-side int8 KV
scheme of the reference (scale floored at 1e-12, values clipped to ±127),
kept apart from the kernel-side ``ops.kernels.flash_decode.quantize_kv``;
the serving engine's int8 KV pools (``serving/engine.py``,
``kv_dtype="int8"``) store through them.
"""

from __future__ import annotations

import torch
from torch import nn

#: the seven big matmuls per block; norms and the embedding stay full
#: precision.
DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "out_proj",
    "gate_proj", "up_proj", "down_proj",
)


class QuantDense(nn.Module):
    """Bias-free projection over an int8 ``kernel`` ``[in, out]`` and a
    float32 per-output ``scale`` ``[out]`` — what :func:`quantize_lm_params`
    emits for the ``Dense`` it replaces. Inference only: both are buffers,
    zero until a converted state dict is loaded. In bfloat16 the product is
    rounded to bfloat16 before the scale (the reference scales its float32
    accumulator); in float32 the two agree."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.register_buffer("kernel", torch.zeros(in_features, out_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return (y.float() * self.scale).to(self.dtype)


def quantize_array(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` -> (int8 ``[in, out]``, float32 ``[out]`` scales):
    symmetric round-to-nearest (half to even, as ``jnp.round``)."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cached K/V rows ``[..., head_dim]`` -> (int8 of the same shape, float32
    scale ``x.shape[:-1]``): one absmax scale per token row per head."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`, in ``dtype``."""
    return q.to(dtype) * scale[..., None].to(dtype)


def quantize_lm_params(
    state_dict: dict[str, torch.Tensor], *, targets: tuple[str, ...] = DEFAULT_TARGETS,
) -> dict[str, torch.Tensor]:
    """A full-precision ``TransformerLM`` state dict -> the state dict of the
    ``quantized=True`` model: every ``<target>.weight`` (``[out, in]``)
    becomes ``<target>.kernel`` (int8 ``[in, out]``, the reference's
    layout) and ``<target>.scale``; everything else passes through."""
    out = {}
    for name, t in state_dict.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "weight" and module.rpartition(".")[2] in targets and t.dim() == 2:
            out[f"{module}.kernel"], out[f"{module}.scale"] = quantize_array(t.T)
        else:
            out[name] = t
    return out
