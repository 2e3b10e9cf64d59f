"""JAX TransformerLM param tree -> this package's ``state_dict``.

The inverse direction of the reference's ``utils/torch_import.py``, for the
LM: it lets both packages compute the same function on the same weights.
Input is the flax ``params`` tree with numpy leaves (``jax.device_get`` it
first — this module never imports JAX). Flax ``Dense`` kernels are
``[in, out]``; ``nn.Linear``-style weights are ``[out, in]``, so every
projection is transposed. The tied head has no tensor of its own; an
untied ``lm_head`` kernel becomes ``lm_head.weight``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def lm_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``TransformerLM`` params (numpy leaves) -> ``state_dict`` for
    :class:`~deeplearning_mpi_tpu_torch.models.transformer.TransformerLM`."""
    sd = {"embed.weight": _t(params["embed"]["embedding"])}
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        lp, pre = params[f"layer_{i}"], f"layers.{i}"
        sd[f"{pre}.attn_norm.scale"] = _t(lp["attn_norm"]["scale"])
        sd[f"{pre}.mlp_norm.scale"] = _t(lp["mlp_norm"]["scale"])
        for name in _ATTN:
            sd[f"{pre}.attn.{name}.weight"] = _t(lp["attn"][name]["kernel"]).T.contiguous()
        for name in _MLP:
            sd[f"{pre}.mlp.{name}.weight"] = _t(lp["mlp"][name]["kernel"]).T.contiguous()
    sd["final_norm.scale"] = _t(params["final_norm"]["scale"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _t(params["lm_head"]["kernel"]).T.contiguous()
    return sd
