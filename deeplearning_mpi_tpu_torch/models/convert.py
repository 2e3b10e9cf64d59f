"""JAX param and optimizer trees -> this package's tensors.

The inverse direction of the reference's ``utils/torch_import.py``: it lets
both packages compute the same function on the same weights, and a run
trained by the JAX package continue in this one. Input is the flax tree
(or the optax state) with numpy leaves (``jax.device_get`` it first — this
module never imports JAX).

The LM: flax ``Dense`` kernels are ``[in, out]``; ``nn.Linear``-style
weights are ``[out, in]``, so every projection (and an MoE block's
``router``) is transposed, while the expert stacks ``experts_*`` keep
their ``[E, in, out]`` layout. The tied
head has no tensor of its own; an untied ``lm_head`` kernel becomes
``lm_head.weight``. The pipelined LM: :func:`pipelined_params_from_jax`
and the flat remaps beside it. The CNNs (:func:`cnn_variables_from_jax`)
and the ViT (:func:`vit_params_from_jax`): see there.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
_EXPERTS = ("experts_gate", "experts_up", "experts_down")


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _kernel(x: Any) -> torch.Tensor:
    """A flax ``[in, out]`` kernel as ``[out, in]`` (a 1-D leaf of an
    optimizer state's kernel slot, such as an Adafactor factor, as is)."""
    t = _t(x)
    return t.T.contiguous() if t.dim() == 2 else t


def transposed_from_jax(name: str) -> bool:
    """Whether the port stores parameter ``name`` as the transpose of the
    reference's array: every Dense weight (the embedding and the norm
    scales are stored alike)."""
    return name.endswith(".weight") and name != "embed.weight"


def lm_params_from_jax(params: Mapping[str, Any], model: Any = None) -> dict[str, torch.Tensor]:
    """Flax ``TransformerLM`` params (numpy leaves) -> ``state_dict`` for
    :class:`~deeplearning_mpi_tpu_torch.models.transformer.TransformerLM`;
    for an expert- or tensor-parallel ``model`` (or both), its slices and
    shards of each leaf (``parallel.tensor_parallel.shard_state_dict``)."""
    if model is not None:
        from deeplearning_mpi_tpu_torch.parallel.tensor_parallel import shard_state_dict

        return shard_state_dict(lm_params_from_jax(params), model)
    sd = {"embed.weight": _t(params["embed"]["embedding"])}
    _blocks_from_jax(params, sd)
    sd["final_norm.scale"] = _t(params["final_norm"]["scale"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _kernel(params["lm_head"]["kernel"])
    return sd


def _blocks_from_jax(params: Mapping[str, Any], sd: dict[str, torch.Tensor]) -> None:
    """Every ``layer_{i}`` block of a flax tree as ``layers.{i}.*``."""
    n_layers = sum(1 for name in params if name.startswith("layer_"))
    for i in range(n_layers):
        lp, pre = params[f"layer_{i}"], f"layers.{i}"
        sd[f"{pre}.attn_norm.scale"] = _t(lp["attn_norm"]["scale"])
        sd[f"{pre}.mlp_norm.scale"] = _t(lp["mlp_norm"]["scale"])
        for name in _ATTN:
            sd[f"{pre}.attn.{name}.weight"] = _kernel(lp["attn"][name]["kernel"])
        if "router" in lp["mlp"]:
            sd[f"{pre}.mlp.router.weight"] = _kernel(lp["mlp"]["router"]["kernel"])
            for name in _EXPERTS:
                sd[f"{pre}.mlp.{name}"] = _t(lp["mlp"][name])
            continue
        for name in _MLP:
            sd[f"{pre}.mlp.{name}.weight"] = _kernel(lp["mlp"][name]["kernel"])


def vit_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``ViT`` params (numpy leaves) -> ``state_dict`` of
    ``models.vit.ViT``: the patch conv's kernel ``[p, p, 3, d]`` as the
    CNNs' (``[d, 3, p, p]``), the CLS token, the blocks as the LM's, the
    final norm and the head's kernel transposed and bias."""
    conv = params["patch_embed"]
    sd = {"patch_embed.weight": _cnn_leaf("patch_embed", "kernel", conv["kernel"])[1].float(),
          "patch_embed.bias": _t(conv["bias"]), "cls": _t(params["cls"])}
    _blocks_from_jax(params, sd)
    sd["final_norm.scale"] = _t(params["final_norm"]["scale"])
    sd["head.weight"] = _kernel(params["head"]["kernel"])
    sd["head.bias"] = _t(params["head"]["bias"])
    return sd


# -- the pipelined LM ---------------------------------------------------------
#: Flat ``TransformerLM`` names of the pipelined model's ``embed_head``.
_ENDS = {"embed.weight": "embed_head.embed.weight",
         "final_norm.scale": "embed_head.final_norm.scale",
         "lm_head.weight": "embed_head.lm_head.weight"}


def pipelined_from_flat(sd: Mapping[str, torch.Tensor], num_stages: int) -> dict[str, torch.Tensor]:
    """A flat ``TransformerLM`` state dict as ``models.pipeline_lm.PipelinedLM``'s
    (every stage): ``layers.{s*K+j}.*`` -> ``stages.{s}.block_{j}.*`` with
    ``K = num_layers / num_stages``, and the ends under ``embed_head``."""
    n_layers = 1 + max(int(n.split(".")[1]) for n in sd if n.startswith("layers."))
    if n_layers % num_stages:
        raise ValueError(f"num_layers {n_layers} not divisible into {num_stages} stages")
    per = n_layers // num_stages
    out = {}
    for name, t in sd.items():
        if name.startswith("layers."):
            _, layer, rest = name.split(".", 2)
            s, j = divmod(int(layer), per)
            out[f"stages.{s}.block_{j}.{rest}"] = t
        else:
            out[_ENDS[name]] = t
    return out


def flat_name(name: str, per_stage: int) -> str:
    """The flat ``TransformerLM`` name of one pipelined model's leaf
    (``stages.{s}.block_{j}.*`` -> ``layers.{s*K+j}.*``, the ends from
    ``embed_head``), ``per_stage`` blocks a stage."""
    if name.startswith("stages."):
        _, stage, block, rest = name.split(".", 3)
        return f"layers.{int(stage) * per_stage + int(block.split('_')[1])}.{rest}"
    ends = {v: k for k, v in _ENDS.items()}
    return ends.get(name, name)


def flat_from_stacked(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The pipelined model's whole tree (stage leaves stacked ``[S, ...]`` as
    ``stages.block_{j}.*``, ``parallel.pipeline.PipeLayout.gather``) as a
    flat ``TransformerLM`` state dict: stage ``s``, block ``j`` ->
    ``layers.{s*K+j}``."""
    ends = {v: k for k, v in _ENDS.items()}
    blocks = {int(n.split(".")[1].split("_")[1]) for n in sd if n.startswith("stages.")}
    per = 1 + max(blocks)
    out = {}
    for name, t in sd.items():
        if not name.startswith("stages."):
            out[ends[name]] = t
            continue
        _, block, rest = name.split(".", 2)
        j = int(block.split("_")[1])
        for s in range(t.shape[0]):
            out[f"layers.{s * per + j}.{rest}"] = t[s]
    return out


def flat_params_from_pipelined(params: Mapping[str, Any]) -> dict[str, Any]:
    """The reference's ``PipelinedLM`` param tree (numpy leaves) as its flat
    ``TransformerLM`` tree: ``stages[block_j]`` leaf ``[s]`` ->
    ``layer_{s*K+j}``, and ``embed_head``'s ``embed`` / ``final_norm`` /
    ``lm_head`` at the top."""
    stages = params["stages"]
    per = len(stages)
    num_stages = len(np.asarray(_first_leaf(stages)))
    out = dict(params["embed_head"])
    for s in range(num_stages):
        for j in range(per):
            out[f"layer_{s * per + j}"] = _map_leaves(lambda x, s=s: np.asarray(x)[s],
                                                      stages[f"block_{j}"])
    return out


def _first_leaf(tree: Any) -> Any:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _map_leaves(fn, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipelined_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The reference's ``PipelinedLM`` params (numpy leaves: ``embed_head``
    and the stacked ``stages/block_j`` leaves ``[S, ...]``) -> the state
    dict of the port's ``PipelinedLM`` holding every stage: stage ``s``,
    block ``j`` from slice ``[s]`` of ``block_j``, converted as
    :func:`lm_params_from_jax` converts a layer (``PipelinedLM.load_full_state_dict``
    keeps a process's stages and model shards of it)."""
    num_stages = len(np.asarray(_first_leaf(params["stages"])))
    return pipelined_from_flat(lm_params_from_jax(flat_params_from_pipelined(params)), num_stages)


#: The optax state fields each optimizer's port state carries (beside
#: ``count``), as ``build_optimizer`` in both packages builds them.
_OPT_FIELDS = {
    "sgd": ("trace",), "adam": ("mu", "nu"), "adamw": ("mu", "nu"), "lion": ("mu",),
    "adafactor": ("v_row", "v_col", "v"),
}


def _state_fields(tree: Any, out: dict[str, list]) -> None:
    """Collect the fields of every optax state (a namedtuple) in a chain's
    nested tuples."""
    if hasattr(tree, "_fields"):
        for name in tree._fields:
            out.setdefault(name, []).append(getattr(tree, name))
    elif isinstance(tree, (tuple, list)):
        for sub in tree:
            _state_fields(sub, out)


def opt_state_from_jax(opt_state: Any, optimizer: str) -> dict[str, Any]:
    """The reference's optax state for ``build_optimizer(optimizer, ...)``
    (numpy leaves) -> the port's ``Optimizer`` state.

    Takes Adam's and AdamW's ``mu`` / ``nu``, SGD's ``trace``, Lion's
    ``mu`` and Adafactor's ``v_row`` / ``v_col`` / ``v`` (each a param
    tree, converted as :func:`lm_params_from_jax` converts the params; the
    factors are vectors and keep their order), and one ``count`` for the
    optimizer's and the schedule's counts, which must agree. SGD at a
    constant LR keeps no count in optax; the port's, which then feeds
    nothing, starts at 0.
    """
    if optimizer not in _OPT_FIELDS:
        raise ValueError(f"unknown optimizer '{optimizer}'")
    fields: dict[str, list] = {}
    _state_fields(opt_state, fields)
    counts = {int(np.asarray(c)) for c in fields.get("count", [])}
    if len(counts) > 1:
        raise ValueError(f"the optax state holds disagreeing counts {sorted(counts)}")
    out: dict[str, Any] = {
        "count": torch.tensor(counts.pop() if counts else 0, dtype=torch.int32)}
    for name in _OPT_FIELDS[optimizer]:
        if len(fields.get(name, [])) != 1:
            raise ValueError(
                f"expected one '{name}' in the optax state of '{optimizer}', found "
                f"{len(fields.get(name, []))}"
            )
        out[name] = lm_params_from_jax(fields[name][0])
    return out


def _cnn_leaf(module: str, leaf: str, x: Any) -> tuple[str, torch.Tensor]:
    """One flax leaf of a CNN as ``(torch leaf name, tensor)``, its dtype
    kept."""
    t = torch.from_numpy(np.array(x))
    if module.startswith("BatchNorm"):
        return {"scale": "weight", "bias": "bias", "mean": "running_mean",
                "var": "running_var"}[leaf], t
    if leaf == "bias":
        return "bias", t
    if module.startswith("Dense"):
        return "weight", t.T.contiguous()
    nd = t.dim() - 2
    if module.startswith("ConvTranspose"):
        # flax's transposed conv runs its kernel unflipped over the dilated
        # input; torch's is the gradient of a conv, which flips it.
        return "weight", t.flip(list(range(nd))).permute(nd, nd + 1, *range(nd)).contiguous()
    return "weight", t.permute(nd + 1, nd, *range(nd)).contiguous()


def _walk(tree: Mapping[str, Any], path: tuple[str, ...], out: dict[str, torch.Tensor]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, (*path, key), out)
            continue
        if not path:
            raise ValueError(f"leaf {key!r} outside any module")
        name, t = _cnn_leaf(path[-1], key, value)
        full = ".".join((*path, name))
        if full in out:
            raise ValueError(f"two flax leaves map to {full}")
        out[full] = t


def cnn_variables_from_jax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """Flax ResNet / UNet ``params`` and ``batch_stats`` (numpy leaves) ->
    ``state_dict`` of the port's model of the same configuration (its
    modules carry the flax names).

    Conv kernels ``[*k, in, out]`` -> ``[out, in, *k]`` (2-D and 3-D);
    ConvTranspose kernels flipped on every spatial axis, then ``[in, out,
    *k]``; Dense kernels transposed; BatchNorm ``scale`` / ``bias`` ->
    ``weight`` / ``bias`` and ``mean`` / ``var`` -> the running buffers.
    Every flax leaf becomes exactly one tensor of the leaf's dtype;
    ``load_state_dict(strict=True)`` then checks that every parameter and
    buffer is filled. The same mapping takes a gradient tree.
    """
    out: dict[str, torch.Tensor] = {}
    _walk(params, (), out)
    _walk(batch_stats or {}, (), out)
    return out
