"""Train state: the model, its optimizer and optimizer state, the step.

Port of ``deeplearning_mpi_tpu/train/state.py``. The reference's state is
one immutable pytree; here it is a dataclass around the ``nn.Module``,
whose parameters the train step updates in place (no second copy of the
weights outlives the step), the optimizer chain with its state (a dict of
tensors that the step replaces), and an optional EMA of the parameters.
The model's attention core rides the state, as the reference's
``apply_fn`` carries the flax module's ``attention_fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """Everything the optimizer touches."""

    model: nn.Module
    #: the optimizer chain (``train.trainer.build_optimizer``): pure
    #: ``init`` / ``update`` functions over named tensors.
    tx: Any
    opt_state: dict[str, Any]
    step: int = 0
    #: exponential moving average of the parameters (None = EMA off),
    #: seeded with a copy of them, so no bias correction is needed.
    ema_params: dict[str, torch.Tensor] | None = None
    #: the attention core the model's full-sequence forward runs.
    attention_fn: Callable | None = None

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def eval_params(self) -> dict[str, torch.Tensor]:
        """The EMA weights when tracked, else the live parameters."""
        return self.params() if self.ema_params is None else self.ema_params


def create_train_state(
    model: nn.Module, tx: Any, *, attention_fn: Callable | None = None, ema: bool = False,
) -> TrainState:
    """Wrap an initialised model with a fresh optimizer state for ``tx``."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return TrainState(
        model=model, tx=tx, opt_state=tx.init(params),
        ema_params={n: p.clone() for n, p in params.items()} if ema else None,
        attention_fn=attention_fn,
    )
