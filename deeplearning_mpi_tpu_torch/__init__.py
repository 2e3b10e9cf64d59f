"""deeplearning_mpi_tpu_torch — the PyTorch/CUDA port of ``deeplearning_mpi_tpu``.

The JAX package beside this one is the reference; this package computes the
same functions in PyTorch, and every Pallas TPU kernel on a ported path is a
CUDA C++ kernel written by hand for Hopper (``csrc/``). Module paths mirror
the JAX package so each counterpart is easy to find:

- ``ops.attention``          — dense / decode / batched-decode attention;
- ``ops.kernels``            — the hand-written kernels (K1 flash-attention
  forward, K2/K3 its backward and the autograd join, K4 flash-decode),
  their nvcc build, and their plain versions;
- ``ops.loss``               — LM cross-entropy, masked mean, chunked loss,
  the segmentation losses (BCE, Dice);
- ``ops.metrics``            — top-1 accuracy, Dice;
- ``ops.quant``              — weight-only int8 (``QuantDense``), host-side
  int8 KV;
- ``models.transformer``     — the decoder-only TransformerLM (training and
  inference, int8 weights);
- ``models.resnet``, ``models.unet`` — the ResNet family and the (2-D / 3-D)
  UNet with flax's numerics (``models.layers``: SAME padding, compute
  dtype; ``models.norm``: BatchNorm, global-batch under data parallelism);
  ``models.get_model``;
- ``models.moe``             — the routed Mixture-of-Experts MLP (token /
  expert choice, the load-balance loss, the dropped fraction);
- ``parallel.expert_parallel`` — the experts sharded over the mesh's expert
  axis and the collectives that join them;
- ``models.convert``         — JAX param, optimizer and CNN variable trees
  -> tensors;
- ``models.generate``        — prefill, decode, sampling, ragged prompts,
  ``generate``, ``beam_search``;
- ``runtime``                — ``torch.distributed`` bootstrap (NCCL on the
  card, gloo on the CPU), the 5-axis mesh (data and expert axes),
  collectives, hello_world;
- ``train``                  — train state (with BatchNorm statistics),
  train/eval steps for the LM, classification and segmentation,
  data-parallel over a process group, optimizers and LR schedules, the
  trainer, the ``Checkpointer`` (``train.checkpoint``);
- ``resilience``             — checkpoint digests and manifests, graceful
  preemption;
- ``data``                   — LM datasets, CIFAR-10 and segmentation datasets
  (with synthetic stand-ins) and their transforms, the batch loader
  (rank-sharded);
- ``serving``                — paged KV pool, scheduler, continuous-batching
  engine;
- ``utils.config``           — the CLIs' shared flags, restore and sidecar
  checks, runtime set-up and local launcher (``--nproc``);
- ``cli.train_lm``           — LM training (dense or MoE, ``--dp`` x ``--ep``)
  with the JAX trainer's flags, checkpoint, ``--resume`` and ``--eval_only``;
- ``cli.generate``           — text from a checkpoint (greedy, sampled, beam,
  ragged batch, int8);
- ``cli.serve_lm``           — trace replay through the engine, from a
  checkpoint or a random init, with a parity check;
- ``cli.hello_world``, ``cli.train_resnet``, ``cli.train_unet`` — the
  original repo's workloads, data-parallel over NCCL (``--device cuda``)
  or gloo (``--device cpu``), under torchrun's environment or ``--nproc N``
  local processes;
- ``cli.download``           — dataset checks and the offline CIFAR-10
  ingest (no network).

This package never imports ``jax``, ``flax`` or ``deeplearning_mpi_tpu``.
Entry points take ``device=`` and default to ``"cuda"``; asking for CUDA on
a machine without it raises (nothing falls back to the CPU silently).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent — the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
