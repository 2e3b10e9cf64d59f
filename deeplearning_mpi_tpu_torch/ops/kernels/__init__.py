"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

- K1 ``flash_attention`` — the flash-attention forward
  (``csrc/flash_attention_fwd.cu``), replacing the Pallas ``_fwd_kernel``;
- K2 and K3 ``flash_attention_bwd`` — its backward, dq and dk/dv
  (``csrc/flash_attention_bwd.cu``), replacing ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``; ``FlashAttentionFn`` joins K1-K3 under autograd;
- K4 ``flash_decode`` — KV-cached decode over a grouped cache
  (``csrc/flash_decode.cu``), replacing the Pallas ``_decode_kernel``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (or raises) — never a silent fallback. Each launcher
keeps a plain-int ``launches`` count so a run can show its main path went
through the kernel.
"""
