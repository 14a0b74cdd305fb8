"""PyTorch/CUDA port of PASSION-TPU for NVIDIA Hopper (H100).

A second package beside `passion_tpu` (the JAX reference, which stays as
it is). It imports torch, numpy and scipy only — never jax, flax or
anything of `passion_tpu` — and keeps the JAX package's module names so
each counterpart is easy to find:

  * `masks`                    modality-combination tables;
  * `ops.fused_norm`           InstanceNorm + LeakyReLU, CUDA kernel pairs
                               forward (K1 stats, K2 apply) and backward (K3
                               row sums, K4 apply), with their plain version;
  * `ops.resize`               align-corners trilinear upsampling;
  * `losses`                   the PASSION per-sample losses;
  * `models`                   mmFormer inference and training forward
                               (`get_model`, `init_model`);
  * `interop.jax_weights`      JAX param tree / .npz -> port state_dict;
  * `engine.sliding_window`    the 15-mask sliding-window sweep;
  * `engine.evaluator`         Dice/HD95 scoring and the reference CSV;
  * `engine.train_loop`        the PASSION train step and `fit`, with
                               `engine.schedule` (lr, AdamW-AMSGrad),
                               `engine.checkpoint`, `engine.tb_writer`;
  * `data`                     BraTS datasets, augmentations, loader, synth;
  * `eval`, `train`            `python -m passion_tpu_torch.eval` / `.train`.

Tensors are PyTorch's (B, C, H, W, Z); the JAX package's are
(B, H, W, Z, C). Entry points run on `cuda` unless the caller passes
`device="cpu"`; asking for `cuda` without a card raises.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for `device`, refusing CUDA when no card is present
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path")
    return dev
