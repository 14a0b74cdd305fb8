"""Weight interchange: the JAX package's param trees (`jax_weights`) and the
reference's PyTorch checkpoints (`torch_weights`) into port state_dicts."""

from passion_tpu_torch.interop.torch_weights import (
    load_torch_checkpoint, m2ftrans_params_from_torch,
    mmformer_params_from_torch, rfnet_params_from_torch)

__all__ = ["load_torch_checkpoint", "mmformer_params_from_torch",
           "m2ftrans_params_from_torch", "rfnet_params_from_torch"]
