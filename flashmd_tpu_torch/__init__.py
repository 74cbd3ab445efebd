"""PyTorch + CUDA port of flashmd_tpu for NVIDIA Hopper (H100).

The JAX package ``flashmd_tpu`` is the reference; this package keeps its
module paths and function names wherever a reader looks for a
counterpart. It imports ``torch`` and never ``jax``.

Matmul precision is stated and set here, once: TF32 is not a tier the
reference has, so float32 matrix products and convolutions run in full
float32 on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
