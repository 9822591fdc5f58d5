"""clibd_tpu_torch: the PyTorch and CUDA port of clibd_tpu for one NVIDIA H100.

It imports torch and never jax, and nothing of clibd_tpu: the jax-free host
code it needs (config, data pipeline, tokenizers, metrics, tables, seed,
plots, report) is copied into its own sub-packages under the same names, each
copy headed by the file it came from.  It reads the experiment YAMLs of
`clibd_tpu/config/configs/` by path.  The JAX package is the reference its
tests hold it against.

Precision is set once here, for every matmul of the port: fp32 matmuls run in
full fp32 (no TF32, the counterpart of `Precision.HIGHEST`), and bf16 matmuls
reduce in fp32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
