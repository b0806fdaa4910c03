"""PyTorch/CUDA port of datatunerx-tpu, held against the JAX package.

``datatunerx_tpu_torch/<sub>/<mod>.py`` is the counterpart of
``datatunerx_tpu/<sub>/<mod>.py``. The port imports torch and never jax, and
nothing of ``datatunerx_tpu``: what it needs of a JAX-free reference module
it keeps as its own copy. Kernels are hand-written CUDA C++ under ``csrc/``,
built with nvcc at first use (ops/_build.py); each kernel's wrapper runs its
plain PyTorch version for CPU tensors only.

It carries the paged continuous-batching serving path
(serving/server.py → serving/batched_engine.py → models/llama.py → the paged
decode, paged multi-token and fused sampling kernels) and SFT/QLoRA training
(tuning/train.py → training/train_lib.py → models/llama.py → the flash
attention kernels and, for a quantized base, the nf4/int8 matmul kernels).
"""

__version__ = "0.23.0"  # the JAX package release this port twins
