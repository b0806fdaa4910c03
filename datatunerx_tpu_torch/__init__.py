"""PyTorch/CUDA port of datatunerx-tpu, held against the JAX package.

``datatunerx_tpu_torch/<sub>/<mod>.py`` is the counterpart of
``datatunerx_tpu/<sub>/<mod>.py``. The port imports torch and never jax, and
nothing of ``datatunerx_tpu``: what it needs of a JAX-free reference module
it keeps as its own copy. Kernels are hand-written CUDA C++ under ``csrc/``,
built with nvcc at first use (ops/_build.py); each kernel's wrapper runs its
plain PyTorch version for CPU tensors only.

This slice carries the paged continuous-batching serving path
(serving/server.py → serving/batched_engine.py → models/llama.py → the paged
decode, paged multi-token and fused sampling kernels).
"""
