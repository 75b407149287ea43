"""avatar_tpu_torch — the PyTorch + CUDA port of ``avatar_tpu``.

The JAX package stays the reference.  This package mirrors its module paths
and names (``avatar_tpu.optim.gauss_newton`` -> ``avatar_tpu_torch.optim.
gauss_newton``) so each counterpart is easy to find, and follows PyTorch
idiom: plain functions on tensors, ``NamedTuple`` containers, an explicit
``device`` argument.

It imports ``torch`` and numpy only — never ``jax`` and never
``avatar_tpu`` — so it runs on a machine without JAX.  Host-only numpy code
it needs from the reference (the srtr reader, part groups, the synthetic
model, ``TrackerConfig``) is carried as a copy, and ``tests/test_torch_*``
hold each copy against its original.

Importing the package touches no CUDA state: the one hand-written kernel
(``csrc/nn_argmin.cu``) is compiled at its first launch on a CUDA tensor
(``optim/nn_kernel.py``).
"""

__version__ = "0.1.0"
