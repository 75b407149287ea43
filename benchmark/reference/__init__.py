"""The plain reference that decides ``correct``: a frozen copy of the
eager code of the port (``avatar_tpu_torch``) as it stood when the
benchmark was written, with the plain PyTorch correspondence search in
place of the CUDA kernel and every LM step uncaptured.  It imports
neither the port nor JAX, and builds every table it uses (model tensors,
forests, fit contexts) from the raw inputs itself."""
