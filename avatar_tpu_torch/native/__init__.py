"""Native (C++) host-side helpers with numpy fallbacks (counterpart of
``avatar_tpu/native``).

The ``.depth`` codec (``rle``) and a union-find connected-components
labeler (``labeling``) run on the host, as the reference's C++ runtime
does; they are not device code.  ``python -m avatar_tpu_torch.native.build``
compiles ``src/avatar_native.cpp`` with the system C++ compiler into
``avatar_tpu_torch/_build/``; until it is built, the numpy paths serve.
"""

from avatar_tpu_torch.native import rle  # noqa: F401
