"""Build the native helper library: python -m avatar_tpu_torch.native.build

The library goes to ``avatar_tpu_torch/_build/`` through
``build_cache``: a name keyed on a hash of the source and the flags, a
per-process temporary file moved into place.  No ``-march=native``: the
build directory may travel with the checkout to another machine.
"""

from __future__ import annotations

from pathlib import Path

from avatar_tpu_torch.build_cache import BUILD, build_cached, cached_path

_SRC = Path(__file__).resolve().parent / "src" / "avatar_native.cpp"
_BUILD = BUILD
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    """Where the library of the current source and flags goes."""
    return cached_path(_SRC, _FLAGS, "libavatar_native", _BUILD)


def build(verbose: bool = True) -> str:
    """Compile the library unless it is there, and make ``native.rle`` and
    ``native.labeling`` load it at their next call.  Returns its path."""
    from avatar_tpu_torch.native import rle

    def command(out):
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(out)]
        if verbose:
            print(" ".join(cmd))
        return cmd

    out, _ = build_cached(_SRC, _FLAGS, "libavatar_native", command, _BUILD)
    rle._LIB = None
    return str(out)


if __name__ == "__main__":
    print(f"built {build()}")
