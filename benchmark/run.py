"""The benchmark of avatar_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for.  Prints the run's result as the last line of standard
output, one JSON object, and each number compared for ``correct`` beside
its limit as the last lines of standard error.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.  Exits
with a code other than 0, printing no result, without enough CUDA
devices, when the program is not there, or when JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# what must not be loaded in the process that prints the result, by the
# top-level name of a module (the port's own name begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "avatar_tpu")


def loaded_forbidden(modules) -> list:
    """Names in ``modules`` (``sys.modules``) whose top-level name is
    forbidden, compared whole."""
    return sorted(n for n, m in modules.items()
                  if m is not None and n.split(".")[0] in FORBIDDEN)


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX;
    one host thread for the libraries' own pools, so that the load comes
    from one process with few threads."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import tempfile

    import torch

    from harness import check, spec
    from harness.cell import run_cell

    cell = spec.load_cell(args.workload, ROOT / "BENCHMARK.json")
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START, tempfile.gettempdir())
    bad = loaded_forbidden(sys.modules)
    if bad:
        print(f"[bench] loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    check.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
