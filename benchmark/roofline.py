"""The yardstick's arithmetic: the card's peaks, the FP32 operations of one
avatar fit counted from its shapes, and the least time of one
correspondence search.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 67
TFLOP/s in FP32 outside the tensor cores, 3.35 TB/s of HBM.  A count here
depends on the shapes of the work and not on the code that does it, so a
faster implementation of the same fit reads a higher share.
"""

from __future__ import annotations

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# one scanned (row, slot) pair of the search: three differences, three
# products, two sums and the compare (chip_smoke.py's count)
OPS_PER_PAIR = 9


def lbs_flops(P: int, J: int, K: int) -> int:
    """One LBS forward pass: the shape blend (P x 3 x K), the joints' blend
    (J x 3 x K), the kinematic chain (J 3x3 products and translations),
    the blend of the J transforms per vertex (P x J x 12) and the transform
    of each vertex (P x 3 x 3 plus the translation)."""
    return (2 * P * 3 * K + 2 * J * 3 * K + J * (45 + 15) +
            2 * P * J * 12 + P * 21)


def jacobian_flops(P: int, J: int, K: int, with_shape: bool) -> int:
    """d(posed vertex)/d(delta) for every model vertex: the rotated shaped
    points (P x J x 3 x 3), the ancestor sums (P x J x J x 3, and the
    weights' P x J x J), the weighted terms and the skew blocks; with the
    shape columns, A_p times the shape directions (P x 3 x 3 x K) and the
    weights times the joint terms (P x J x 3 x K)."""
    n = 2 * P * J * 9 + 2 * P * J * J * 3 + 2 * P * J * J + 4 * P * J * 3
    if with_shape:
        n += 2 * P * 9 * K + 2 * P * J * 3 * K
    return n


def gram_flops(P: int, D: int) -> int:
    """J^T J and J^T r of the point rows (3P x D) and the plane rows
    (P x D), with the plane rows' projection (P x 3 x D)."""
    return 2 * 3 * P * D * D + 2 * 3 * P * D + 2 * P * 3 * D + \
        2 * P * D * D + 2 * P * D


def solve_flops(D: int) -> int:
    """Cholesky of the damped D x D system and two triangular solves."""
    return D ** 3 // 3 + 2 * D * D


def search_pairs(n_tiles_ranges, chunk: int, tile_n: int) -> int:
    """Scanned (row, slot) pairs of one search: each tile's rows times the
    slots of its chunk range.  ``n_tiles_ranges`` is [(start, end)] per
    tile, in chunks."""
    return sum(max(e - s, 0) for s, e in n_tiles_ranges) * chunk * tile_n


def fit_flops(P: int, J: int, K: int, D: int, lin_steps: int, steps: int,
              pairs: int) -> int:
    """FP32 operations of one fit: per linearization the Jacobian, the
    gram and the search; per step the solve and the trial's LBS forward;
    and the first forward."""
    per_lin = (jacobian_flops(P, J, K, D > 3 + 3 * J) + gram_flops(P, D) +
               pairs * OPS_PER_PAIR)
    per_step = solve_flops(D) + lbs_flops(P, J, K)
    return lbs_flops(P, J, K) + lin_steps * per_lin + steps * per_step


def search_bound_ms(n_rows: int, n_slots: int, n_tiles: int,
                    pairs: int) -> tuple:
    """The least time (ms) the card could take for one search, and what
    bounds it (chip_smoke.py's ``_bound`` on the search's arguments): each
    input read once and each output written once over HBM bandwidth
    (data rows 3 x f32 + i32 label, model slots 3 x f32 + i32 part + a
    bool, two i32 per tile, 8 bytes per row out), against the scanned
    pairs' FP32 operations over the FP32 peak."""
    n_bytes = (n_rows * 16 + n_slots * 17 + n_tiles * 8 + n_rows * 8)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = pairs * OPS_PER_PAIR / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")
