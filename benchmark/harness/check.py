"""``correct``: the frames the window tracked, held against the plain
reference (``reference/``).

A sample of the window's body frames, drawn from the seed, with the
slowest body frame and (where the mix has them) reinit frames in it, is
tracked again by the reference: it takes over the program's tracking
state from before the frame, tracks the same uint16 frame, and its
output is compared with what the program returned for that frame.  Per
frame, ``compare`` gives the gaps; ``numbers`` reduces them to what a
cell's limits (``limits/<cell>.json``) can name:

* ``max_points_gap``: the largest difference of the labelled sample count,
  before the fit: background subtraction, the forest walk's labels, blob
  suppression and sampling;
* ``median_cost_gap``: the median over the compared frames both tracked
  of the relative gap between the fit's final cost as the program reports
  it and as the reference does: the LM fit, and through it the
  correspondence search and the labels it is fed;
* ``median_vertex_gap_mm``: the median over those frames of the largest
  distance between a vertex of the program's pose and the reference's;
* ``q25_typical_vertex_gap_mm``: the first quartile over those frames of
  the median distance between a vertex of the program's pose and the
  reference's: a fault on more than three quarters of the compared frames
  fails it, where the host tracker's chaotic fit lets no higher quantile
  separate the program from the control (PERF.md);
* ``max_lbs_gap_mm``: the largest distance between a vertex the program
  returned and the reference's vertex of the program's own pose: the
  skinning of the answer;
* ``missed_reentries`` (``window_numbers``): the window's frames that
  start a segment of the mix, a person entering the view, on which the
  program did not report ``reinitialized``.

Medians and a quartile, not the largest gaps: an LM fit amplifies the order of the
floating-point atomics it sums with, so the reference run twice from one
state can part by centimetres on a few frames, and on most frames of the
host tracker at the worst vertex (PERF.md).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np


def pick_frames(records: List[dict], seed: int, n_steady: int,
                n_reinit: int) -> List[int]:
    """Indices into ``records`` of the frames to compare: ``n_reinit``
    reinit frames and ``n_steady`` other body frames drawn from the seed,
    and the slowest body frame."""
    rng = np.random.default_rng([seed, 3])
    body = [i for i, r in enumerate(records) if r["body"]]
    reinit = [i for i in body if records[i]["out"].reinitialized]
    steady = [i for i in body if i not in set(reinit)]
    pick = set()
    for pool, n in ((reinit, n_reinit), (steady, n_steady)):
        if pool:
            pick.update(rng.choice(pool, min(n, len(pool)),
                                   replace=False).tolist())
    if body:
        pick.add(max(body, key=lambda i: records[i]["wall_s"]))
    return sorted(pick)


def compare(prog, ref, judge=None) -> Dict[str, float]:
    """The gaps between two outputs of one frame; with ``judge`` (the
    reference that produced ``ref``), also the gap between ``prog``'s
    vertices and the reference's vertices of ``prog``'s own pose."""
    out = dict(points_gap=float(abs(prog.n_points - ref.n_points)))
    if prog.ok and ref.ok:
        d = np.linalg.norm(np.asarray(prog.verts, np.float64) - ref.verts,
                           axis=1)
        out["vertex_gap_mm"] = float(np.max(d)) * 1e3
        out["typical_vertex_gap_mm"] = float(np.median(d)) * 1e3
        out["cost_gap"] = abs(prog.cost - ref.cost) / max(abs(ref.cost),
                                                          1e-30)
        if judge is not None:
            out["lbs_gap_mm"] = float(np.max(np.linalg.norm(
                np.asarray(prog.verts, np.float64) - judge.lbs(prog.theta),
                axis=1))) * 1e3
    return out


def frame_gaps(records: List[dict], picks: List[int], scene, runner,
               outputs=None) -> List[Dict[str, float]]:
    """The gaps of each picked frame between what the window's program
    returned (or ``outputs[i]``, another runner's output of record ``i``)
    and ``runner``, which takes over the program's state before the frame
    and tracks it again."""
    gaps = []
    for i in picks:
        r = records[i]
        runner.set_state(r["state_before"])
        got = runner.feed(scene.frames[r["frame"]])
        gaps.append(compare(r["out"] if outputs is None else outputs[i],
                            got, runner))
    return gaps


def numbers(gaps: List[Dict[str, float]]) -> Dict[str, float]:
    """The numbers a cell's limits can name (the module docstring)."""
    both = [g for g in gaps if "cost_gap" in g]
    out = dict(max_points_gap=max((g["points_gap"] for g in gaps),
                                  default=0.0))
    if both:
        out["max_lbs_gap_mm"] = max(g.get("lbs_gap_mm", 0.0) for g in both)
        out["median_cost_gap"] = float(np.median([g["cost_gap"]
                                                  for g in both]))
        out["median_vertex_gap_mm"] = float(np.median(
            [g["vertex_gap_mm"] for g in both]))
        out["q25_typical_vertex_gap_mm"] = float(np.quantile(
            [g["typical_vertex_gap_mm"] for g in both], 0.25))
    return out


def window_numbers(records: List[dict]) -> Dict[str, float]:
    """The numbers read off the whole window (the module docstring)."""
    return dict(missed_reentries=float(sum(
        1 for r in records if r["body"] and r["segment_start"]
        and not r["out"].reinitialized)))


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}); a number without a limit, or
    a limit without a number, is not correct."""
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in sorted(limits)}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit: the run's last lines on
    standard error."""
    for k, c in checks.items():
        print(f"[check] {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
