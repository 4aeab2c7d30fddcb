"""The numbers by which a candidate's features are judged against the
plain reference's.

Features are host dicts of numpy arrays over valid keypoints: ``img``
(image of the call), ``x``, ``y``, ``s``, ``a11``..``a22``, ``desc``
(N, 128) uint8, and ``overflow`` (the call's capacity overflow).  In
each image a candidate keypoint matches its nearest reference keypoint
by |dx| + |dy| + |ds| when that sum is at most MATCH_TOL pixels, and a
reference keypoint keeps only its nearest such candidate.  Then:

- kp_unmatched: keypoints of either side without a match, over all
  keypoints of both sides;
- shape_p995: the 99.5th percentile, over matched pairs, of the largest
  gap in a11, a12, a21, a22;
- desc_l1: mean absolute gap of the matched pairs' descriptor bins;
- overflow_gap: summed |overflow| gap of the calls (an exact count).
"""

from __future__ import annotations

import numpy as np

MATCH_TOL = 0.05
FIELDS = ("x", "y", "s", "a11", "a12", "a21", "a22")


def _mutual_pairs(c: dict, r: dict):
    """(candidate rows, reference rows) of one image's matched pairs."""
    if len(c["x"]) == 0 or len(r["x"]) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cp = np.stack([c["x"], c["y"], c["s"]], 1).astype(np.float64)
    rp = np.stack([r["x"], r["y"], r["s"]], 1).astype(np.float64)
    # rows sorted by x: only pairs within MATCH_TOL in x can match
    order = np.argsort(rp[:, 0], kind="stable")
    rs = rp[order]
    lo = np.searchsorted(rs[:, 0], cp[:, 0] - MATCH_TOL, "left")
    hi = np.searchsorted(rs[:, 0], cp[:, 0] + MATCH_TOL, "right")
    best_r = np.full(len(cp), -1)
    best_d = np.full(len(cp), np.inf)
    width = int((hi - lo).max()) if len(cp) else 0
    for k in range(width):
        j = lo + k
        ok = j < hi
        jj = np.where(ok, j, 0)
        d = np.abs(cp - rs[jj]).sum(1)
        better = ok & (d < best_d)
        best_d = np.where(better, d, best_d)
        best_r = np.where(better, jj, best_r)
    hit = (best_r >= 0) & (best_d <= MATCH_TOL)
    ci = np.nonzero(hit)[0]
    rj = order[best_r[hit]]
    # one candidate a reference keypoint: the nearest
    keep = np.ones(len(ci), bool)
    first = {}
    for k in np.argsort(best_d[hit], kind="stable"):
        if rj[k] in first:
            keep[k] = False
        else:
            first[rj[k]] = k
    return ci[keep], rj[keep]


def features_gap(cand: list, ref: list) -> dict:
    """The four numbers over calls: cand and ref are lists of feature
    dicts, one a call, in the same order."""
    unmatched = total = 0
    shape_gaps, l1_sum, l1_n, over = [], 0.0, 0, 0
    for c, r in zip(cand, ref, strict=True):
        over += abs(int(c["overflow"]) - int(r["overflow"]))
        for img in np.union1d(np.unique(c["img"]), np.unique(r["img"])):
            cm, rm = c["img"] == img, r["img"] == img
            ci_all, ri_all = np.nonzero(cm)[0], np.nonzero(rm)[0]
            cs = {k: c[k][cm] for k in FIELDS}
            rs = {k: r[k][rm] for k in FIELDS}
            ci, ri = _mutual_pairs(cs, rs)
            total += len(ci_all) + len(ri_all)
            unmatched += len(ci_all) + len(ri_all) - 2 * len(ci)
            if not len(ci):
                continue
            g = np.max([np.abs(cs[k][ci] - rs[k][ri])
                        for k in ("a11", "a12", "a21", "a22")], axis=0)
            shape_gaps.append(g)
            dd = np.abs(c["desc"][ci_all[ci]].astype(np.int32)
                        - r["desc"][ri_all[ri]].astype(np.int32))
            l1_sum += float(dd.sum())
            l1_n += dd.size
    gaps = np.concatenate(shape_gaps) if shape_gaps else np.zeros(0)
    return {
        "kp_unmatched": unmatched / total if total else 1.0,
        "shape_p995": float(np.quantile(gaps, 0.995)) if gaps.size else 0.0,
        "desc_l1": l1_sum / l1_n if l1_n else 0.0,
        "overflow_gap": float(over),
    }
