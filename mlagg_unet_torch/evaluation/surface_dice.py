"""Surface Dice (NSD) and surface distances — exact DeepMind semantics.

Matches the reference's standalone evaluation suite
(its evaluation/SurfaceDice.py: compute_surface_distances :280,
compute_surface_dice_at_tolerance :469, compute_robust_hausdorff :439,
compute_average_surface_distance :430, compute_dice_coefficient :481) used
by its AbdomenMRI/BTCV/ACDC eval scripts with per-organ tolerances
(abdomen_DSC_Eval.py:48-50). This is the area-weighted formulation: every
2x2x2 neighbourhood code maps to the marching-cubes surfels of that cell
(lookup table in _surfel_table.py), each surfel weighted by its area in
mm^2 under the anisotropic voxel spacing; NSD is the area fraction of both
surfaces within tolerance of the other.

Implementation is vectorized NumPy: the per-code area table is one batched
norm over the (256, 4, 3) normals; the neighbour-code map is eight shifted
adds (no generic correlation); distances use scipy's exact Euclidean
distance transform with spacing sampling.

Copied from ``mlagg_unet_tpu/evaluation/surface_dice.py`` with the imports
rewritten; ``tests/test_torch_port_aux.py`` holds it equal to that module.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.ndimage import distance_transform_edt

from mlagg_unet_torch.evaluation._surfel_table import NEIGHBOUR_CODE_NORMALS


def compute_dice_coefficient(mask_gt: np.ndarray, mask_pred: np.ndarray
                             ) -> float:
    """reference SurfaceDice.py:481."""
    volume_sum = mask_gt.sum() + mask_pred.sum()
    if volume_sum == 0:
        return np.nan
    volume_intersect = (mask_gt & mask_pred).sum()
    return 2 * volume_intersect / volume_sum


def _surfel_area_per_code(spacing_mm) -> np.ndarray:
    """(256,) surfel area in mm^2 per neighbour code: each normal component
    scales with the face area orthogonal to its axis."""
    s0, s1, s2 = (float(s) for s in spacing_mm)
    scale = np.array([s1 * s2, s0 * s2, s0 * s1])
    return np.linalg.norm(NEIGHBOUR_CODE_NORMALS * scale, axis=-1).sum(-1)


def _neighbour_code_map(mask_u8: np.ndarray) -> np.ndarray:
    """Local-binary-pattern code of every 2x2x2 neighbourhood; output voxel
    (i,j,k) covers input voxels (i-1..i, j-1..j, k-1..k) with weight
    2**(7 - (4a + 2b + c)) for offset (a,b,c) — the points sit at the
    corners of the original voxels (same layout as the reference's
    correlate(kernel=[[[128,64],[32,16]],[[8,4],[2,1]]])."""
    S = mask_u8.shape
    p = np.pad(mask_u8, ((1, 0), (1, 0), (1, 0)))
    code = np.zeros(S, np.uint8)
    for a in range(2):
        for b in range(2):
            for c in range(2):
                w = np.uint8(1 << (7 - (4 * a + 2 * b + c)))
                code += p[a:a + S[0], b:b + S[1], c:c + S[2]] * w
    return code


def _empty_result() -> dict:
    return {"distances_gt_to_pred": np.array([]),
            "distances_pred_to_gt": np.array([]),
            "surfel_areas_gt": np.array([]),
            "surfel_areas_pred": np.array([])}


def compute_surface_distances(mask_gt: np.ndarray, mask_pred: np.ndarray,
                              spacing_mm) -> dict:
    """reference SurfaceDice.py:280. Returns, for every marching-cubes
    surface element of each mask, its distance to the other mask's surface
    and its area (mm^2), each pair sorted by ascending distance."""
    mask_gt = np.asarray(mask_gt).astype(bool)
    mask_pred = np.asarray(mask_pred).astype(bool)
    area_table = _surfel_area_per_code(spacing_mm)

    mask_all = mask_gt | mask_pred
    if not mask_all.any():
        return _empty_result()
    # crop to the union bounding box + 1 voxel of zero pad at the high end
    # of each axis so the 2x2x2 neighbourhoods of boundary voxels are full
    nz = np.nonzero(mask_all)
    lo = [int(idx.min()) for idx in nz]
    hi = [int(idx.max()) for idx in nz]
    shape = tuple(h - l + 2 for l, h in zip(lo, hi))
    sl = tuple(slice(l, h + 1) for l, h in zip(lo, hi))
    crop_gt = np.zeros(shape, np.uint8)
    crop_pred = np.zeros(shape, np.uint8)
    crop_gt[:-1, :-1, :-1] = mask_gt[sl]
    crop_pred[:-1, :-1, :-1] = mask_pred[sl]

    codes_gt = _neighbour_code_map(crop_gt)
    codes_pred = _neighbour_code_map(crop_pred)
    borders_gt = (codes_gt != 0) & (codes_gt != 255)
    borders_pred = (codes_pred != 0) & (codes_pred != 255)

    if borders_gt.any():
        distmap_gt = distance_transform_edt(~borders_gt, sampling=spacing_mm)
    else:
        distmap_gt = np.full(shape, np.inf)
    if borders_pred.any():
        distmap_pred = distance_transform_edt(~borders_pred,
                                              sampling=spacing_mm)
    else:
        distmap_pred = np.full(shape, np.inf)

    d_gt = distmap_pred[borders_gt]
    d_pred = distmap_gt[borders_pred]
    a_gt = area_table[codes_gt[borders_gt]]
    a_pred = area_table[codes_pred[borders_pred]]

    # sort by (distance, area) — lexicographic like the reference's
    # sorted(zip(...)), so area-weighted percentiles are reproducible
    if d_gt.size:
        order = np.lexsort((a_gt, d_gt))
        d_gt, a_gt = d_gt[order], a_gt[order]
    if d_pred.size:
        order = np.lexsort((a_pred, d_pred))
        d_pred, a_pred = d_pred[order], a_pred[order]

    return {"distances_gt_to_pred": d_gt,
            "distances_pred_to_gt": d_pred,
            "surfel_areas_gt": a_gt,
            "surfel_areas_pred": a_pred}


def compute_surface_dice_at_tolerance(surface_distances: dict,
                                      tolerance_mm: float) -> float:
    """reference SurfaceDice.py:469 — area-weighted NSD."""
    d_gt = surface_distances["distances_gt_to_pred"]
    d_pred = surface_distances["distances_pred_to_gt"]
    a_gt = surface_distances["surfel_areas_gt"]
    a_pred = surface_distances["surfel_areas_pred"]
    total = a_gt.sum() + a_pred.sum()
    if total == 0:
        return np.nan
    overlap = (a_gt[d_gt <= tolerance_mm].sum()
               + a_pred[d_pred <= tolerance_mm].sum())
    return float(overlap / total)


def compute_surface_overlap_at_tolerance(surface_distances: dict,
                                         tolerance_mm: float
                                         ) -> Tuple[float, float]:
    """reference SurfaceDice.py:460."""
    d_gt = surface_distances["distances_gt_to_pred"]
    d_pred = surface_distances["distances_pred_to_gt"]
    a_gt = surface_distances["surfel_areas_gt"]
    a_pred = surface_distances["surfel_areas_pred"]
    with np.errstate(invalid="ignore"):
        return (float(a_gt[d_gt <= tolerance_mm].sum() / a_gt.sum()),
                float(a_pred[d_pred <= tolerance_mm].sum() / a_pred.sum()))


def compute_average_surface_distance(surface_distances: dict
                                     ) -> Tuple[float, float]:
    """reference SurfaceDice.py:430 — area-weighted mean distances."""
    d_gt = surface_distances["distances_gt_to_pred"]
    d_pred = surface_distances["distances_pred_to_gt"]
    a_gt = surface_distances["surfel_areas_gt"]
    a_pred = surface_distances["surfel_areas_pred"]
    with np.errstate(invalid="ignore"):
        avg_gt = (np.sum(d_gt * a_gt) / np.sum(a_gt)) if a_gt.size else np.nan
        avg_pred = (np.sum(d_pred * a_pred) / np.sum(a_pred)
                    ) if a_pred.size else np.nan
    return (float(avg_gt), float(avg_pred))


def compute_robust_hausdorff(surface_distances: dict, percent: float = 95.0
                             ) -> float:
    """reference SurfaceDice.py:439 — area-weighted robust Hausdorff."""
    d_gt = surface_distances["distances_gt_to_pred"]
    d_pred = surface_distances["distances_pred_to_gt"]
    a_gt = surface_distances["surfel_areas_gt"]
    a_pred = surface_distances["surfel_areas_pred"]
    if len(d_gt) > 0:
        cum = np.cumsum(a_gt) / np.sum(a_gt)
        idx = np.searchsorted(cum, percent / 100.0)
        perc_gt = d_gt[min(idx, len(d_gt) - 1)]
    else:
        perc_gt = np.inf
    if len(d_pred) > 0:
        cum = np.cumsum(a_pred) / np.sum(a_pred)
        idx = np.searchsorted(cum, percent / 100.0)
        perc_pred = d_pred[min(idx, len(d_pred) - 1)]
    else:
        perc_pred = np.inf
    return max(perc_gt, perc_pred)


# per-organ NSD tolerances used by the reference's AbdomenMRI eval
# (abdomen_DSC_Eval.py:48-50)
ABDOMEN_TOLERANCES_MM = {
    1: 5.0,   # liver
    2: 3.0,   # right kidney
    3: 3.0,   # spleen
    4: 5.0,   # pancreas
    5: 2.0,   # aorta
    6: 2.0,   # IVC
    7: 2.0,   # RAG
    8: 2.0,   # LAG
    9: 2.0,   # gallbladder
    10: 3.0,  # esophagus
    11: 5.0,  # stomach
    12: 7.0,  # duodenum
    13: 3.0,  # left kidney
}
