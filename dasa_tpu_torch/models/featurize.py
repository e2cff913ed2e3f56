"""On-device observation featurization.

Counterpart of ``dasa_tpu/models/featurize.py``: the feature tables stay
resident on the device; per step only int32 row ids and small candidate
geometry index them, and these functions gather the (B, 36, F) panorama
and (B, K, F) candidate tensors the models consume.
"""

from __future__ import annotations

import torch


def angle_feature(heading, elevation, angle_feat_size: int):
    """[sin h, cos h, sin e, cos e] tiled (reference utils.py:361-368)."""
    quad = torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)
    return quad.repeat(*((1,) * (quad.dim() - 1)), angle_feat_size // 4)


def assemble_pano(feat_table, angle_table, feat_row, view_index):
    """(B,) rows + (B,) base views -> (B, 36, D + A) panorama features.
    angle_table is the (36, 36, A) all-point table."""
    vis = feat_table[feat_row.long()]                 # (B, 36, D)
    ang = angle_table[view_index.long()]              # (B, 36, A)
    return torch.cat([vis, ang.to(vis.dtype)], dim=-1)


def assemble_candidates(feat_table, feat_row, cand_point_id, cand_heading,
                        cand_elevation, cand_n, angle_feat_size: int):
    """Candidate features: the current panorama's view at each candidate's
    pointId + fresh angle features from its relative heading / absolute
    elevation (reference env.py:263-315).  Slots >= cand_n (STOP and
    padding) are zero (agent_dg.py:301-313)."""
    pano = feat_table[feat_row.long()]                               # (B,36,D)
    idx = cand_point_id.long()[..., None].expand(-1, -1, pano.shape[-1])
    vis = torch.gather(pano, 1, idx)                                 # (B,K,D)
    ang = angle_feature(cand_heading, cand_elevation,
                        angle_feat_size).to(vis.dtype)               # (B,K,A)
    feat = torch.cat([vis, ang], dim=-1)
    k = cand_point_id.shape[1]
    real = torch.arange(k, device=feat.device)[None, :] < cand_n[:, None]
    return feat * real[..., None].to(feat.dtype)


def action_angle_feat(heading, elevation, angle_feat_size: int):
    """input_a_t: (B,) heading/elevation -> (B, A) (agent_dg.py:315-319)."""
    return angle_feature(heading, elevation, angle_feat_size)
