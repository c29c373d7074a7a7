"""Detection-head ops: roialign, psroipooling, proposal (RPN) (counterpart
of csinn2_tpu/ops/ref/detection.py).

(ref: source/reference/roialign.c, psroipooling.c, proposal.c.)  The
outputs have static shapes, padded as in the JAX file: proposal always
returns rpn_post_nms_top_n rois, repeating the best box where NMS kept
fewer.  Every ROI is computed at once (the JAX file vmaps one ROI's
function); only proposal's NMS pass synchronizes, once.
"""

from __future__ import annotations

import torch

from csinn2_tpu_torch.core.dtypes import Api
from csinn2_tpu_torch.ops.params import ProposalParams, PSROIPoolingParams, RoiAlignParams
from csinn2_tpu_torch.ops.ref.misc import bin_mask, nms_keep
from csinn2_tpu_torch.ops.registry import registry


def _bilinear_at(fmap, y, x):
    """Bilinear samples of fmap [R, C, H, W] at y [R, ph] × x [R, pw] →
    [R, C, ph, pw], with the roialign border rules (ref:
    pre_calc_for_bilinear, roialign.c:30-80): a point more than one pixel
    outside the map is 0, one nearer is clamped onto it."""
    h, w = fmap.shape[2], fmap.shape[3]
    oob = (y < -1.0)[:, :, None] | (y > h)[:, :, None] | (x < -1.0)[:, None, :] | \
        (x > w)[:, None, :]
    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1, x1 = torch.clamp_max(y0 + 1, h - 1), torch.clamp_max(x0 + 1, w - 1)
    ly = (y - y0)[:, None, :, None]
    lx = (x - x0)[:, None, None, :]
    r = torch.arange(fmap.shape[0], device=fmap.device)[:, None, None]

    def at(yi, xi):                                  # [R, C, ph, pw]
        return fmap[r, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    v = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx +
         at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)
    return torch.where(oob[:, None], torch.zeros((), device=v.device), v)


@registry.register("roialign", api=Api.TORCH)
def roialign(x, rois, params: RoiAlignParams):
    """ROI Align with bilinear sampling (ref: shl_ref_roi_align_f32).
    x [N, C, H, W]; rois [R, 5] (batch, x1, y1, x2, y2) → [R, C, ph, pw]."""
    x, rois = x.float(), rois.float()
    ph, pw = params.pooled_size
    scale = params.spatial_scale
    b = rois[:, 0].int().long()
    x1, y1, x2, y2 = (rois[:, i] * scale for i in range(1, 5))
    rw = torch.clamp_min(x2 - x1, 1.0)
    rh = torch.clamp_min(y2 - y1, 1.0)
    bh, bw = rh / ph, rw / pw
    gh = gw = params.sample_ratio if params.sample_ratio > 0 else 2
    fmap = x[b]
    py = torch.arange(ph, dtype=torch.float32, device=x.device)[None]
    px = torch.arange(pw, dtype=torch.float32, device=x.device)[None]
    acc = torch.zeros((rois.shape[0], x.shape[1], ph, pw), device=x.device)
    for iy in range(gh):
        for ix in range(gw):
            yy = y1[:, None] + py * bh[:, None] + (iy + 0.5) * bh[:, None] / gh
            xx = x1[:, None] + px * bw[:, None] + (ix + 0.5) * bw[:, None] / gw
            acc = acc + _bilinear_at(fmap, yy, xx)
    return acc / (gh * gw)


@registry.register("psroipooling", api=Api.TORCH)
def psroipooling(x, rois, params: PSROIPoolingParams):
    """Position-sensitive ROI pooling (ref: shl_ref_psroipooling_f32,
    source/reference/psroipooling.c:23-90).  x [N, output_dim*g*g, H, W];
    rois [R, 5] → [R, output_dim, g, g], bin (i, j) of output channel o the
    mean of score map (o, i, j) over the bin (0 for an empty bin)."""
    x, rois = x.float(), rois.float()
    g, od = params.group_size, params.output_dim
    height, width = x.shape[2], x.shape[3]
    scale = params.spatial_scale
    b = rois[:, 0].int().long()
    sw = torch.round(rois[:, 1]) * scale
    sh = torch.round(rois[:, 2]) * scale
    ew = torch.round(rois[:, 3] + 1.0) * scale
    eh = torch.round(rois[:, 4] + 1.0) * scale
    bh = torch.clamp_min(eh - sh, 0.1) / g
    bw = torch.clamp_min(ew - sw, 0.1) / g
    k = torch.arange(g, dtype=torch.float32, device=x.device)[None]
    hs = torch.clamp(torch.floor(k * bh[:, None] + sh[:, None]), 0, height)
    he = torch.clamp(torch.ceil((k + 1) * bh[:, None] + sh[:, None]), 0, height)
    ws = torch.clamp(torch.floor(k * bw[:, None] + sw[:, None]), 0, width)
    we = torch.clamp(torch.ceil((k + 1) * bw[:, None] + sw[:, None]), 0, width)
    mh = bin_mask(hs, he, height).float()                     # [R, g, H]
    mw = bin_mask(ws, we, width).float()                      # [R, g, W]
    fmap = x[b].reshape(-1, od, g, g, height, width)
    s = torch.einsum("rih,rjw,roijhw->roij", mh, mw, fmap)
    cnt = mh.sum(-1)[:, None, :, None] * mw.sum(-1)[:, None, None, :]
    return torch.where(cnt > 0, s / torch.clamp_min(cnt, 1.0), torch.zeros((), device=x.device))


def _anchors(params: ProposalParams, device) -> torch.Tensor:
    """[A, 4] anchors around one feature cell, ratio-major
    (ref: generate_anchor, proposal.c:63-81)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)   # noqa: E731
    base = f(float(params.feature_stride))
    ctr = 0.5 * (base - 1.0)
    out = []
    for ratio in params.ratios:
        size_ratio = torch.floor(base * base / ratio)
        new_w = torch.floor(torch.sqrt(size_ratio) + 0.5)
        new_h = torch.floor(new_w * ratio + 0.5)
        for s in params.scales:
            ww, hh = new_w * s, new_h * s
            out.append(torch.stack([ctr - 0.5 * (ww - 1), ctr - 0.5 * (hh - 1),
                                    ctr + 0.5 * (ww - 1), ctr + 0.5 * (hh - 1)]))
    return torch.stack(out)


@registry.register("proposal", api=Api.TORCH)
def proposal(cls_prob, bbox_pred, im_info, params: ProposalParams):
    """Faster-RCNN RPN proposal layer (ref: shl_ref_proposal_f32,
    source/reference/proposal.c): anchors → bbox regression → clip to the
    image → min-size filter → top scores → NMS → top-N rois.

    cls_prob [N, 2*A, H, W], bbox_pred [N, 4*A, H, W], im_info [N, 3]
    (height, width, scale) → [rpn_post_nms_top_n, 5] rois (batch 0, x1, y1,
    x2, y2), batch 0 only as in the reference."""
    cls_prob, bbox_pred = cls_prob.float(), bbox_pred.float()
    im_info = im_info.float().reshape(-1)[:3]
    dev = cls_prob.device
    num_anchors = len(params.scales) * len(params.ratios)
    h, w = cls_prob.shape[2], cls_prob.shape[3]
    stride = params.feature_stride
    anchors = _anchors(params, dev)
    sy, sx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) * stride,
                            torch.arange(w, dtype=torch.float32, device=dev) * stride,
                            indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    all_anchors = (shifts + anchors[None]).reshape(-1, 4)           # [H*W*A, 4]
    # fg scores and deltas in anchor order (A fastest per cell)
    scores = cls_prob[0, num_anchors:].reshape(num_anchors, -1).T.reshape(-1)
    deltas = bbox_pred[0].reshape(num_anchors, 4, h * w).permute(2, 0, 1).reshape(-1, 4)
    # bbox regression (ref: reg_bbox, proposal.c:43-61)
    bw = all_anchors[:, 2] - all_anchors[:, 0] + 1.0
    bh = all_anchors[:, 3] - all_anchors[:, 1] + 1.0
    cx = all_anchors[:, 0] + 0.5 * (bw - 1.0)
    cy = all_anchors[:, 1] + 0.5 * (bh - 1.0)
    pcx = deltas[:, 0] * bw + cx
    pcy = deltas[:, 1] * bh + cy
    pw_ = torch.exp(torch.clamp(deltas[:, 2], -10, 10)) * bw
    ph_ = torch.exp(torch.clamp(deltas[:, 3], -10, 10)) * bh
    # clip to the image (jnp.clip: the max with 0, then the min with the edge)
    clip = lambda v, hi: torch.minimum(torch.clamp_min(v, 0), hi)   # noqa: E731
    boxes = torch.stack([clip(pcx - 0.5 * (pw_ - 1), im_info[1] - 1),
                         clip(pcy - 0.5 * (ph_ - 1), im_info[0] - 1),
                         clip(pcx + 0.5 * (pw_ - 1), im_info[1] - 1),
                         clip(pcy + 0.5 * (ph_ - 1), im_info[0] - 1)], dim=1)
    min_size = params.rpn_min_size * im_info[2]
    keep = (boxes[:, 2] - boxes[:, 0] + 1 >= min_size) & \
        (boxes[:, 3] - boxes[:, 1] + 1 >= min_size)
    scores = torch.where(keep, scores, torch.full((), float("-inf"), device=dev))
    pre_n = min(params.rpn_pre_nms_top_n, boxes.shape[0])
    top_scores, order = torch.sort(scores, descending=True, stable=True)
    top_scores, order = top_scores[:pre_n], order[:pre_n]
    top_boxes = boxes[order]
    sel = nms_keep(top_boxes, top_scores, params.threshold, params.rpn_post_nms_top_n)
    rois = top_boxes[torch.clamp_min(sel.long(), 0)]    # pad -1 → the best box
    return torch.cat([torch.zeros((rois.shape[0], 1), device=dev), rois], dim=1)
