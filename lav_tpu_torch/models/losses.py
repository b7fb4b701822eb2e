"""Losses of the distillation step (counterpart of the functions of
`lav_tpu/models/losses.py` that `train/distill.py` uses).

Formula for formula lav_tpu's: every ragged reduction of LAV (selected
cars, brake-free frames) is a masked mean over fixed-capacity slots, and
a teacher's output enters through `detach` where lav_tpu has
`stop_gradient`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits, targets):
    """Elementwise binary cross entropy on logits (stable form)."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce(probs, targets, eps: float = 1e-12):
    """Elementwise BCE on probabilities, each log clamped at -100 as
    torch's BCELoss does."""
    log_p = torch.clamp(torch.log(probs + eps), min=-100.0)
    log_1p = torch.clamp(torch.log(1.0 - probs + eps), min=-100.0)
    return -(targets * log_p + (1.0 - targets) * log_1p)


def smooth_l1(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def masked_mean(x, mask, dim=None):
    m = mask.to(x.dtype)
    num = (x * m).sum() if dim is None else (x * m).sum(dim=dim)
    den = m.sum() if dim is None else m.sum(dim=dim)
    return num / torch.clamp(den, min=1.0)


def det_loss(pred_heatmaps, heatmaps, pred_sizemaps, sizemaps,
             pred_orimaps, orimaps):
    """CenterNet-style detection loss on (B, 2, H, W) maps, heatmaps as
    logits: the heatmap BCE weighted by p_det = sigmoid(pred * (1 - 2 *
    target)), box and orientation SmoothL1 weighted by the GT heatmap's
    class max.  Returns (hm_loss, box_loss, ori_loss)."""
    size_w = heatmaps.amax(dim=1, keepdim=True)
    p_det = torch.sigmoid(pred_heatmaps * (1.0 - 2.0 * heatmaps))
    hm = bce_with_logits(pred_heatmaps, heatmaps)
    hm_loss = (hm * p_det).mean() / p_det.mean()
    box_loss = ((size_w * smooth_l1(pred_sizemaps, sizemaps)).mean()
                / size_w.mean())
    ori_loss = ((size_w * smooth_l1(pred_orimaps, orimaps)).mean()
                / size_w.mean())
    return hm_loss, box_loss, ori_loss


def gather_cmd(locs, cmds):
    """locs (B, C, T, 2) at each item's command -> (B, T, 2)."""
    return locs[torch.arange(locs.shape[0], device=locs.device),
                cmds.long()]


def plan_loss_all_cmds(ego_plan_locs, target, idxs=None, item_weights=None):
    """L1 between every iteration's and command's plan (B, I, C, T, 2)
    and one target (B, T, 2), per item, weighted by `item_weights` (B,)
    and masked-averaged over `idxs` (B,) bool when given."""
    err = torch.abs(ego_plan_locs - target[:, None, None])
    per_item = err.mean(dim=(1, 2, 3, 4))
    if item_weights is not None:
        per_item = per_item * item_weights
    if idxs is None:
        return per_item.mean()
    return masked_mean(per_item, idxs)


def other_cast_loss_min_mode(other_cast_locs, other_gt, car_valid):
    """Min over commands of the L1 (B, K, C, T, 2) vs (B, K, T, 2),
    masked-averaged over the valid car slots."""
    err = torch.abs(other_cast_locs - other_gt[:, :, None]).mean(dim=(3, 4))
    return masked_mean(err.amin(dim=2), car_valid)


def distill_l1(student, expert, car_valid=None):
    """L1 to the (detached) expert; per slot and masked over `car_valid`
    when given."""
    err = torch.abs(student - expert.detach())
    if car_valid is None:
        return err.mean()
    return masked_mean(err.mean(dim=tuple(range(2, err.ndim))), car_valid)


def cmd_bce(pred_cmds, cmds, num_cmds: int, smooth: float = 0.0):
    """BCE of the per-command scores against the smoothed one-hot GT."""
    onehot = F.one_hot(cmds.long(), num_cmds).to(pred_cmds.dtype)
    target = (1.0 - smooth) * onehot + smooth / num_cmds
    return bce(pred_cmds, target).mean()


def cmd_distill_bce(pred_cmds, expert_cmds, car_valid=None):
    e = bce(pred_cmds, expert_cmds.detach())
    if car_valid is None:
        return e.mean()
    return masked_mean(e.mean(dim=-1), car_valid)
