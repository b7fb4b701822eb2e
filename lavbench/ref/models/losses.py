"""Losses of the train steps (counterpart of the functions of
`lav_tpu/models/losses.py` that `train/privileged.py` and
`train/distill.py` use).

Formula for formula lav_tpu's: every ragged reduction of LAV (selected
cars, brake-free frames) is a masked mean over fixed-capacity slots, and
a teacher's output enters through `detach` where lav_tpu has
`stop_gradient`.  Every mean over the batch is `batch_mean` /
`batch_sum`, over the one process's whole batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F



def batch_mean(x):
    """The mean over every axis (one process holds the whole batch)."""
    return x.mean()


def batch_sum(x):
    return x.sum()


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
    """The mean of x over `mask`: over the global batch with dim None, else
    along `dim` (within each item)."""
    m = mask.to(x.dtype)
    if dim is None:
        num, den = batch_sum((x * m).sum()), batch_sum(m.sum())
    else:
        num, den = (x * m).sum(dim=dim), m.sum(dim=dim)
    return num / torch.clamp(den, min=1.0)


def cross_entropy(logits, labels, dim: int = -1):
    """Integer-label cross entropy over `dim` (torch F.cross_entropy with
    no reduction): -log_softmax(logits)[label]."""
    logp = F.log_softmax(logits, dim=dim)
    return -torch.gather(logp, dim, labels.long().unsqueeze(dim)).squeeze(dim)


def det_loss(pred_heatmaps, heatmaps, pred_sizemaps, sizemaps,
             pred_orimaps, orimaps):
    """CenterNet-style detection loss on (B, 2, H, W) maps, heatmaps as
    logits: the heatmap BCE weighted by p_det = sigmoid(pred * (1 - 2 *
    target)), box and orientation SmoothL1 weighted by the GT heatmap's
    class max.  Returns (hm_loss, box_loss, ori_loss)."""
    size_w = heatmaps.amax(dim=1, keepdim=True)
    p_det = torch.sigmoid(pred_heatmaps * (1.0 - 2.0 * heatmaps))
    hm = bce_with_logits(pred_heatmaps, heatmaps)
    hm_loss = batch_mean(hm * p_det) / batch_mean(p_det)
    box_loss = (batch_mean(size_w * smooth_l1(pred_sizemaps, sizemaps))
                / batch_mean(size_w))
    ori_loss = (batch_mean(size_w * smooth_l1(pred_orimaps, orimaps))
                / batch_mean(size_w))
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
        return batch_mean(per_item)
    return masked_mean(per_item, idxs)


def plan_loss_at_cmd(ego_plan_locs, target, cmds, idxs=None):
    """L1 of each iteration's plan at the item's command, (B, I, C, T, 2)
    at cmds (B,), against target (B, T, 2) or (B, I, T, 2), per item and
    masked-averaged over `idxs` (B,) bool when given."""
    sel = torch.take_along_dim(
        ego_plan_locs, cmds.long()[:, None, None, None, None], dim=2)[:, :, 0]
    if target.ndim == 3:
        target = target[:, None]
    per_item = torch.abs(sel - target).mean(dim=(1, 2, 3))
    if idxs is None:
        return batch_mean(per_item)
    return masked_mean(per_item, idxs)


def cast_loss_at_cmd(ego_cast_locs, ego_gt, cmds):
    """L1 of the cast (B, C, T, 2) at each item's command against the GT
    future (B, T, 2)."""
    return batch_mean(torch.abs(gather_cmd(ego_cast_locs, cmds) - ego_gt))


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
        return batch_mean(err)
    return masked_mean(err.mean(dim=tuple(range(2, err.ndim))), car_valid)


def cmd_bce(pred_cmds, cmds, num_cmds: int, smooth: float = 0.0):
    """BCE of the per-command scores against the smoothed one-hot GT."""
    onehot = F.one_hot(cmds.long(), num_cmds).to(pred_cmds.dtype)
    target = (1.0 - smooth) * onehot + smooth / num_cmds
    return batch_mean(bce(pred_cmds, target))


def cmd_distill_bce(pred_cmds, expert_cmds, car_valid=None):
    e = bce(pred_cmds, expert_cmds.detach())
    if car_valid is None:
        return batch_mean(e)
    return masked_mean(e.mean(dim=-1), car_valid)
