"""Training losses of both stages. NHWC.

Counterpart of ``disentangledcolorization_tpu/train/losses.py`` (``:33-186``):
l1/l2/masked-l1/huber, cross entropy over bin indices, the Laplacian-gradient
loss, stage 1's ``spixel_loss`` and stage 2's ``AnchorColorProbLoss``. The
VGG19 perceptual term waits for VGG19 weights in the repository: without them
the JAX package falls back to a pixel L1 reconstruction term with a warning,
and so does this port; passing weights raises.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from ..ops import colorlabel as cl
from ..ops import superpixel as sp

EPS = 1e-7


def l2_loss(y_input, y_target, weight_map=None):
    if weight_map is None:
        return torch.mean((y_input - y_target) ** 2)
    diff = torch.mean(torch.abs(y_input - y_target), dim=-1, keepdim=True)
    num = torch.sum(diff * diff * weight_map, dim=(1, 2, 3))
    den = EPS + torch.sum(weight_map, dim=(1, 2, 3))
    return torch.mean(num / den)


def l1_loss(y_input, y_target, weight_map=None):
    if weight_map is None:
        return torch.mean(torch.abs(y_input - y_target))
    diff = torch.mean(torch.abs(y_input - y_target), dim=-1, keepdim=True)
    num = torch.sum(diff * weight_map, dim=(1, 2, 3))
    den = EPS + torch.sum(weight_map, dim=(1, 2, 3))
    return torch.mean(num / den)


def masked_l1_loss(y_input, y_target, outlier_mask):
    return l1_loss(y_input, y_target, torch.where(outlier_mask, 0.0, 1.0))


def huber_loss(y_input, y_target, delta: float = 0.01):
    mann = torch.abs(y_input - y_target)
    eucl = 0.5 * mann**2
    mask = (mann < delta).to(y_input.dtype)
    return torch.mean(eucl * mask / delta + (mann - 0.5 * delta) * (1 - mask))


def cross_entropy_with_indices(logits, labels):
    """Mean CE over (..., K) logits against integer labels (...,)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None]).mean()


def laplace_gradient_loss(pred_ab, target_ab):
    """L1 between the channelwise 8-neighbour Laplacians (VALID), NHWC."""
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, -8.0, 1.0], [1.0, 1.0, 1.0]], dtype=pred_ab.dtype, device=pred_ab.device)

    def lap(x):
        c = x.shape[-1]
        y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, 3, 3), groups=c)
        return y.permute(0, 2, 3, 1)

    return l1_loss(lap(target_ab), lap(pred_ab))


def spixel_loss(pred_prob, labxy_feat, kernel_size: int = 16) -> dict:
    """Stage-1 superpixel loss: pool the target features with the predicted
    affinity (N,H,W,9), unpool them again, and take the mean L2 distance of the
    reconstruction, features (all channels but the last two) and (x, y)
    position (the last two, divided by the cell size) apart."""
    pooled = sp.poolfeat(labxy_feat, pred_prob, kernel_size, kernel_size)
    recon = sp.upfeat(pooled, pred_prob, kernel_size, kernel_size)
    diff = recon - labxy_feat
    feat_loss = torch.linalg.vector_norm(diff[..., :-2], dim=-1).mean()
    pos_loss = torch.linalg.vector_norm(diff[..., -2:], dim=-1).mean() / kernel_size
    return {"totalLoss": 10.0 * feat_loss + 0.003 * pos_loss, "featLoss": feat_loss, "posLoss": pos_loss}


class AnchorColorProbLoss:
    """The colorizer's loss bundle: palLoss and refLoss are class-rebalanced
    CE over the 313 bins; recLoss is the reconstruction term (5x pixel L1 when
    no VGG19 weights are given, as in the JAX package)."""

    def __init__(self, hint2regress: bool = False, enhanced: bool = False, with_grad: bool = False,
                 vgg_variables=None):
        if vgg_variables is not None:
            raise NotImplementedError(
                "AnchorColorProbLoss: the VGG19 perceptual term is not ported yet; it waits for "
                "VGG19 weights in the repository (ROADMAP.md)"
            )
        self.hint2regress, self.enhanced, self.with_grad = hint2regress, enhanced, with_grad
        if enhanced:
            warnings.warn(
                "AnchorColorProbLoss: no VGG19 weights supplied — the reconstruction term falls "
                "back to pixel L1 instead of the reference's VGG19 perceptual loss, as the JAX "
                "package does. This trains a different objective than the paper.",
                stacklevel=2,
            )

    def __call__(self, data: dict) -> dict:
        """data: pal_logit (N,h,w,313), ref_logit, target_label (N,h,w) int,
        class_weight (N,h,w), spix_color (N,h,w,2), input_color (N,H,W,2),
        pred_color (N,H,W,2) or None."""
        gt_labels = data["target_label"]
        w = data["class_weight"][..., None]
        pal_loss = cross_entropy_with_indices(cl.rebalance_gradient(data["pal_logit"], w), gt_labels)
        if self.hint2regress:
            ref_loss = 50.0 * l2_loss(data["spix_color"], data["ref_logit"])
        else:
            ref_loss = cross_entropy_with_indices(cl.rebalance_gradient(data["ref_logit"], w), gt_labels)
        rec_loss = torch.zeros_like(pal_loss)
        if self.enhanced:
            scalar = 1.0 if self.hint2regress else 5.0
            rec_loss = scalar * l1_loss(data["pred_color"], data["input_color"])
            if self.with_grad:
                rec_loss = rec_loss + laplace_gradient_loss(data["pred_color"], data["input_color"])
        return {
            "totalLoss": pal_loss + ref_loss + rec_loss,
            "palLoss": pal_loss,
            "refLoss": ref_loss,
            "recLoss": rec_loss,
        }
