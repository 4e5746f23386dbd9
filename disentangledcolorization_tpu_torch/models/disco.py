"""AnchorColorProb: the DISCO colorization model, serving and training forwards.

Counterpart of ``disentangledcolorization_tpu/models/disco.py`` for
``sampled_T=0``, ``enhanced=True``, dense positions, at the JAX defaults
d_model=64, 8 heads, FFN 256, 313 bins, in both of its modes:

  * ``test_mode=True`` (serving): anchors by k-means over the wildpath output,
    anchor colors the most probable bin, no autograd;
  * ``test_mode=False`` (training and validation, ``disco.py:232-252``): the
    segnet runs without autograd, k-means runs on the detached ground-truth
    superpixel colors, and their bin labels feed the hintpath. ``train=True``
    adds dropout, BatchNorm batch statistics and spectral-norm updates to
    repnet, the encoders and HourGlass2; the segnet stays in eval mode.

The stages:

  segnet (SpixelNet, kernel B head)        -> 9-way affinity
  repnet (ColorProbNet)                     -> 64-ch pixel features
  pool_and_sizes([feats | ab]) (kernel A)   -> 256 tokens + sizes
  wildpath (post-norm encoder, kernel D)    -> pal_logit (313-way per token)
  k-means anchors + sample_anchor_colors    -> hint mask and anchor colors
  hintpath (post-norm encoder, kernel D)    -> ref_logit
  upfeat (kernel C) + HourGlass2 + tanh     -> full-res ab

Parameter names follow the reference torch ``state_dict`` (``segnet.net.*``,
``repnet.*``, ``wildpath.layers.*``, ``enhanceNet.*``, ...).

``compute_dtype=torch.bfloat16`` (the serving default of the JAX
``Colorizer``, and the JAX trainer's ``--compute_dtype bfloat16``) rounds
where the JAX model does (``disco.py:101-282``): the gray input to bf16 for
the segnet, repnet and HourGlass2, whose convs run in bf16 with f32
parameters; the segnet head in f32 (the affinity map is f32); in test mode
the proxy [features | ab] in bf16, pooled in f32 and rounded to bf16; with
``test_mode=False`` (training and validation) the repnet's features cast to
f32 and the f32 proxy pooled by f32 kernel A (JAX's ``precise`` pooling,
``disco.py:132-137``), so the ground-truth token labels come from f32 colors;
the encoders, projections, k-means and anchor colors in f32; the hintpath's
output rounded to bf16 before unpooling, whose f32 sums are rounded to bf16;
``tanh`` in f32. The parameters stay f32. In training the BatchNorms of the
repnet and HourGlass2 normalise in f32 and cast back, and the backward rounds
as ``models/layers.py`` says; the unpooling's token gradient is bf16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import colorlabel as cl
from ..ops import superpixel as sp
from . import anchor
from .colorprobnet import ColorProbNet
from .hourglass import HourGlass2
from .position import sine_position_encoding
from .spixelnet import SpixelSeg
from .transformer import TransformerEncoder, _linear


D_MODEL, NHEAD, D_MLP = 64, 8, 256
N_VOCAB = cl.NUM_BINS


class AnchorColorProb(nn.Module):
    def __init__(
        self,
        sp_size: int = 16,
        n_clusters: int = 8,
        n_enc_layers: int = 6,
        sn_folded: bool = False,
        dropout: float = 0.1,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.sp_size, self.n_clusters = sp_size, n_clusters
        self.compute_dtype = compute_dtype
        self.segnet = SpixelSeg()
        self.repnet = ColorProbNet(sn_folded=sn_folded)
        self.wildpath = TransformerEncoder(n_enc_layers, D_MODEL, NHEAD, D_MLP, dropout)
        self.hintpath = TransformerEncoder(n_enc_layers, D_MODEL, NHEAD, D_MLP, dropout)
        self.mid_word_prj = _linear(D_MODEL, N_VOCAB, bias=False)
        self.trg_word_emb = _linear(D_MODEL + N_VOCAB + 1, D_MODEL, bias=False)
        self.trg_word_prj = _linear(D_MODEL, N_VOCAB, bias=False)
        self.enhanceNet = HourGlass2(sn_folded=sn_folded)

    def forward(
        self,
        input_grays: torch.Tensor,
        input_colors: torch.Tensor | None = None,
        hint_mask_override: torch.Tensor | None = None,
        anchor_colors_override: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        test_mode: bool = True,
        train: bool = False,
        dropout_generator: torch.Generator | None = None,
    ) -> dict:
        """input_grays (N, H, W, 1) normalized L; input_colors (N, H, W, 2)
        normalized ab (zeros when None: at test time they only reach
        ``token_labels``). ``generator`` drives k-means, ``dropout_generator``
        the dropout masks (``train=True``).

        Test mode (under ``no_grad``): anchor colors are the most probable bin
        (``sampled_T=0``); hint_mask_override (N, h, w, 1) and
        anchor_colors_override (N, h, w, 2) replace the k-means anchors and the
        sampled colors. ``test_mode=False``: the training forward, with autograd
        as the caller has it; ``spix_colors`` are then the ground-truth ones.
        """
        with torch.set_grad_enabled(torch.is_grad_enabled() and not test_mode):
            return self._forward(input_grays, input_colors, hint_mask_override, anchor_colors_override,
                                 generator, test_mode, train, dropout_generator)

    def _forward(self, input_grays, input_colors, hint_mask_override, anchor_colors_override,
                 generator, test_mode, train, dropout_generator):
        n, h, w, _ = input_grays.shape
        spn, d, cdt = self.sp_size, D_MODEL, self.compute_dtype
        hc, wc = h // spn, w // spn
        t = hc * wc
        grays = input_grays.float()
        grays_c = grays.to(cdt)
        if input_colors is None:
            input_colors = grays.new_zeros((n, h, w, 2))

        with torch.no_grad():  # frozen segnet, always in eval mode
            affinity_map = self.segnet(grays_c)
        pred_feats = self.repnet(grays_c, train)
        if not test_mode:  # precise pooling: the ground-truth token labels come from f32 pooled colors
            pred_feats = pred_feats.float()
        proxy = torch.cat([pred_feats, input_colors.to(pred_feats.dtype)], dim=-1)
        pooled, _, spixel_sizes = sp.pool_and_sizes(proxy, affinity_map, spn, spn)
        pooled = pooled.float()
        feat_tokens, spix_colors = pooled[..., :d], pooled[..., d:]
        pos = sine_position_encoding(hc, wc, d // 2, device=grays.device)
        token_labels = cl.nearest_bin_index(spix_colors)

        src_seq = feat_tokens.reshape(n, t, d)
        pos_seq = pos.reshape(1, t, d).expand(n, t, d)
        enc_out = self.wildpath(src_seq, pos_seq, None, train, dropout_generator)
        pal_logit = self.mid_word_prj(enc_out).reshape(n, hc, wc, N_VOCAB)

        if not test_mode:
            hint_mask, _ = anchor.clustering_hint_mask(spix_colors.detach(), self.n_clusters, spixel_sizes, generator)
            labels = token_labels
        else:
            if hint_mask_override is not None:
                hint_mask = hint_mask_override.float()
            else:
                hint_mask, _ = anchor.clustering_hint_mask(
                    enc_out.reshape(n, hc, wc, d), self.n_clusters, spixel_sizes, generator
                )
            spix_colors = anchor.sample_anchor_colors(torch.softmax(pal_logit, dim=-1), T=0)
            if anchor_colors_override is not None:
                spix_colors = anchor_colors_override.float()
            labels = cl.nearest_bin_index(spix_colors)

        mask_seq = hint_mask.reshape(n, t, 1)
        label_seq = F.one_hot(labels.reshape(n, t), N_VOCAB).float()
        hint_seq = self.trg_word_emb(torch.cat([src_seq, mask_seq * label_seq, mask_seq], dim=-1))
        dec_out = self.hintpath(hint_seq, pos_seq, None, train, dropout_generator)
        ref_logit = self.trg_word_prj(dec_out).reshape(n, hc, wc, N_VOCAB)

        full_feats = sp.upfeat(dec_out.reshape(n, hc, wc, d).to(cdt), affinity_map, spn, spn)
        pred_colors = torch.tanh(self.enhanceNet(torch.cat([grays_c, full_feats], dim=-1), train).float())

        return {
            "pal_logit": pal_logit,
            "ref_logit": ref_logit,
            "pred_colors": pred_colors,
            "affinity_map": affinity_map,
            "spix_colors": spix_colors,
            "hint_mask": hint_mask,
            "token_labels": token_labels,
            "spixel_sizes": spixel_sizes,
        }


def xavier_reinit_params(model: nn.Module, generator: torch.Generator, min_ndim: int = 2) -> None:
    """Re-initialize every parameter of at least ``min_ndim`` dims xavier-uniform
    from ``generator``, in place, in ``named_parameters`` order: the
    reference's blanket ``_reset_parameters`` (JAX ``models/disco.py:296``).
    torch's fans for conv (O, I, kh, kw), transposed conv (I, O, kh, kw) and
    linear (out, in) weights give flax's bound sqrt(6 / (fan_in + fan_out)).
    Apply it before the segnet is overwritten by the stage-1 weights."""
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.ndim >= min_ndim:
                nn.init.xavier_uniform_(p, generator=generator)
