"""AnchorColorProb: the DISCO colorization model, serving and training forwards.

Counterpart of ``disentangledcolorization_tpu/models/disco.py`` with its
options: ``d_model``/``nhead``/``d_mlp`` (64/8/256 in the recipe),
``use_dense_pos``, ``spix_pos``, ``learning_pos``, ``random_hint``,
``hint2regress``, ``enhanced``, ``use_mask``, and the forward's
``sampled_T``. The defaults are the recipe's. Both of its modes:

  * ``test_mode=True`` (serving): anchors by k-means over the wildpath output
    (or random with ``random_hint``, or the caller's override); anchor colors
    by ``sampled_T``: 0 the most probable bin, < 0 the ground-truth
    superpixel colors, > 0 three samplings (T = 0, 1, 2) tiled into a batch of
    3N; no autograd;
  * ``test_mode=False`` (training and validation, ``disco.py:232-252``): the
    segnet runs without autograd, k-means runs on the detached ground-truth
    superpixel colors, and their bin labels (or, with ``hint2regress``, the
    colors themselves) feed the hintpath. ``train=True`` adds dropout,
    BatchNorm batch statistics and spectral-norm updates to repnet, the
    encoders and HourGlass2; the segnet stays in eval mode.

The stages:

  segnet (SpixelNet, kernel B head)        -> 9-way affinity
  repnet (ColorProbNet)                     -> d-ch pixel features
  pool_and_sizes([feats | ab (| pos)]) (A)  -> tokens + sizes (+ pooled positions)
  wildpath (post-norm encoder, kernel D)    -> pal_logit (313-way per token)
  anchors + sample_anchor_colors            -> hint mask and anchor colors
  hintpath (post-norm encoder, kernel D)    -> ref_logit (313-way, or ab)
  upfeat (kernel C) + HourGlass2 + tanh     -> full-res ab (``enhanced``)

``spix_pos`` pools the full-resolution sine code of the pixels with the
features (kernel A at C = 2d + 2); ``learning_pos`` learns the token grid's
row and column tables (``pos_enc.*``), sized by ``token_grid``; else the
token grid's sine code. ``use_mask`` masks the keys of superpixels under 25
pixels in both encoders (kernel D and its backward take the mask).

Parameter names follow the reference torch ``state_dict`` (``segnet.net.*``,
``repnet.*``, ``wildpath.layers.*``, ``enhanceNet.*``, ``pos_enc.*``, ...).

``fast_seg`` (JAX ``disco.py:63``, ``:108-114``) selects, in the JAX package,
a space-to-depth form of the segnet (``models/spixelnet_s2d.py``): the same
parameters and function, laid out for the TPU's 128-lane vectors (its
16-channel full-resolution convolutions packed 2x2 into 64 channels, the
9-way softmax over 36 lanes). On the card that layout buys nothing: the
full-resolution convolutions are cuDNN's on channels_last tensors, and the
9-way head with its softmax is kernel B, which reads the 16 channels of a
pixel as one vector already. So ``fast_seg=True`` runs the standard segnet;
its forward equals ``fast_seg=False``'s bit for bit, and JAX's
``fast_seg=True`` within f32 rounding.

int8 serving (:meth:`AnchorColorProb.set_quantization`, ``ops/quant.py``):
"int8" quantizes the repnet's and HourGlass2's gated convolutions (27 + 24 in
the recipe), "int8_safe" only HourGlass2's, with the modes off, calib, static
and dynamic held by this model alone.

``compute_dtype=torch.bfloat16`` (the serving default of the JAX
``Colorizer``, and the JAX trainer's ``--compute_dtype bfloat16``) rounds
where the JAX model does (``disco.py:101-282``): the gray input to bf16 for
the segnet, repnet and HourGlass2, whose convs run in bf16 with f32
parameters; the segnet head in f32 (the affinity map is f32); in test mode
the proxy [features | ab (| positions)] in bf16 (the ``spix_pos`` code made
in bf16), pooled in f32 and rounded to bf16; with ``test_mode=False``
(training and validation) the repnet's features cast to f32 and the f32
proxy pooled by f32 kernel A (JAX's ``precise`` pooling,
``disco.py:132-137``), so the ground-truth token labels come from f32
colors; the encoders, projections, k-means and anchor colors in f32; the
hintpath's output rounded to bf16 before unpooling, whose f32 sums are
rounded to bf16; ``tanh`` in f32. The parameters stay f32. In training the
BatchNorms of the repnet and HourGlass2 normalise in f32 and cast back, and
the backward rounds as ``models/layers.py`` says; the unpooling's token
gradient is bf16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import colorlabel as cl
from ..ops import quant
from ..ops import superpixel as sp
from . import anchor
from .colorprobnet import ColorProbNet
from .hourglass import HourGlass2
from .position import PositionEmbeddingLearned, sine_position_encoding
from .spixelnet import SpixelSeg
from .transformer import TransformerEncoder, _linear


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
        d_model: int = 64,
        nhead: int = 8,
        d_mlp: int = 256,
        use_dense_pos: bool = True,
        spix_pos: bool = False,
        learning_pos: bool = False,
        random_hint: bool = False,
        hint2regress: bool = False,
        enhanced: bool = True,
        use_mask: bool = False,
        token_grid: tuple = (16, 16),
        fast_seg: bool = False,
    ):
        """``token_grid`` (rows, columns): the size of the learned position
        tables (``learning_pos``), the input size over ``sp_size`` (JAX sizes
        them from the grid of its init example). ``fast_seg``: accepted, the
        standard segnet (module docstring)."""
        super().__init__()
        self.fast_seg = fast_seg
        self.sp_size, self.n_clusters, self.compute_dtype = sp_size, n_clusters, compute_dtype
        self.d_model, self.spix_pos, self.random_hint = d_model, spix_pos, random_hint
        self.learning_pos = learning_pos and not spix_pos  # spix_pos pools its positions
        self.hint2regress, self.enhanced, self.use_mask = hint2regress, enhanced, use_mask
        self.segnet = SpixelSeg()
        self.repnet = ColorProbNet(sn_folded=sn_folded, out_channels=d_model)
        if self.learning_pos:
            self.pos_enc = PositionEmbeddingLearned(token_grid[1], token_grid[0], d_model // 2)
        self.wildpath = TransformerEncoder(n_enc_layers, d_model, nhead, d_mlp, dropout, use_dense_pos)
        self.hintpath = TransformerEncoder(n_enc_layers, d_model, nhead, d_mlp, dropout, use_dense_pos)
        self.mid_word_prj = _linear(d_model, N_VOCAB, bias=False)
        hint_width = 2 if hint2regress else N_VOCAB
        self.trg_word_emb = _linear(d_model + hint_width + 1, d_model, bias=False)
        self.trg_word_prj = _linear(d_model, hint_width, bias=False)
        if enhanced:
            self.enhanceNet = HourGlass2(sn_folded=sn_folded, in_channels=d_model + 1)

    def set_quantization(self, quantize: str = "int8", mode: str = "static") -> int:
        """int8 serving of this model: ``quantize`` "none", "int8" or
        "int8_safe" (the repnet excluded), in ``mode`` off, calib, static or
        dynamic (``ops/quant.py::set_mode``; static needs calibrated ranges,
        from a calib forward or ``quant.load_amax``). Returns the count of
        quantized convolutions."""
        if quantize not in ("none", *quant.EXCLUDE):
            raise ValueError(f"quantize={quantize!r}: expected none, int8 or int8_safe")
        if quantize == "none":
            return quant.set_mode(self, "off")
        return quant.set_mode(self, mode, quant.EXCLUDE[quantize])

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
        sampled_T: int = 0,
    ) -> dict:
        """input_grays (N, H, W, 1) normalized L; input_colors (N, H, W, 2)
        normalized ab (zeros when None: at test time they only reach
        ``token_labels``, and the anchor colors with ``sampled_T < 0``).
        ``generator`` drives k-means and the random anchors,
        ``dropout_generator`` the dropout masks (``train=True``).

        Test mode (under ``no_grad``): ``sampled_T`` picks the anchor colors
        (0 the most probable bin; < 0 the ground-truth superpixel colors; > 0
        T = 0, 1, 2 on the batch tiled x3, so every output but ``pal_logit``
        and ``token_labels`` has 3N images, the three samplings one after the
        other); hint_mask_override (N, h, w, 1) and anchor_colors_override
        (N, h, w, 2) replace the anchors and their colors. ``test_mode=False``:
        the training forward, with autograd as the caller has it;
        ``spix_colors`` are then the ground-truth ones. ``pred_colors`` is
        None without ``enhanced``; ``ref_logit`` holds ab with ``hint2regress``.
        """
        with torch.set_grad_enabled(torch.is_grad_enabled() and not test_mode):
            return self._forward(input_grays, input_colors, hint_mask_override, anchor_colors_override,
                                 generator, test_mode, train, dropout_generator, sampled_T)

    def _positions(self, n, h, w, hc, wc, device, dtype, rows=None):
        """The token grid's positions (N, hc, wc, d), f32, unless ``spix_pos``
        pools them; with ``spix_pos`` the pixels' sine code (N, H, W, d) in
        the features' dtype, to be pooled (``rows`` (start, stop): those rows
        of the H x W image's code)."""
        d = self.d_model
        if self.spix_pos:
            code = sine_position_encoding(h, w, d // 2, device=device, dtype=dtype, rows=rows)
            return code[None].expand(n, *code.shape)
        if self.learning_pos:
            rows, cols = self.pos_enc.row_embed.num_embeddings, self.pos_enc.col_embed.num_embeddings
            if hc > rows or wc > cols:
                raise ValueError(f"learning_pos: a {hc}x{wc} token grid outgrows the {rows}x{cols} position "
                                 f"tables (token_grid)")
            return self.pos_enc(hc, wc)[None].expand(n, hc, wc, d)
        return sine_position_encoding(hc, wc, d // 2, device=device)[None].expand(n, hc, wc, d)

    def _test_anchors(self, enc_out, pal_logit, spix_colors, spixel_sizes, hint_mask_override,
                      anchor_colors_override, generator, sampled_T):
        """Test-mode hint mask (N, hc, wc, 1) and anchor colors (N or 3N, hc, wc, 2)."""
        n, hc, wc, _ = spixel_sizes.shape
        if hint_mask_override is not None:
            hint_mask = hint_mask_override.float()
        elif self.random_hint:
            hint_mask, _ = anchor.random_hint_mask(n, hc, wc, self.n_clusters, generator, enc_out.device)
        else:
            hint_mask, _ = anchor.clustering_hint_mask(enc_out.reshape(n, hc, wc, -1), self.n_clusters,
                                                       spixel_sizes, generator)
        pred_prob = torch.softmax(pal_logit, dim=-1)
        if sampled_T < 0:
            colors = spix_colors
        elif sampled_T > 0:
            colors = torch.cat([anchor.sample_anchor_colors(pred_prob, T=i) for i in (0, 1, 2)], dim=0)
        else:
            colors = anchor.sample_anchor_colors(pred_prob, T=0)
        if anchor_colors_override is not None:
            colors = anchor_colors_override.float()
        return hint_mask, colors

    def pixel_features(self, grays_c, train: bool = False, test_mode: bool = True):
        """The two full-resolution nets on ``grays_c`` (N, H, W, 1) in the
        compute dtype: (the segnet's affinity map (N, H, W, 9) f32, the
        repnet's features (N, H, W, d), cast to f32 outside test mode)."""
        with torch.no_grad():  # frozen segnet, always in eval mode
            affinity_map = self.segnet(grays_c)
        pred_feats = self.repnet(grays_c, train)
        if not test_mode:  # precise pooling: the ground-truth token labels come from f32 pooled colors
            pred_feats = pred_feats.float()
        return affinity_map, pred_feats

    def pool_tokens(self, pred_feats, input_colors, affinity_map, pos=None):
        """Kernel A over [features | ab (| the pixels' positions with
        ``spix_pos``)]: (pooled (N, hc, wc, C) f32, relative superpixel
        sizes (N, hc, wc, 1))."""
        spn = self.sp_size
        parts = [pred_feats, input_colors.to(pred_feats.dtype)] + ([pos] if self.spix_pos else [])
        pooled, _, spixel_sizes = sp.pool_and_sizes(torch.cat(parts, dim=-1), affinity_map, spn, spn)
        return pooled.float(), spixel_sizes

    def token_stage(self, pooled, spixel_sizes, pos, hint_mask_override=None, anchor_colors_override=None,
                    generator=None, test_mode: bool = True, train: bool = False, dropout_generator=None,
                    sampled_T: int = 0) -> dict:
        """Everything between pooling and unpooling, on the whole token grid:
        the wildpath, the anchors and their colors, the hintpath. ``pos``: the
        token grid's positions (ignored with ``spix_pos``, which pooled them).
        Returns the forward's token outputs and ``dec_out`` (N', hc, wc, d),
        N' = 3N for a diverse forward."""
        n, hc, wc, _ = spixel_sizes.shape
        d, spn, t = self.d_model, self.sp_size, hc * wc
        feat_tokens, spix_colors = pooled[..., :d], pooled[..., d:d + 2]
        if self.spix_pos:
            pos = pooled[..., d + 2:]
        token_labels = cl.nearest_bin_index(spix_colors)
        pad_mask = (spixel_sizes < 25.0 / (spn * spn)).reshape(n, t) if self.use_mask else None

        src_seq = feat_tokens.reshape(n, t, d)
        pos_seq = pos.reshape(n, t, d)
        enc_out = self.wildpath(src_seq, pos_seq, pad_mask, train, dropout_generator)
        pal_logit = self.mid_word_prj(enc_out).reshape(n, hc, wc, N_VOCAB)

        if test_mode:
            hint_mask, spix_colors = self._test_anchors(enc_out, pal_logit, spix_colors, spixel_sizes,
                                                        hint_mask_override, anchor_colors_override,
                                                        generator, sampled_T)
            if sampled_T > 0:  # diverse: the batch tiled x3, one sampling each
                n = 3 * n
                hint_mask, src_seq, pos_seq = (x.repeat(3, *(1,) * (x.ndim - 1)) for x in (hint_mask, src_seq, pos_seq))
                pad_mask = None if pad_mask is None else pad_mask.repeat(3, 1)
            labels = cl.nearest_bin_index(spix_colors)
        else:
            hint_mask, _ = anchor.clustering_hint_mask(spix_colors.detach(), self.n_clusters, spixel_sizes, generator)
            labels = token_labels

        mask_seq = hint_mask.reshape(n, t, 1)
        if self.hint2regress:  # the anchor colors themselves (ground truth in training)
            hint = spix_colors.reshape(n, t, 2)
        else:
            hint = F.one_hot(labels.reshape(n, t), N_VOCAB).float()
        hint_seq = self.trg_word_emb(torch.cat([src_seq, mask_seq * hint, mask_seq], dim=-1))
        dec_out = self.hintpath(hint_seq, pos_seq, pad_mask, train, dropout_generator)
        return {
            "pal_logit": pal_logit,
            "ref_logit": self.trg_word_prj(dec_out).reshape(n, hc, wc, -1),
            "spix_colors": spix_colors,
            "hint_mask": hint_mask,
            "token_labels": token_labels,
            "spixel_sizes": spixel_sizes,
            "dec_out": dec_out.reshape(n, hc, wc, d),
        }

    def enhance(self, dec_out, grays_c, affinity_map, train: bool = False):
        """Kernel C unpools the hintpath's tokens (N, hc, wc, d); HourGlass2
        takes them with the gray input; tanh: the full-resolution ab (N, H, W, 2)."""
        spn = self.sp_size
        full_feats = sp.upfeat(dec_out.to(self.compute_dtype), affinity_map, spn, spn)
        return torch.tanh(self.enhanceNet(torch.cat([grays_c, full_feats], dim=-1), train).float())

    def _forward(self, input_grays, input_colors, hint_mask_override, anchor_colors_override,
                 generator, test_mode, train, dropout_generator, sampled_T):
        n, h, w, _ = input_grays.shape
        spn = self.sp_size
        hc, wc = h // spn, w // spn
        grays = input_grays.float()
        grays_c = grays.to(self.compute_dtype)
        if input_colors is None:
            input_colors = grays.new_zeros((n, h, w, 2))

        affinity_map, pred_feats = self.pixel_features(grays_c, train, test_mode)
        pos = self._positions(n, h, w, hc, wc, grays.device, pred_feats.dtype)
        pooled, spixel_sizes = self.pool_tokens(pred_feats, input_colors, affinity_map, pos)
        out = self.token_stage(pooled, spixel_sizes, pos, hint_mask_override, anchor_colors_override, generator,
                               test_mode, train, dropout_generator, sampled_T)
        dec_out = out.pop("dec_out")
        if dec_out.shape[0] > n:  # diverse: the batch tiled x3, one sampling each
            grays_c, affinity_map = (x.repeat(3, *(1,) * (x.ndim - 1)) for x in (grays_c, affinity_map))
        pred_colors = self.enhance(dec_out, grays_c, affinity_map, train) if self.enhanced else None
        return {"pal_logit": out["pal_logit"], "ref_logit": out["ref_logit"], "pred_colors": pred_colors,
                "affinity_map": affinity_map, **{k: out[k] for k in ("spix_colors", "hint_mask", "token_labels",
                                                                        "spixel_sizes")}}


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
