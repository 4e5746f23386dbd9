"""JAX package flax variables <-> this package's ``state_dict``.

:func:`from_jax_variables` is the inverse of the layout transforms in
``disentangledcolorization_tpu/tools/convert_torch.py`` (which maps a reference
torch ``state_dict`` onto the flax tree); :func:`to_jax_variables` applies
them, so that a port model's weights can be written as the ``.pkl`` the JAX
package's loaders read. The flax variables come as nested dicts of numpy
arrays:

  HWIO conv kernel (kh, kw, I, O)            -> Conv2d weight (O, I, kh, kw)
  pre-flipped deconv kernel (kh, kw, I, O)   -> ConvTranspose2d weight (I, O, kh, kw), unflipped
  Dense kernel (in, out)                      -> Linear weight (out, in)
  BN scale/bias + batch_stats mean/var        -> weight/bias/running_mean/running_var
  SNConv kernel (+ spectral u when unfolded)  -> weight_orig, weight_u, weight_v

With ``sn_folded=True`` the kernels already carry 1/sigma; ``weight_u`` and
``weight_v`` are then placeholders the folded model never reads. Unfolded,
``weight_v`` is set to normalize(W^T u), the value the port's own
initialisation gives it, and ``weight_u`` is the ``spectral`` u.

:func:`grads_from_jax` maps a gradient tree (shaped like ``params``) the same
way: every transform above is a permutation, so it carries gradients too.
:func:`spixel_from_jax_variables` and :func:`spixel_grads_from_jax` do both
for a standalone ``SpixelSeg`` (stage 1, ``net.*`` keys);
:func:`decoder_from_jax_variables` and :func:`decoder_grads_from_jax` for a
standalone ``TransformerDecoder`` (``layers.{i}.self_attn.*``,
``layers.{i}.corr_attn.*``, ``layers.{i}.norm3.*``: the flax module names),
and :func:`sn_block_from_jax_variables` for a ``ResidualBlockSN`` or an
``UpsampleBlockSN``.
:func:`inception_from_jax_variables` and :func:`inception_to_jax_variables`
bridge ``InceptionV3Features`` (torchvision's ``inception_v3`` keys) both ways,
the second as ``convert_inception_torchvision`` lays the tree out.
:func:`quant_from_jax_variables` and :func:`quant_to_jax_variables` bridge
int8's calibrated ranges: JAX's ``quant`` collection (``repnet/conv2_3/conv0/
act_amax``, one leaf under each quantized ``Conv``/``SNConv``) and the port's
``act_amax`` buffers by module name (``repnet.conv2_3.2.act_amax``,
``ops/quant.py::gated_amax``).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch


def _conv_w(k):
    return np.transpose(k, (3, 2, 0, 1))


def _deconv_w(k):
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])


class _StateDictBuilder:
    """Reads flax leaves by path and writes torch keys (inverse of the
    converter's ``_TreeBuilder``; same method names)."""

    def __init__(self, variables: dict, sn_folded: bool, buffers: bool = True):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.spectral = variables.get("spectral", {})
        self.sn_folded = sn_folded
        self.buffers = buffers  # False: parameters only (a gradient tree)
        self.sd: dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree: dict, path: tuple):
        for p in path:
            tree = tree[p]
        return np.asarray(tree, dtype=np.float32)

    @staticmethod
    def _has(tree: dict, path: tuple) -> bool:
        for p in path:
            if not isinstance(tree, dict) or p not in tree:
                return False
            tree = tree[p]
        return True

    def n_layers(self, tprefix: str, path: tuple) -> int:
        return sum(1 for k in self.params[path[-1]] if k.startswith("layer"))

    def has(self, tprefix: str, path: tuple) -> bool:
        return self._has(self.params, path)

    def copy(self, tkey: str, path: tuple):
        self.sd[tkey] = self._get(self.params, path)

    def _bias(self, tkey: str, path: tuple):
        if self._has(self.params, path + ("bias",)):
            self.sd[f"{tkey}.bias"] = self._get(self.params, path + ("bias",))

    def conv(self, tkey: str, path: tuple):
        self.raw_conv(tkey, path + ("conv",))

    def raw_conv(self, tkey: str, path: tuple):
        self.sd[f"{tkey}.weight"] = _conv_w(self._get(self.params, path + ("kernel",)))
        self._bias(tkey, path)

    def deconv(self, tkey: str, path: tuple):
        self.sd[f"{tkey}.weight"] = _deconv_w(self._get(self.params, path + ("kernel",)))
        self._bias(tkey, path)

    def snconv(self, tkey: str, path: tuple):
        w = _conv_w(self._get(self.params, path + ("kernel",)))
        o = w.shape[0]
        self._bias(tkey, path)
        self.sd[f"{tkey}.weight_orig"] = w
        if not self.buffers:
            return
        if self.sn_folded:
            u = np.full((o,), 1.0 / np.sqrt(o), np.float32)
        else:
            u = self._get(self.spectral, path + ("u",))
        v = w.reshape(o, -1).T @ u
        self.sd[f"{tkey}.weight_u"] = u
        self.sd[f"{tkey}.weight_v"] = (v / (np.linalg.norm(v) + 1e-12)).astype(np.float32)

    def bn(self, tkey: str, path: tuple):
        self.sd[f"{tkey}.weight"] = self._get(self.params, path + ("bn", "scale"))
        self.sd[f"{tkey}.bias"] = self._get(self.params, path + ("bn", "bias"))
        if not self.buffers:
            return
        self.sd[f"{tkey}.running_mean"] = self._get(self.stats, path + ("bn", "mean"))
        self.sd[f"{tkey}.running_var"] = self._get(self.stats, path + ("bn", "var"))
        self.sd[f"{tkey}.num_batches_tracked"] = np.zeros((), np.int64)

    def linear(self, tkey: str, path: tuple):
        self.sd[f"{tkey}.weight"] = self._get(self.params, path + ("kernel",)).T
        self._bias(tkey, path)

    def layernorm(self, tkey: str, path: tuple):
        self.sd[f"{tkey}.weight"] = self._get(self.params, path + ("scale",))
        self.sd[f"{tkey}.bias"] = self._get(self.params, path + ("bias",))


def _spixelnet(b: _StateDictBuilder, tprefix: str, path: tuple):
    units = [
        "conv0a", "conv0b", "conv1a", "conv1b", "conv2a", "conv2b",
        "conv3a", "conv3b", "conv4a", "conv4b", "conv3_1", "conv2_1",
        "conv1_1", "conv0_1",
    ]
    for u in units:
        b.raw_conv(f"{tprefix}{u}.0", path + (u, "conv"))
        b.bn(f"{tprefix}{u}.1", path + (u, "norm"))
    for d in ("deconv3", "deconv2", "deconv1", "deconv0"):
        b.deconv(f"{tprefix}{d}.0", path + (d, "deconv"))
    b.raw_conv(f"{tprefix}pred_mask0", path + ("pred_mask0",))


def _colorprobnet(b: _StateDictBuilder, tprefix: str, path: tuple):
    stages = {"conv1_2": 2, "conv2_3": 3, "conv3_3": 3, "conv4_3": 3, "conv5_3": 3, "conv6_3": 3, "conv7_3": 3}
    for name, n in stages.items():
        for i in range(n):
            b.snconv(f"{tprefix}{name}.{2 * i}", path + (name, f"conv{i}"))
        b.bn(f"{tprefix}{name}.{2 * n}", path + (name, "norm"))
    b.conv(f"{tprefix}conv8up.1", path + ("conv8up",))
    b.conv(f"{tprefix}conv3short8.0", path + ("conv3short8",))
    b.conv(f"{tprefix}conv8_3.1", path + ("conv8_1",))
    b.conv(f"{tprefix}conv8_3.3", path + ("conv8_2",))
    b.bn(f"{tprefix}conv8_3.5", path + ("norm8",))
    b.conv(f"{tprefix}conv9up.1", path + ("conv9up",))
    b.conv(f"{tprefix}conv9_2.0", path + ("conv9_1",))
    b.bn(f"{tprefix}conv9_2.2", path + ("norm9",))
    b.conv(f"{tprefix}conv10up.1", path + ("conv10up",))
    b.conv(f"{tprefix}conv10_2.1", path + ("conv10_1",))


def _encoder(b: _StateDictBuilder, tprefix: str, path: tuple):
    for i in range(b.n_layers(tprefix, path)):
        tl, pl = f"{tprefix}layers.{i}.", path + (f"layer{i}",)
        b.copy(tl + "self_attn.in_proj_weight", pl + ("self_attn", "in_proj_weight"))
        b.copy(tl + "self_attn.in_proj_bias", pl + ("self_attn", "in_proj_bias"))
        b.linear(tl + "self_attn.out_proj", pl + ("self_attn", "out_proj"))
        b.linear(tl + "linear1", pl + ("linear1",))
        b.linear(tl + "linear2", pl + ("linear2",))
        b.layernorm(tl + "norm1", pl + ("norm1",))
        b.layernorm(tl + "norm2", pl + ("norm2",))


def _decoder(b: _StateDictBuilder, tprefix: str, path: tuple):
    for i in range(b.n_layers(tprefix, path)):
        tl, pl = f"{tprefix}layers.{i}.", path + (f"layer{i}",)
        for attn in ("self_attn", "corr_attn"):
            b.copy(f"{tl}{attn}.in_proj_weight", pl + (attn, "in_proj_weight"))
            b.copy(f"{tl}{attn}.in_proj_bias", pl + (attn, "in_proj_bias"))
            b.linear(f"{tl}{attn}.out_proj", pl + (attn, "out_proj"))
        b.linear(tl + "linear1", pl + ("linear1",))
        b.linear(tl + "linear2", pl + ("linear2",))
        for norm in ("norm1", "norm2", "norm3"):
            b.layernorm(tl + norm, pl + (norm,))


def _residual_sn(b: _StateDictBuilder, tprefix: str, path: tuple):
    b.snconv(f"{tprefix}conv.0", path + ("conv_a",))
    b.snconv(f"{tprefix}conv.2", path + ("conv_b",))
    if b.has(f"{tprefix}conv.3.", path + ("norm",)):
        b.bn(f"{tprefix}conv.3", path + ("norm",))


def _upsample_sn(b: _StateDictBuilder, tprefix: str, path: tuple):
    b.snconv(f"{tprefix}conv1", path + ("conv1",))
    b.snconv(f"{tprefix}shortcut", path + ("shortcut",))
    i = 0
    while b.has(f"{tprefix}conv2.{2 * i}.weight_orig", path + (f"post_conv{i}",)):
        b.snconv(f"{tprefix}conv2.{2 * i}", path + (f"post_conv{i}",))
        i += 1
    if b.has(f"{tprefix}conv2.{2 * i}.", path + ("norm",)):
        b.bn(f"{tprefix}conv2.{2 * i}", path + ("norm",))


def _hourglass(b: _StateDictBuilder, tprefix: str, path: tuple):
    p = path + ("in_conv",)
    b.conv(f"{tprefix}inConv.inConv.0", p + ("in_conv",))
    b.conv(f"{tprefix}inConv.conv.0", p + ("conv0",))
    b.bn(f"{tprefix}inConv.conv.2", p + ("norm",))
    for name in ("down1", "down2"):
        p = path + (name,)
        b.conv(f"{tprefix}{name}.conv.0", p + ("down_conv",))
        b.conv(f"{tprefix}{name}.conv.2", p + ("conv0",))
        b.bn(f"{tprefix}{name}.conv.4", p + ("norm",))
    for i in range(3):
        t, p = f"{tprefix}residual.{i}.conv.", path + (f"residual{i}",)
        b.conv(f"{t}0", p + ("conv_a",))
        b.snconv(f"{t}1", p + ("conv_sn",))
        b.conv(f"{t}3", p + ("conv_b",))
    for name in ("up2", "up1"):
        p = path + (name,)
        b.conv(f"{tprefix}{name}.conv1", p + ("conv1",))
        b.conv(f"{tprefix}{name}.combine", p + ("combine",))
        b.conv(f"{tprefix}{name}.conv2.0", p + ("post_conv0",))
        b.conv(f"{tprefix}{name}.conv2.2", p + ("post_conv1",))
        b.bn(f"{tprefix}{name}.conv2.4", p + ("norm",))
    b.conv(f"{tprefix}outConv", path + ("out_conv",))


def _anchor_color_prob(b: _StateDictBuilder) -> None:
    """Every option's layout: the widths come from the tree, ``pos_enc`` and
    ``enhanceNet`` are read where the tree has them (``learning_pos``,
    ``enhanced``)."""
    _spixelnet(b, "segnet.net.", ("segnet", "net"))
    _colorprobnet(b, "repnet.", ("repnet",))
    _encoder(b, "wildpath.", ("wildpath",))
    _encoder(b, "hintpath.", ("hintpath",))
    for name in ("mid_word_prj", "trg_word_emb", "trg_word_prj"):
        b.linear(name, (name,))
    if b.has("pos_enc.", ("pos_enc",)):  # flax nn.Embed tables (rows, features), as torch's
        for table in ("row_embed", "col_embed"):
            b.copy(f"pos_enc.{table}.weight", ("pos_enc", table, "embedding"))
    if b.has("enhanceNet.", ("enhanceNet",)):
        _hourglass(b, "enhanceNet.", ("enhanceNet",))


def _spixel_seg(b: _StateDictBuilder) -> None:
    _spixelnet(b, "net.", ("net",))


def _build(b: _StateDictBuilder, walker=_anchor_color_prob) -> dict[str, torch.Tensor]:
    walker(b)
    return {k: torch.tensor(np.array(v)) for k, v in b.sd.items()}


def from_jax_variables(variables: dict, sn_folded: bool) -> dict[str, torch.Tensor]:
    """AnchorColorProb flax variables (as built by ``convert_disco_state_dict``
    or ``model.init``, or a train state's params, batch_stats and spectral)
    -> the port's AnchorColorProb ``state_dict``.

    ``sn_folded`` must match how the variables were made; the port model is
    then built with the same flag and options. The encoder depth and the
    widths are read from the tree.
    """
    return _build(_StateDictBuilder(variables, sn_folded))


class _TreeBuilder:
    """Reads torch keys and writes flax leaves by path: the converter's
    transforms, with the method names of :class:`_StateDictBuilder`, so that
    the same walkers drive both directions."""

    def __init__(self, state_dict: dict, sn_folded: bool):
        self.src = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                    for k, v in state_dict.items()}
        self.sn_folded = sn_folded
        self.params: dict = {}
        self.stats: dict = {}
        self.spectral: dict = {}

    def _put(self, tree: dict, path: tuple, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = np.ascontiguousarray(value, dtype=np.float32)

    def n_layers(self, tprefix: str, path: tuple) -> int:
        return len({k[len(tprefix) + len("layers."):].split(".")[0] for k in self.src if k.startswith(tprefix + "layers.")})

    def has(self, tprefix: str, path: tuple) -> bool:
        return any(k.startswith(tprefix) for k in self.src)

    def copy(self, tkey: str, path: tuple):
        self._put(self.params, path, self.src[tkey])

    def _bias(self, tkey: str, path: tuple):
        if f"{tkey}.bias" in self.src:
            self._put(self.params, path + ("bias",), self.src[f"{tkey}.bias"])

    def conv(self, tkey: str, path: tuple):
        self.raw_conv(tkey, path + ("conv",))

    def raw_conv(self, tkey: str, path: tuple):
        self._put(self.params, path + ("kernel",), np.transpose(self.src[f"{tkey}.weight"], (2, 3, 1, 0)))
        self._bias(tkey, path)

    def deconv(self, tkey: str, path: tuple):
        w = self.src[f"{tkey}.weight"][:, :, ::-1, ::-1]
        self._put(self.params, path + ("kernel",), np.transpose(w, (2, 3, 0, 1)))
        self._bias(tkey, path)

    def snconv(self, tkey: str, path: tuple):
        self._put(self.params, path + ("kernel",), np.transpose(self.src[f"{tkey}.weight_orig"], (2, 3, 1, 0)))
        self._bias(tkey, path)
        if not self.sn_folded:
            self._put(self.spectral, path + ("u",), self.src[f"{tkey}.weight_u"])

    def bn(self, tkey: str, path: tuple):
        self._put(self.params, path + ("bn", "scale"), self.src[f"{tkey}.weight"])
        self._put(self.params, path + ("bn", "bias"), self.src[f"{tkey}.bias"])
        self._put(self.stats, path + ("bn", "mean"), self.src[f"{tkey}.running_mean"])
        self._put(self.stats, path + ("bn", "var"), self.src[f"{tkey}.running_var"])

    def linear(self, tkey: str, path: tuple):
        self._put(self.params, path + ("kernel",), self.src[f"{tkey}.weight"].T)
        self._bias(tkey, path)

    def layernorm(self, tkey: str, path: tuple):
        self._put(self.params, path + ("scale",), self.src[f"{tkey}.weight"])
        self._put(self.params, path + ("bias",), self.src[f"{tkey}.bias"])

    def variables(self) -> dict:
        out = {"params": self.params, "batch_stats": self.stats}
        if not self.sn_folded:
            out["spectral"] = self.spectral
        return out


def to_jax_variables(state_dict: dict, sn_folded: bool) -> dict:
    """The port's AnchorColorProb ``state_dict`` -> the flax variables of the
    JAX model built with the same options (nested dicts of f32 numpy arrays:
    ``params``, ``batch_stats``, and ``spectral`` u when not ``sn_folded``),
    as ``convert_disco_state_dict`` lays them out. ``sn_folded``: the weights
    are a folded model's (``weight_orig`` already divided by sigma) and are
    written as they are. Pickled, it is the ``.pkl`` that
    ``cli/infer.py::load_variables`` of either package reads."""
    b = _TreeBuilder(state_dict, sn_folded)
    _anchor_color_prob(b)
    return b.variables()


def grads_from_jax(grads: dict) -> dict[str, torch.Tensor]:
    """A gradient tree shaped like AnchorColorProb's ``params`` -> port
    parameter name -> gradient of that parameter (deconv flip, transposes and
    spectral-norm ``weight_orig`` as for the weights; no buffers)."""
    return _build(_StateDictBuilder({"params": grads}, sn_folded=False, buffers=False))


def spixel_from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """SpixelSeg flax variables (params and batch_stats; as built by
    ``convert_spixelseg_state_dict`` or ``model.init``, or a stage-1 train
    state's) -> the port's SpixelSeg ``state_dict`` (``net.*`` keys)."""
    return _build(_StateDictBuilder(variables, sn_folded=False), _spixel_seg)


def decoder_from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """``TransformerDecoder`` flax variables (``{"params": {"layer0": ...}}``)
    -> the port's ``TransformerDecoder`` ``state_dict``; the depth and widths
    come from the tree."""
    return _build(_StateDictBuilder({"params": {"dec": variables["params"]}}, sn_folded=False),
                  lambda b: _decoder(b, "", ("dec",)))


def decoder_grads_from_jax(grads: dict) -> dict[str, torch.Tensor]:
    """A gradient tree shaped like a ``TransformerDecoder``'s ``params`` -> port
    parameter name -> gradient."""
    return decoder_from_jax_variables({"params": grads})


def sn_block_from_jax_variables(variables: dict, sn_folded: bool = False) -> dict[str, torch.Tensor]:
    """``ResidualBlockSN`` or ``UpsampleBlockSN`` flax variables (``params``,
    ``spectral`` u unless ``sn_folded``, ``batch_stats`` with ``use_norm``)
    -> the port block's ``state_dict``. An ``UpsampleBlockSN`` is told by its
    ``shortcut``; its ``conv_num`` and either block's ``use_norm`` come from
    the tree."""
    params = variables["params"]
    walker = _upsample_sn if "shortcut" in params else _residual_sn
    wrapped = {k: {"blk": v} for k, v in variables.items()}
    return _build(_StateDictBuilder(wrapped, sn_folded), lambda b: walker(b, "", ("blk",)))


class _NumpyUnpickler(pickle.Unpickler):
    """Reads nested dicts and lists of numpy arrays, and refuses every other
    class, so that no pickle runs code or needs JAX to load."""

    _ALLOWED = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and name in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the pickle needs {module}.{name} to load; only dicts of numpy arrays are read "
            "(convert the variables with numpy.asarray before pickling them)"
        )


def load_numpy_pickle(path: str):
    """A ``.pkl`` of nested dicts of numpy arrays (``tools/convert_torch.py``'s
    output in the JAX package); raises ``pickle.UnpicklingError`` on any other
    class, such as JAX arrays."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def spixel_grads_from_jax(grads: dict) -> dict[str, torch.Tensor]:
    """A gradient tree shaped like SpixelSeg's ``params`` -> port parameter
    name -> gradient (deconv flip and transposes as for the weights)."""
    return _build(_StateDictBuilder({"params": grads}, sn_folded=False, buffers=False), _spixel_seg)


def fold_spectral_norm(state_dict: dict) -> dict:
    """Divide every ``weight_orig`` by sigma = u . (W v) from its stored u, v:
    a reference (torch spectral_norm) checkpoint -> weights for a model built
    with ``sn_folded=True`` (the converter's folded form)."""
    out = dict(state_dict)
    for k in state_dict:
        if k.endswith(".weight_orig"):
            base = k[: -len("weight_orig")]
            w = state_dict[k].float()
            u, v = state_dict[base + "weight_u"].float(), state_dict[base + "weight_v"].float()
            sigma = (u * (w.reshape(w.shape[0], -1) * v).sum(-1)).sum()
            out[k] = w / sigma
    return out


def inception_from_jax_variables(variables: dict, include_fc: bool = False) -> dict[str, torch.Tensor]:
    """``InceptionV3Features`` flax variables (``params``, ``batch_stats``) ->
    the port's ``state_dict``: ``<module>/conv/kernel`` (HWIO) ->
    ``<module>.conv.weight`` (OIHW), ``bn/scale``/``bias`` -> ``bn.weight``/
    ``bias``, ``batch_stats`` mean/var -> ``running_mean``/``running_var``
    (``num_batches_tracked`` 0), and with ``include_fc`` the ``fc`` Dense
    kernel transposed to ``fc.weight``. A tree that also holds ``fc`` converts
    without it unless ``include_fc``."""
    sd: dict[str, torch.Tensor] = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))

    def walk(params: dict, stats: dict, prefix: str):
        for name, node in params.items():
            path = prefix + name
            if name == "conv":
                sd[path + ".weight"] = t(_conv_w(np.asarray(node["kernel"])))
            elif name == "bn":
                sd[path + ".weight"], sd[path + ".bias"] = t(node["scale"]), t(node["bias"])
                sd[path + ".running_mean"], sd[path + ".running_var"] = t(stats[name]["mean"]), t(stats[name]["var"])
                sd[path + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)
            elif name == "fc" and not prefix:
                if include_fc:
                    sd["fc.weight"], sd["fc.bias"] = t(np.asarray(node["kernel"]).T), t(node["bias"])
            else:
                walk(node, stats.get(name, {}), path + ".")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    if include_fc and "fc.weight" not in sd:
        raise KeyError("include_fc: the variables hold no fc head (convert with include_fc=True)")
    return sd


def inception_to_jax_variables(state_dict: dict, include_fc: bool = False) -> dict:
    """The inverse of :func:`inception_from_jax_variables`, in numpy: a
    torchvision-keyed InceptionV3 ``state_dict`` -> flax variables, as the
    JAX package's ``convert_inception_torchvision`` builds them (``AuxLogits``
    and ``num_batches_tracked`` dropped, ``fc`` only with ``include_fc``).
    Pickled, it is an ``--inception_pkl`` both packages read."""
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, dotted: str, leaf):
        *parents, last = dotted.split(".")
        for p in parents:
            tree = tree.setdefault(p, {})
        tree[last] = np.asarray(leaf, dtype=np.float32)

    for k, v in state_dict.items():
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if k.startswith("AuxLogits.") or k.endswith("num_batches_tracked"):
            continue
        if k.startswith("fc."):
            if include_fc:
                put(params, "fc.kernel" if k == "fc.weight" else "fc.bias", v.T if k == "fc.weight" else v)
        elif k.endswith(".conv.weight"):
            put(params, k[: -len(".weight")] + ".kernel", np.transpose(v, (2, 3, 1, 0)))
        elif k.endswith(".bn.weight"):
            put(params, k[: -len(".weight")] + ".scale", v)
        elif k.endswith(".bn.bias"):
            put(params, k, v)
        elif k.endswith(".bn.running_mean"):
            put(stats, k[: -len(".running_mean")] + ".mean", v)
        elif k.endswith(".bn.running_var"):
            put(stats, k[: -len(".running_var")] + ".var", v)
    return {"params": params, "batch_stats": stats}


class _ConvPaths:
    """Records (torch module name, flax module path) of every ``Conv``
    wrapper and ``SNConv`` the walkers visit, the modules that own a
    ``quant/.../act_amax`` leaf in JAX; every other walker call is a no-op."""

    def __init__(self):
        self.pairs: list[tuple[str, tuple]] = []

    def n_layers(self, tprefix: str, path: tuple) -> int:
        return 0

    def has(self, tprefix: str, path: tuple) -> bool:
        return True

    def conv(self, tkey: str, path: tuple):
        self.pairs.append((tkey, path))

    snconv = conv

    def __getattr__(self, name):
        return lambda *args: None


def _quant_pairs() -> list[tuple[str, tuple]]:
    b = _ConvPaths()
    _anchor_color_prob(b)
    return b.pairs


def quant_from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """JAX's calibrated ranges (the ``quant`` collection, or variables holding
    it) -> ``{"<port module name>.act_amax": 0-d f32 tensor}`` for every
    convolution that has one, as ``ops/quant.py::load_amax`` takes them."""
    tree = variables.get("quant", variables)
    out = {}
    for tkey, path in _quant_pairs():
        if _StateDictBuilder._has(tree, path + ("act_amax",)):
            out[f"{tkey}.act_amax"] = torch.tensor(_StateDictBuilder._get(tree, path + ("act_amax",)))
    return out


def quant_to_jax_variables(amax: dict) -> dict:
    """``{"<port module name>.act_amax": value}`` (``ops/quant.py::gated_amax``)
    -> JAX's ``quant`` collection as nested dicts of f32 numpy scalars."""
    tree: dict = {}
    for tkey, path in _quant_pairs():
        if f"{tkey}.act_amax" in amax:
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            v = amax[f"{tkey}.act_amax"]
            node["act_amax"] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float32)
    return tree
