"""Weight carrier: a flax parameter tree as the port's ``state_dict``,
and the flax leaf order.

The one place where the JAX package's layout meets the port's: flax
``Dense`` kernels are ``(in, out)`` and become ``nn.Linear`` weights
``(out, in)`` here; ``Conv`` kernels are HWIO and become OIHW;
LayerNorm and BatchNorm ``scale`` becomes ``weight``, and BatchNorm's
``batch_stats`` (``mean``, ``var``) become the ``running_mean`` and
``running_var`` buffers.  The same tables give the order in which flax
flattens the tree (sorted keys at every level, so ``Bottleneck_10``
comes before ``Bottleneck_2``), which the gradient wire plans its
buckets in (``comm_wire.planner``): ``named_parameters()`` orders them
otherwise.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

# layouts: the flax array as is, a Dense kernel (in, out) <-> (out, in),
# a Conv kernel HWIO <-> OIHW
AS_IS, DENSE, CONV = "as_is", "dense", "conv"


class Leaf(NamedTuple):
    """One array as both frameworks name it."""

    path: Tuple[str, ...]  # flax path (the LM's under 'params'; the
    # image models' from the collection down)
    key: str  # the port's state_dict key
    layout: str  # AS_IS, DENSE or CONV


def lm_leaves(n_layers: int) -> List[Leaf]:
    """Every parameter of an ``n_layers`` TransformerLM, in flax's
    flatten order (jax sorts dict keys, so ``TransformerBlock_10`` comes
    before ``TransformerBlock_2``)."""
    leaves = [Leaf(("embed", "embedding"), "embed.weight", AS_IS),
              Leaf(("pos_embed",), "pos_embed", AS_IS),
              Leaf(("LayerNorm_0", "scale"), "ln_f.weight", AS_IS),
              Leaf(("LayerNorm_0", "bias"), "ln_f.bias", AS_IS)]
    for i in range(n_layers):
        blk, pre = f"TransformerBlock_{i}", f"blocks.{i}"
        for ln, mod in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            leaves += [Leaf((blk, ln, "scale"), f"{pre}.{mod}.weight", AS_IS),
                       Leaf((blk, ln, "bias"), f"{pre}.{mod}.bias", AS_IS)]
        for sub, dense, mod, bias in (
                ("SelfAttention_0", "Dense_0", "attn.qkv", False),
                ("SelfAttention_0", "Dense_1", "attn.proj", False),
                ("MlpBlock_0", "Dense_0", "mlp.fc1", True),
                ("MlpBlock_0", "Dense_1", "mlp.fc2", True)):
            leaves.append(Leaf((blk, sub, dense, "kernel"),
                               f"{pre}.{mod}.weight", DENSE))
            if bias:
                leaves.append(Leaf((blk, sub, dense, "bias"),
                                   f"{pre}.{mod}.bias", AS_IS))
    return sorted(leaves, key=lambda leaf: leaf.path)


def mlp_leaves() -> List[Leaf]:
    """The MLP's parameters in flax's order (``Dense_0..2`` -> ``l1..3``)."""
    leaves = []
    for i in range(3):
        leaves += [Leaf(("params", f"Dense_{i}", "kernel"), f"l{i + 1}.weight",
                        DENSE),
                   Leaf(("params", f"Dense_{i}", "bias"), f"l{i + 1}.bias",
                        AS_IS)]
    return sorted(leaves, key=lambda leaf: leaf.path)


# a ResNet block's flax submodules, numbered by creation order within
# their kind -> the port's attribute names
_BLOCK_CONVS = {"Bottleneck": ("conv1", "conv2", "conv3", "proj"),
                "BasicBlock": ("conv1", "conv2", "proj")}
_BLOCK_NORMS = {"Bottleneck": ("bn1", "bn2", "bn3", "proj_bn"),
                "BasicBlock": ("bn1", "bn2", "proj_bn")}
#: flax's names of a ResNet's normalization modules: the plain BatchNorm
#: and the synchronized one of ``create_mnbn_model`` (its class name)
NORM_NAMES = ("BatchNorm", "MultiNodeBatchNormalization")
_BN_LEAVES = (("params", "scale", "weight"), ("params", "bias", "bias"),
              ("batch_stats", "mean", "running_mean"),
              ("batch_stats", "var", "running_var"))


def _resnet_leaf(path: Tuple[str, ...]) -> Leaf:
    """The port's key and layout of one flax ResNet path (the
    collection, then the module names, then the array name)."""
    mods, name = path[1:-1], path[-1]
    if mods == ("conv_init",):
        return Leaf(path, "conv_init.weight", CONV)
    if mods == ("Dense_0",):
        return Leaf(path, f"head.{'weight' if name == 'kernel' else 'bias'}",
                    DENSE if name == "kernel" else AS_IS)
    bn = {f: p for _, f, p in _BN_LEAVES}
    if len(mods) == 1 and mods[0].rsplit("_", 1)[0] in NORM_NAMES:
        return Leaf(path, f"bn_init.{bn[name]}", AS_IS)
    cls, k = mods[0].rsplit("_", 1)
    kind, j = mods[1].rsplit("_", 1)
    if kind == "Conv":
        return Leaf(path, f"blocks.{k}.{_BLOCK_CONVS[cls][int(j)]}.weight",
                    CONV)
    if kind not in NORM_NAMES:
        raise KeyError(f"no port key for the flax path {path}")
    return Leaf(path, f"blocks.{k}.{_BLOCK_NORMS[cls][int(j)]}.{bn[name]}",
                AS_IS)


def _norm_name(model: nn.Module) -> str:
    """The flax name of the model's normalization modules."""
    name = type(model.bn_init).__name__
    if name not in NORM_NAMES:
        raise TypeError(f"no flax leaf table for a ResNet normalized by "
                        f"{name}; one of {NORM_NAMES}")
    return name


def resnet_leaves(model: nn.Module) -> List[Leaf]:
    """Every parameter and running statistic of a port ``ResNet``, in
    the flax order of ``{"params", "batch_stats"}`` (``batch_stats``
    sorts first).  The order follows the normalization's flax name:
    ``BatchNorm_k`` sorts before a block's ``Conv_k``,
    ``MultiNodeBatchNormalization_k`` after it."""
    norm = _norm_name(model)
    paths = [("params", "conv_init", "kernel"),
             ("params", "Dense_0", "kernel"), ("params", "Dense_0", "bias")]
    paths += [(coll, f"{norm}_0", f) for coll, f, _ in _BN_LEAVES]
    cls = model.block_cls.__name__
    for k, blk in enumerate(model.blocks):
        mod = f"{cls}_{k}"
        for j, sub in enumerate(_BLOCK_CONVS[cls]):
            if getattr(blk, sub) is not None:
                paths.append(("params", mod, f"Conv_{j}", "kernel"))
        for j, sub in enumerate(_BLOCK_NORMS[cls]):
            if getattr(blk, sub) is not None:
                paths += [(coll, mod, f"{norm}_{j}", f)
                          for coll, f, _ in _BN_LEAVES]
    return sorted((_resnet_leaf(p) for p in paths),
                  key=lambda leaf: leaf.path)


# the flax module kinds of the other image models -> the port's
# attribute holding them (``Kind_k`` is entry k; the dense head of
# GoogLeNet, ``Dense_0``, is the one unindexed ``head``)
_CNN_KINDS = {
    "VGG16": {"Conv": "convs", "Dense": "fcs"},
    "AlexNet": {"Conv": "convs", "Dense": "fcs"},
    "NIN": {"_MLPConv": "mlpconvs", "Conv": "convs"},
    "GoogLeNet": {"Conv": "convs", "Inception": "inceptions", "Dense": "head",
                  **{n: "norms" for n in NORM_NAMES}},
}
_CNN_ARRAYS = {"kernel": "weight", "bias": "bias", "scale": "weight",
               "mean": "running_mean", "var": "running_var"}


def _cnn_leaf(path: Tuple[str, ...], kinds: Dict[str, str]) -> Leaf:
    """The port's key and layout of one flax path of a VGG16, AlexNet,
    NIN or GoogLeNet tree."""
    mods, name = path[1:-1], path[-1]
    parts = []
    for mod in mods:
        kind, k = mod.rsplit("_", 1)
        if kind not in kinds:
            raise KeyError(f"no port key for the flax path {path}")
        parts += [kinds[kind]] if kinds[kind] == "head" else [kinds[kind], k]
    last = mods[-1].rsplit("_", 1)[0]
    layout = AS_IS
    if name == "kernel":
        layout = CONV if last == "Conv" else DENSE
    return Leaf(path, ".".join(parts + [_CNN_ARRAYS[name]]), layout)


def cnn_leaves(model: nn.Module) -> List[Leaf]:
    """Every parameter (and running statistic) of a port ``VGG16``,
    ``AlexNet``, ``NIN`` or ``GoogLeNet`` in flax's order: the flax path
    of each ``state_dict`` key, sorted (so ``Conv_10`` comes before
    ``Conv_2`` and ``Inception_8`` after ``Inception_10`` would)."""
    kinds = _CNN_KINDS[type(model).__name__]
    attrs = {a: k for k, a in kinds.items() if a != "norms"}
    norms = [m for m in model.modules() if type(m).__name__ in NORM_NAMES]
    if norms:
        attrs["norms"] = type(norms[0]).__name__
    arrays = {v: k for k, v in _CNN_ARRAYS.items() if k != "scale"}
    leaves = []
    for key in model.state_dict():
        parts = key.split(".")
        mods, i = [], 0
        while i < len(parts) - 1:
            if parts[i] == "head":
                mods.append("Dense_0")
                i += 1
            else:
                mods.append(f"{attrs[parts[i]]}_{parts[i + 1]}")
                i += 2
        name = arrays[parts[-1]]
        if name == "kernel" and mods[-1].rsplit("_", 1)[0] in NORM_NAMES:
            name = "scale"
        coll = "batch_stats" if name in ("mean", "var") else "params"
        leaf = _cnn_leaf((coll, *mods, name), kinds)
        assert leaf.key == key, (leaf, key)
        leaves.append(leaf)
    return sorted(leaves, key=lambda leaf: leaf.path)


def model_leaves(model: nn.Module) -> List[Leaf]:
    """The flax-ordered leaves of a port ``TransformerLM``, ``MLP``,
    ``ResNet``, ``VGG16``, ``AlexNet``, ``NIN`` or ``GoogLeNet``."""
    from .mlp import MLP
    from .resnet import ResNet
    from .transformer import TransformerLM

    if isinstance(model, TransformerLM):
        return lm_leaves(model.n_layers)
    if isinstance(model, MLP):
        return mlp_leaves()
    if isinstance(model, ResNet):
        return resnet_leaves(model)
    if type(model).__name__ in _CNN_KINDS:
        return cnn_leaves(model)
    raise TypeError(f"no flax leaf table for {type(model).__name__}")


def flax_ordered_parameters(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """``(state_dict key, tensor)`` of every leaf of the model's flax
    tree, in flax's flatten order: the list to build the multi-node
    optimizer over, so that the wire's buckets have the JAX plan's
    layout.  A ResNet's running statistics are among them (first, as
    ``batch_stats`` sorts before ``params``): the JAX step plans
    ``{"params", "batch_stats"}``, so its buckets carry them as
    zero-gradient leaves."""
    tensors = model.state_dict(keep_vars=True)
    return [(leaf.key, tensors[leaf.key]) for leaf in model_leaves(model)]


def flax_shape(leaf: Leaf, shape) -> Tuple[int, ...]:
    """The flax shape of a leaf whose port tensor has ``shape``."""
    shape = tuple(int(s) for s in shape)
    if leaf.layout == DENSE:
        return shape[::-1]
    if leaf.layout == CONV:
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    return shape


def flax_leaf_specs(model: nn.Module) -> List[Tuple[Tuple[int, ...], str]]:
    """``(flax shape, numpy dtype name)`` of every leaf in flax order:
    ``comm_wire.make_plan`` of this list is the JAX plan of the flax
    tree, ``plan_hash`` included (the optimizer's own plan covers the
    port's shapes, so its hash differs where a layout does)."""
    tensors = model.state_dict(keep_vars=True)
    return [(flax_shape(leaf, tensors[leaf.key].shape),
             str(tensors[leaf.key].dtype).split(".")[-1])
            for leaf in model_leaves(model)]


def _t(a, layout: str) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)
    if layout == DENSE:
        a = a.T
    elif layout == CONV:
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def lm_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """Map ``{'params': {...}}`` of the JAX ``TransformerLM`` (arrays as
    numpy) onto :class:`~chainermn_tpu_torch.models.transformer.
    TransformerLM`'s ``state_dict`` keys."""
    p = params["params"] if "params" in params else params
    n_layers = 0
    while f"TransformerBlock_{n_layers}" in p:
        n_layers += 1
    return {leaf.key: _t(_at(p, leaf.path), leaf.layout)
            for leaf in lm_leaves(n_layers)}


def mlp_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Map ``{'params': {...}}`` of the JAX ``MLP`` onto
    :class:`~chainermn_tpu_torch.models.mlp.MLP`'s ``state_dict``."""
    return {leaf.key: _t(_at(variables, leaf.path), leaf.layout)
            for leaf in mlp_leaves()}


def resnet_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Map ``{'params': ..., 'batch_stats': ...}`` of a JAX ``ResNet``
    (arrays as numpy) onto the port's ``ResNet`` ``state_dict``: every
    parameter and running statistic, the zero-initialised scales of the
    blocks' last BatchNorms included.  A tree of the synchronized model
    (``create_mnbn_model``, modules named
    ``MultiNodeBatchNormalization_k``) maps onto the same keys."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        leaf = _resnet_leaf(path)
        out[leaf.key] = _t(tree, leaf.layout)

    for coll in ("params", "batch_stats"):
        walk(variables[coll], (coll,))
    return out


def _cnn_params_from_flax(variables, arch: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    kinds = _CNN_KINDS[arch]

    def walk(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        leaf = _cnn_leaf(path, kinds)
        out[leaf.key] = _t(tree, leaf.layout)

    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(variables[coll], (coll,))
    return out


def vgg16_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Map ``{'params': ...}`` of the JAX ``VGG16`` (arrays as numpy)
    onto the port's ``VGG16`` ``state_dict``."""
    return _cnn_params_from_flax(variables, "VGG16")


def alexnet_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Map ``{'params': ...}`` of the JAX ``AlexNet`` onto the port's."""
    return _cnn_params_from_flax(variables, "AlexNet")


def nin_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Map ``{'params': ...}`` of the JAX ``NIN`` onto the port's."""
    return _cnn_params_from_flax(variables, "NIN")


def googlenet_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """Map ``{'params': ...}`` of the JAX ``GoogLeNet`` (and
    ``batch_stats`` of ``GoogLeNetBN``, plain or synchronized) onto the
    port's ``GoogLeNet`` ``state_dict``."""
    return _cnn_params_from_flax(variables, "GoogLeNet")


# the last name of a flax leaf of the seq2seq family -> the port's name
# and layout (``wh_{l}`` is kept in ``nn.LSTM``'s ``(4H, H)`` layout)
_SEQ2SEQ_NAMES = {"embedding": ("weight", AS_IS), "kernel": ("weight", DENSE),
                  "bias": ("bias", AS_IS)}


def _flat_items(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_items(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def seq2seq_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """Map a flax tree of the seq2seq family (``{'params': ...}`` or the
    collection itself, arrays as numpy) onto the port's ``state_dict``
    keys: an ``LSTMStack`` (``wx_{l}`` kernel and bias, ``wh_{l}``), an
    ``Encoder`` (``embed_x``, ``lstm``), a ``Decoder`` (``embed_y``,
    ``lstm``, ``W``), a ``Seq2Seq`` (``encoder``, ``decoder``), the
    ``seq2seq_mp1`` stages (one ``encoder`` or ``decoder`` each), a
    ``MultiNodeNStepRNN`` (its ``LSTMStack_0`` folded away), and the
    pipeline's stacked stage parameters (a leading stage axis; a Dense
    kernel swaps its last two axes)."""
    p = params["params"] if "params" in params else params
    out = {}
    for path, a in _flat_items(p):
        mods, name = [m for m in path[:-1] if m != "LSTMStack_0"], path[-1]
        key, layout = (_SEQ2SEQ_NAMES[name] if name in _SEQ2SEQ_NAMES
                       else (name, DENSE))  # wh_{l}: (H, 4H) -> (4H, H)
        a = np.array(a, dtype=np.float32)
        if layout == DENSE:
            a = np.swapaxes(a, -1, -2)
        out[".".join(mods + [key])] = torch.from_numpy(np.ascontiguousarray(a))
    return out
