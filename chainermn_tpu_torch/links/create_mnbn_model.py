"""Replace BatchNorm with MultiNodeBatchNormalization.

Port of ``chainermn_tpu/links/create_mnbn_model.py`` (ChainerMN's
``create_mnbn_model(link, comm)``).  Two ways in:

* before a model is built, pass ``norm=mnbn_factory(comm)`` to a model
  with a ``norm`` factory hook (the port's ``ResNet``), as the JAX
  package's ``create_mnbn_model`` rebinds the flax model's ``norm``
  field;
* for a built model, ``create_mnbn_model(model, comm)`` returns a copy
  in which every ``models.resnet.BatchNorm`` is a
  :class:`MultiNodeBatchNormalization` carrying that BatchNorm's
  parameters, running statistics and dtype.

What is refused: a ``torch.nn`` BatchNorm (``BatchNorm1d/2d/3d``,
``SyncBatchNorm``) has PyTorch's numerics (unbiased running variance,
its own momentum convention), so no conversion keeps the model's
meaning; the model is refused with ``TypeError`` rather than left with
unsynchronized BatchNorm, as the JAX package refuses a BatchNorm it
cannot reach.  A model with no BatchNorm at all is returned as it is,
with a warning.
"""

from __future__ import annotations

import copy
import warnings

import torch
from torch import nn

from ..models.resnet import BatchNorm
from .multi_node_batch_normalization import MultiNodeBatchNormalization


def mnbn_factory(comm, **bn_kwargs):
    """A ``norm`` factory for models: ``norm(size, **kw) ->
    MultiNodeBatchNormalization`` over ``comm``.  The call site's kwargs
    (the model's dtype, ``zero_scale``) are defaults; what the user
    pinned in ``bn_kwargs`` wins."""

    def make(size: int, **kw):
        merged = dict(kw)
        merged.update(bn_kwargs)
        return MultiNodeBatchNormalization(size, comm, **merged)

    return make


def _convert(bn: BatchNorm, make) -> MultiNodeBatchNormalization:
    new = make(bn.weight.numel(), dtype=bn.dtype)
    with torch.no_grad():
        for name, t in list(bn.named_parameters()) + list(bn.named_buffers()):
            getattr(new, name).copy_(t)
    return new.to(bn.weight.device).train(bn.training)


def create_mnbn_model(model: nn.Module, comm, **bn_kwargs) -> nn.Module:
    """A copy of ``model`` with synchronized BatchNorm over ``comm``
    (``model`` itself is left as it was); see the module docstring for
    what is converted and what is refused."""
    make = mnbn_factory(comm, **bn_kwargs)
    if isinstance(model, BatchNorm):
        return _convert(model, make)
    foreign = [name for name, m in model.named_modules()
               if isinstance(m, nn.modules.batchnorm._NormBase)]
    if foreign:
        raise TypeError(
            f"create_mnbn_model: {type(model).__name__} holds torch.nn "
            f"BatchNorm modules ({', '.join(foreign[:3])}) that cannot be "
            "converted to synchronized BN: their numerics are not the "
            "port's.  Build the model with the port's BatchNorm, or pass "
            "norm=mnbn_factory(comm) to its constructor.")
    if not any(isinstance(m, BatchNorm) for m in model.modules()):
        warnings.warn(
            f"create_mnbn_model: {type(model).__name__} has no BatchNorm; "
            "returning it unchanged.  A model that normalizes its batch "
            "by other means remains UNsynchronized.", stacklevel=2)
        return model
    model = copy.deepcopy(model)
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, BatchNorm):
                setattr(parent, name, _convert(child, make))
    return model
