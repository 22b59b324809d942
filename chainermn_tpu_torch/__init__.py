"""chainermn_tpu_torch: the PyTorch/CUDA port of ``chainermn_tpu``.

The package mirrors ``chainermn_tpu``'s module paths, so each module's
counterpart sits at the same relative path.  It runs on an NVIDIA card
(Hopper, ``sm_90a``): plain tensor code is PyTorch, and every kernel
that the JAX package wrote in Pallas is a hand-written CUDA kernel under
``ops/csrc/``, built with ``nvcc`` at first use.

The port never imports JAX, flax, optax or ``chainermn_tpu``.  Entry
points default to ``device="cuda"`` and raise when CUDA is absent; they
run on the CPU only when the caller passes ``device="cpu"``.

Importing the package loads no subpackage and builds no kernel: the
subpackages below load on first attribute access.

Ported so far: the serving path (``serving.PagedKVCache``,
``serving.DecodeEngine``, ``serving.ContinuousBatcher``) over the
``models.TransformerLM`` and the ``ops.flash_decode`` kernel; and the
data-parallel training path (``create_communicator`` ->
``scatter_dataset`` -> ``create_multi_node_optimizer`` ->
``build_train_step``, one process per card) with the flash-attention
forward and backward kernels (``ops.flash_attention``); and the
data-parallel image path of ChainerMN's examples (``models.MLP``,
``models.ResNet50``, ``iterators``, ``training.Trainer``,
``create_multi_node_evaluator``, ``examples.train_mnist`` and
``examples.train_imagenet``) with the reduced-precision gradient wire
on the ``ops.fused_cast_scale`` kernel; and synchronized BatchNorm
(``links.create_mnbn_model``) with the ``hierarchical`` communicator,
the ``int8`` gradient wire and error feedback; and the multi-node
checkpointer (``create_multi_node_checkpointer``), the input pipeline
(``iterators.prefetch_to_device`` on a side CUDA stream, the
synchronized and multi-node iterators) and the ImageNet example's other
architectures (``models.VGG16``, ``AlexNet``, ``NIN``, ``GoogLeNet``,
``GoogLeNetBN``); and model parallelism (``MultiNodeChainList``,
``functions.send``/``recv``/``pseudo_connect`` and the differentiable
collectives, ``links.create_multi_node_n_step_rnn``,
``models.Seq2Seq``, ``parallel.build_pipeline_train_step``); and the
optimizer's tier 2 (``create_multi_node_optimizer(double_buffering=,
zero_redundancy=, overlap="bucket")``, ``build_train_step(accum_steps=,
remat=)``).
"""

import importlib

_SUBPACKAGES = ("comm_wire", "communicators", "datasets", "examples",
                "extensions", "functions", "global_except_hook", "iterators",
                "link", "links", "models", "observability", "ops",
                "parallel", "resilience", "serving", "training", "utils")

# top-level entry points, as chainermn_tpu exports them: name -> module
_ENTRY_POINTS = {
    "create_communicator": "communicators",
    "create_multi_node_optimizer": "optimizers",
    "build_train_step": "optimizers",
    "scatter_dataset": "datasets",
    "create_multi_node_evaluator": "extensions",
    "create_multi_node_checkpointer": "extensions",
    "create_multi_node_iterator": "iterators",
    "create_synchronized_iterator": "iterators",
    "create_empty_dataset": "datasets",
    "MultiNodeChainList": "link",
}

__all__ = list(_SUBPACKAGES) + list(_ENTRY_POINTS)


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _ENTRY_POINTS:
        module = importlib.import_module(f"{__name__}.{_ENTRY_POINTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
