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
``models.TransformerLM`` and the ``ops.flash_decode`` kernel.
"""

import importlib

_SUBPACKAGES = ("models", "observability", "ops", "resilience", "serving")

__all__ = list(_SUBPACKAGES)


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
