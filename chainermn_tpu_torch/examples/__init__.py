"""The port's twins of the JAX package's examples:
``python -m chainermn_tpu_torch.examples.train_mnist`` and
``python -m chainermn_tpu_torch.examples.train_imagenet``."""
