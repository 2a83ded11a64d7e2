"""PyTorch/CUDA port of the ProTrain reproduction (``src/repro`` is the JAX
reference). Imports ``torch``, never ``jax``, and nothing of ``repro``."""
