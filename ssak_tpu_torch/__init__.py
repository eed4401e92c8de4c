"""ssak_tpu_torch: the PyTorch/CUDA port of ssak_tpu.

A second package beside the JAX one. It mirrors ssak_tpu's module tree and
names; plain tensor code is PyTorch, and every Pallas kernel on a ported
path is a CUDA kernel written for Hopper (sm_90a) under `csrc/`, built at
first use (ops/_build.py). Entry points run on `cuda` unless the caller
passes device="cpu". Nothing here imports JAX or ssak_tpu.
"""

__version__ = "0.1.0"
