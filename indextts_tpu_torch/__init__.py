"""PyTorch/CUDA port of IndexTTS for one NVIDIA H100.

The JAX package `indextts_tpu` is the reference this package is held
against; this package never imports it, nor JAX.  Entry points run on
`cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
