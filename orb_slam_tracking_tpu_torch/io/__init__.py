"""Host-side image and dataset IO (counterpart of the JAX package's ``io``):
grayscale frames as float32 numpy arrays, the TUM RGB-D layout, the native
prefetching frame loader."""

from .images import load_gray, to_gray  # noqa: F401
