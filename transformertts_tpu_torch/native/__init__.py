"""The threaded C++ npz batch reader (the JAX package's ``native``)."""

from transformertts_tpu_torch.native.bindings import (  # noqa: F401
    NativeBatchLoader,
    NativeReadError,
    native_available,
)
