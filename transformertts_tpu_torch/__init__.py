"""PyTorch/CUDA port of ``transformertts_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of JAX or of ``transformertts_tpu``.  Module names follow
the JAX package so each module's counterpart is easy to find.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
