"""PyTorch/CUDA port of ``transformertts_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports ``torch`` and
numpy and nothing of JAX or of ``transformertts_tpu``.  Module names follow
the JAX package so each module's counterpart is easy to find.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from transformertts_tpu_torch.config import Config, load_config  # noqa: F401,E402
from transformertts_tpu_torch.infer.decode import make_decode_fn, naive_decode  # noqa: F401,E402
from transformertts_tpu_torch.infer.api import Synthesizer  # noqa: F401,E402
from transformertts_tpu_torch.infer.streaming import make_stream_fns, stream_decode  # noqa: F401,E402
from transformertts_tpu_torch.infer.serving import DynamicBatcher, make_http_server  # noqa: F401,E402
