from transformertts_tpu_torch.infer.decode import make_decode_fn, naive_decode  # noqa: F401
from transformertts_tpu_torch.infer.api import Synthesizer  # noqa: F401
from transformertts_tpu_torch.infer.streaming import make_stream_fns, stream_decode  # noqa: F401
from transformertts_tpu_torch.infer.serving import DynamicBatcher, make_http_server  # noqa: F401
