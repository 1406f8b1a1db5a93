"""The port's serving path on the CPU: Synthesizer vs the JAX Synthesizer,
DynamicBatcher under concurrent submits, and the HTTP front end.

Synthesizer tolerance (fp32, stop threshold 2.0 so every row runs the
whole ``max_len``): max|port - jax| <= 1e-4 * max(1, max|jax|) on the
denormalized mels — the decode tolerance of ``test_torch_decode.py``.
"""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close, configs, jax_model_and_variables
from transformertts_tpu.infer import Synthesizer as JaxSynthesizer
from transformertts_tpu_torch.infer import DynamicBatcher, Synthesizer, make_http_server

TEXTS = ["Hello world.", "A second, longer sentence, with a comma.", "It is 1984."]
STATS = {"mean": -4.0, "std": 2.5}
MAX_LEN = 12


def _synths(threshold=2.0):
    jcfg, pcfg = configs(stop_threshold=threshold)
    _, variables = jax_model_and_variables(jcfg)
    return (JaxSynthesizer(jcfg, variables=variables, stats=STATS),
            Synthesizer(pcfg, variables=variables, stats=STATS, device="cpu"))


@pytest.fixture(scope="module")
def synth():
    return _synths()[1]


def test_synthesizer_matches_jax():
    jsynth, psynth = _synths()
    ref = jsynth.synthesize(TEXTS, max_len=MAX_LEN)
    out = psynth.synthesize(TEXTS, max_len=MAX_LEN)
    assert psynth.steps_decoded == MAX_LEN
    assert len(out) == len(ref) == len(TEXTS)
    for o, r in zip(out, ref):
        assert o.shape == r.shape == (80, MAX_LEN) and o.dtype == np.float32
        assert_close(o, r, 1e-4, "mel")
    np.testing.assert_array_equal(psynth.text_to_ids(TEXTS[1]), jsynth.text_to_ids(TEXTS[1]))


def test_synthesizer_weight_sources(synth):
    """A port state dict serves the same mels as the flax variables it came
    from; a checkpoint directory that does not exist is refused
    (``test_torch_checkpoint.py`` reads real ones and refuses orbax ones)."""
    jcfg, pcfg = configs(stop_threshold=2.0)
    again = Synthesizer(pcfg, state_dict=synth.model.state_dict(), stats=STATS, device="cpu")
    np.testing.assert_array_equal(again.synthesize(TEXTS[0], max_len=8)[0],
                                  synth.synthesize(TEXTS[0], max_len=8)[0])
    with pytest.raises(FileNotFoundError):
        Synthesizer(pcfg, checkpoint_dir="ckpt", device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        Synthesizer(pcfg, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        Synthesizer(pcfg, checkpoint_dir="ckpt", state_dict=synth.model.state_dict(),
                    device="cpu")
    assert synth.warmup(batch_sizes=(1, 2), buckets=(16,), max_len=4) == 2


def test_batcher_concurrent_submits(synth):
    with DynamicBatcher(synth, max_batch=4, max_wait_ms=200.0, max_len=8) as batcher:
        with ThreadPoolExecutor(6) as pool:
            mels = list(pool.map(lambda i: batcher.synthesize(TEXTS[i % 3], timeout=120),
                                 range(6)))
        stats = batcher.stats()
    assert all(m.shape == (80, 8) and np.isfinite(m).all() for m in mels)
    assert stats["n_requests"] == 6 and max(stats["batch_hist"]) > 1
    assert max(stats["batch_hist"]) <= 4
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit("late")


def _request(url, body=None):
    data = json.dumps(body).encode() if isinstance(body, dict) else body
    req = urllib.request.Request(url, data)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_http_server(synth):
    batcher = DynamicBatcher(synth, max_batch=4, max_wait_ms=5.0, max_len=8)
    server = make_http_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body, headers = _request(url + "/synthesize", {"text": TEXTS[0]})
        assert code == 200
        mel = np.load(io.BytesIO(body))
        assert mel.shape == (80, 8) and int(headers["X-Mel-Frames"]) == 8
        np.testing.assert_allclose(mel, synth.synthesize(TEXTS[0], max_len=8)[0], atol=1e-5)

        code, body, _ = _request(url + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["ok"] and health["n_requests"] == 1

        for bad in (b"not json", {"text": 3}, {"text": "hi", "format": "flac"}):
            code, body, _ = _request(url + "/synthesize", bad)
            assert code == 400, body
        code, body, headers = _request(url + "/synthesize", {"text": TEXTS[0], "format": "wav"})
        assert code == 200 and headers["Content-Type"] == "audio/wav"
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        with wave.open(io.BytesIO(body)) as w:  # (T - 1) * hop samples for T = 8 frames
            assert (w.getframerate(), w.getnframes()) == (22050, 7 * 256)
        assert _request(url + "/nowhere")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_synthesizer_runs_in_bf16():
    jcfg, pcfg = configs(stop_threshold=2.0)
    pcfg = pcfg.replace(runtime=dataclasses.replace(pcfg.runtime, compute_dtype="bfloat16"))
    synth = Synthesizer(pcfg, variables=jax_model_and_variables(jcfg)[1], device="cpu")
    assert synth.model.dtype == torch.bfloat16
    mels = synth.synthesize(TEXTS[:2], max_len=8)
    assert all(m.shape == (80, 8) and np.isfinite(m).all() for m in mels)
