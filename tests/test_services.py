"""Service-client tests: in-process captioner batching, HTTP clients
against mock transports, profiling helpers."""
import asyncio
import json

import numpy as np
import pytest

from vidgraph_tpu.core.metrics import MetricsTracker
from vidgraph_tpu.core.profiling import span
from vidgraph_tpu.services.embed_client import HttpEmbedClient
from vidgraph_tpu.services.llm_client import HttpChatClient
from vidgraph_tpu.services.rerank_client import HttpRerankClient
from vidgraph_tpu.services.vlm_client import LocalVLMClient, TPUVLMClient


def test_tpu_captioner_batch_matches_single():
    from vidgraph_tpu.models.captioner import CaptionerConfig
    from vidgraph_tpu.models.vit import ViTConfig

    client = TPUVLMClient(vit_cfg=ViTConfig.tiny(),
                          cap_cfg=CaptionerConfig.tiny(), max_new=8)
    rng = np.random.default_rng(0)
    chunk_a = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
               for _ in range(3)]
    chunk_b = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
               for _ in range(3)]
    singles = [client.caption_batch_sync([chunk_a])[0],
               client.caption_batch_sync([chunk_b])[0]]
    batched = client.caption_batch_sync([chunk_a, chunk_b])
    assert batched == singles


def test_preprocess_mode_pins_resize_path(monkeypatch):
    """ADVICE r2: numerics must not silently depend on cv2 availability.
    'device' and 'auto' never host-resize even for large frames; 'host'
    always does
    (and errors without cv2); fast_resize=False runs the exact f32 path."""
    from vidgraph_tpu.models.captioner import CaptionerConfig
    from vidgraph_tpu.models.vit import ViTConfig

    rng = np.random.default_rng(0)
    # 200x200 frames vs 64px tower input -> the "big" auto-trigger fires
    chunk = [rng.integers(0, 256, (200, 200, 3), dtype=np.uint8)
             for _ in range(2)]

    def make(**kw):
        return TPUVLMClient(vit_cfg=ViTConfig.tiny(),
                            cap_cfg=CaptionerConfig.tiny(), max_new=4, **kw)

    cv2 = pytest.importorskip("cv2")
    calls = []
    real_resize = cv2.resize

    def spy(*a, **kw):
        calls.append(1)
        return real_resize(*a, **kw)

    monkeypatch.setattr(cv2, "resize", spy)
    out = make(preprocess="device").caption_batch_sync([chunk])
    assert out and not calls                 # device mode: cv2 untouched
    out = make(preprocess="auto").caption_batch_sync([chunk])
    assert out and not calls                 # auto == device, cv2 or not

    out = make(preprocess="host").caption_batch_sync([chunk])
    assert out and calls                     # host mode: cv2 used

    # exact f32 resize path compiles and runs
    out = make(preprocess="device",
               fast_resize=False).caption_batch_sync([chunk])
    assert out

    # host mode without cv2 must fail loudly, not silently change numerics
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("cv2 disabled for test")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="requires cv2"):
        make(preprocess="host").caption_batch_sync([chunk])


def test_local_vlm_caption_batch_default():
    client = LocalVLMClient()
    red = np.zeros((32, 32, 3), np.uint8)
    red[:, :, 0] = 220
    out = asyncio.run(client.caption_batch([[red, red], [red]]))
    assert len(out) == 2
    assert "red" in out[0]


# ------------------------------------------------------------ HTTP clients
def _patch_async_client(monkeypatch, handler):
    import httpx

    real_init = httpx.AsyncClient.__init__

    def init(self, *a, **kw):
        kw["transport"] = httpx.MockTransport(handler)
        kw.pop("timeout", None)
        real_init(self, *a, **kw)

    monkeypatch.setattr(httpx.AsyncClient, "__init__", init)


def test_http_chat_client(monkeypatch):
    import httpx

    def handler(request):
        body = json.loads(request.content)
        assert body["model"] == "m"
        assert body["messages"][-1]["content"] == "hello"
        return httpx.Response(200, json={
            "choices": [{"message": {"content": "world"}}]})

    _patch_async_client(monkeypatch, handler)
    client = HttpChatClient("http://x/v1", "m", retries=1)
    assert asyncio.run(client.complete("hello")) == "world"


def test_http_chat_client_retries_then_fails(monkeypatch):
    import httpx

    calls = []

    def handler(request):
        calls.append(1)
        return httpx.Response(500)

    _patch_async_client(monkeypatch, handler)
    client = HttpChatClient("http://x/v1", "m", retries=3)

    async def fast_sleep(_seconds):
        return None

    import vidgraph_tpu.services.llm_client as llm_mod
    monkeypatch.setattr(llm_mod.asyncio, "sleep", fast_sleep)

    async def run():
        with pytest.raises(RuntimeError):
            await client.complete("q")

    asyncio.run(run())
    assert len(calls) == 3


def test_http_rerank_client(monkeypatch):
    import httpx

    def handler(request):
        body = json.loads(request.content)
        order = sorted(range(len(body["documents"])), reverse=True)
        return httpx.Response(200, json={"results": [
            {"index": i, "relevance_score": 1.0 - 0.1 * n}
            for n, i in enumerate(order)]})

    _patch_async_client(monkeypatch, handler)
    client = HttpRerankClient("http://x/rerank", "m")
    out = asyncio.run(client.rerank("q", ["a", "b", "c"], top_k=2))
    assert out == [(2, 1.0), (1, 0.9)]


def test_http_embed_client(monkeypatch):
    import httpx

    def handler(request):
        body = json.loads(request.content)
        return httpx.Response(200, json={"data": [
            {"index": i, "embedding": [float(i)] * 4}
            for i in range(len(body["input"]))]})

    real_init = httpx.Client.__init__

    def init(self, *a, **kw):
        kw["transport"] = httpx.MockTransport(handler)
        kw.pop("timeout", None)
        real_init(self, *a, **kw)

    monkeypatch.setattr(httpx.Client, "__init__", init)
    client = HttpEmbedClient("http://x/v1", "m")
    out = client.embed(["a", "b"])
    assert out.shape == (2, 4)
    np.testing.assert_array_equal(out[1], [1, 1, 1, 1])


def test_span_records_metric():
    m = MetricsTracker()
    with span("stage_x", m):
        pass
    assert "stage_x" in m.timings


def test_device_trace_writes_profile(tmp_path):
    import jax.numpy as jnp

    from vidgraph_tpu.core.profiling import device_trace

    with device_trace(str(tmp_path)):
        (jnp.ones((8, 8)) @ jnp.ones((8, 8))).block_until_ready()
    # a trace directory with at least one event file appears
    files = list(tmp_path.rglob("*"))
    assert any(f.is_file() for f in files)


# -- extractive answerer (round 2) -------------------------------------------

def test_extractive_answer_multi_sentence_coverage():
    from vidgraph_tpu.services.llm_client import extractive_answer

    ctx = (
        "Found results for 'q':\n"
        "Chunks (3):\n"
        "Time: 00:10-00:15 The person in the lab is wearing blue nitrile "
        "gloves and holds a beaker.\n"
        "Time: 00:15-00:20 A digital balance sits on the bench.\n"
        "Time: 01:00-01:05 The person pours liquid into a flask.")
    ans = extractive_answer(
        "What color are the gloves worn by the person in the lab?", ctx)
    assert "blue" in ans.lower()
    # concise: must not dump the whole context
    assert "pours liquid" not in ans


def test_extractive_answer_preserves_decimals():
    from vidgraph_tpu.services.llm_client import extractive_answer

    ctx = "The display shows a reading of -56.301 g after taring the beaker."
    ans = extractive_answer(
        "What is the displayed reading on the balance when tared?", ctx)
    assert "-56.301" in ans


def test_extractive_answer_numeric_boost():
    from vidgraph_tpu.services.llm_client import extractive_answer

    ctx = ("The balance is measuring the final weight of the substance. "
           "The final weight shown is 80.15 grams on the display.")
    ans = extractive_answer(
        "What is the final weight shown on the digital balance?", ctx)
    assert "80.15" in ans


def test_extractive_answer_empty_context():
    from vidgraph_tpu.services.llm_client import extractive_answer

    assert extractive_answer("What is shown?", "") == "I don't know."


def test_extractive_answer_semantic_hook():
    # optional semantic channel re-ranks near-ties without overruling
    # exact matches
    from vidgraph_tpu.services.llm_client import extractive_answer

    ctx = ("The device stirs the mixture continuously. "
           "A person stands near the window.")

    def sem_fn(q, sents):
        # pretend the first sentence is semantically closest
        return [1.0 if "stirs" in s else 0.0 for s in sents]

    ans = extractive_answer("What mixes the contents?", ctx, sem_fn=sem_fn)
    assert "stirs" in ans
