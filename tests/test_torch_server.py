"""The port's HTTP front end (unimedvl_tpu_torch/inference/server.py) over
loopback: the daemon's loop and every route, driven end to end over the
port's tiny engine (tests/test_pipeline.py's TINY config, fp32, text and
image generation through one engine), the cases of tests/test_server.py.
Answers are held to the port's engine on the same request, and one to the
JAX engine's. The daemon thread serves under ``torch.no_grad()``: grad mode
is per thread in PyTorch, and the kernel wrappers refuse inputs that require
grad while it is on (``ops/_launch.py::check_no_grad``).

Time budget: about 30 s alone.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.inference import serving as jserving
from unimedvl_tpu_torch.data import imaging as timaging
from unimedvl_tpu_torch.data import tokenizer as ttokenizer
from unimedvl_tpu_torch.inference import ContinuousBatcher, InterleaveInferencer, Request
from unimedvl_tpu_torch.inference.server import ServingDaemon, make_server
from unimedvl_tpu_torch.models import qwen2_mot, siglip
from unimedvl_tpu_torch.ops import _launch
from unimedvl_tpu_torch.ops import decode_attention as dec
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY
from tests.test_torch_config import init_params, port_config
from tests.test_torch_pipeline import FakeTokenizer


@pytest.fixture(scope="module")
def parts():
    params = init_params(0, TINY, llm2vae_zero=False)
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())

    def model():
        return from_jax_params(jax.tree.map(np.asarray, params), port_config(TINY), device="cpu")

    def engine(m, pipeline=None, cls=ContinuousBatcher, **kw):
        return cls(m, ttok, tids, vit_transform=timaging.ImageTransform(32, 8, 2, 1024),
                   pipeline=pipeline, **{**dict(num_slots=2, capacity=512, chunk=4), **kw})

    def pipe(m):
        return InterleaveInferencer(m, ttok, tids,
                                    vae_transform=timaging.ImageTransform(32, 8, 8, 1024),
                                    vit_transform=timaging.ImageTransform(32, 8, 2, 1024), seed=3)

    return dict(params=params, model=model(), new_model=model, engine=engine, pipe=pipe)


def start(batcher):
    """(base url, stop()) of a daemon and a server on an ephemeral port."""
    daemon = ServingDaemon(batcher).start()
    server = make_server(daemon, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def stop():
        server.shutdown()
        server.server_close()
        daemon.stop()

    return f"http://127.0.0.1:{server.server_address[1]}", stop


@pytest.fixture(scope="module")
def served(parts):
    m = parts["model"]
    base, stop = start(parts["engine"](m, parts["pipe"](m), gen_chunk=2))
    yield base
    stop()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _engine_answer(parts, prompt, max_new_tokens, **kw):
    ref = parts["engine"](parts["model"])
    rid = ref.submit(Request(prompt=prompt, max_new_tokens=max_new_tokens, **kw))
    return ref.run()[rid]


def _png_b64(seed=0):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (24, 28, 3), dtype=np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class TestHTTPServer:
    def test_generate_matches_engine(self, parts, served):
        """The answer equals the port's engine's and the JAX engine's."""
        tok, ids, _ = add_special_tokens(FakeTokenizer())
        jeng = jserving.ContinuousBatcher(parts["params"], TINY, tok, ids, num_slots=2,
                                          capacity=128, chunk=4,
                                          vit_transform=ImageTransform(32, 8, 2, 1024))
        rid = jeng.submit(jserving.Request(prompt="alpha", max_new_tokens=6))
        want = jeng.run()[rid]
        code, out = _post(served, "/v1/generate", {"prompt": "alpha", "max_new_tokens": 6})
        assert code == 200, out
        assert out["text"] == want == _engine_answer(parts, "alpha", 6)

    def test_concurrent_requests(self, served):
        results = {}

        def go(p):
            results[p] = _post(served, "/v1/generate", {"prompt": p, "max_new_tokens": 5})

        threads = [threading.Thread(target=go, args=(p,)) for p in ("one", "two two", "three")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert set(results) == {"one", "two two", "three"}
        for code, out in results.values():
            assert code == 200 and isinstance(out["text"], str)

    def test_images_route(self, served):
        code, out = _post(served, "/v1/images", {"prompt": "a chest x-ray", "height": 32,
                                                 "width": 32, "num_timesteps": 5})
        assert code == 200, out
        img = Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"])))
        assert img.size == (32, 32) and out["height"] == 32 and out["width"] == 32

    def test_generate_with_image_input(self, parts, served):
        b64 = _png_b64()
        code, out = _post(served, "/v1/generate", {"prompt": "what?", "max_new_tokens": 5,
                                                   "image_png_b64": b64})
        assert code == 200, out
        image = Image.open(io.BytesIO(base64.b64decode(b64)))
        assert out["text"] == _engine_answer(parts, "what?", 5, image=image)

    def test_async_submit_poll_cancel(self, served):
        """submit -> 202 ticket; cancel -> the result resolves as a
        cancellation error (or 409 if the tiny model finished first)."""
        code, out = _post(served, "/v1/generate",
                          {"prompt": "long " * 4, "max_new_tokens": 400, "async": True})
        assert code == 202 and "ticket" in out, (code, out)
        ticket = out["ticket"]
        code, out = _post(served, "/v1/cancel", {"ticket": ticket})
        if code == 200:
            assert out["cancelled"] is True
            try:
                with urllib.request.urlopen(served + f"/v1/result/{ticket}?timeout=120",
                                            timeout=180) as r:
                    r.read()  # finished before the cancel landed
            except urllib.error.HTTPError as e:
                assert e.code == 502 and b"cancel" in e.read()
        else:
            assert code == 409

    def test_async_result_delivers(self, served):
        code, out = _post(served, "/v1/generate",
                          {"prompt": "beta", "max_new_tokens": 5, "async": True})
        assert code == 202
        ticket = out["ticket"]
        t0 = time.time()
        while time.time() - t0 < 120:
            with urllib.request.urlopen(served + f"/v1/result/{ticket}?timeout=5",
                                        timeout=60) as r:
                got = json.loads(r.read())
                if r.status == 200:
                    assert isinstance(got["text"], str)
                    code, out = _post(served, "/v1/cancel", {"ticket": ticket})
                    assert code == 409, (code, out)  # a delivered ticket
                    return
        raise AssertionError("result never delivered")

    def test_health_and_bad_routes(self, served):
        with urllib.request.urlopen(served + "/v1/health", timeout=60) as r:
            health = json.loads(r.read())
        assert health["ok"] is True and "gen_s" in health["stats"]
        assert _post(served, "/v1/nope", {})[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(served + "/v1/result/x", timeout=60)
        assert e.value.code == 400
        # an over-capacity request comes back as the engine's error, not a hang
        code, out = _post(served, "/v1/generate", {"prompt": "x", "max_new_tokens": 100000})
        assert code == 502 and "capacity" in out["error"]


class TestPrefixRoute:
    def test_register_and_use_prefix(self, parts, served):
        pre = "system preamble: "
        code, out = _post(served, "/v1/prefixes", {"text": pre})
        assert code == 200, out
        code, got = _post(served, "/v1/generate", {"prompt": "alpha", "max_new_tokens": 6,
                                                   "prefix_id": out["prefix_id"]})
        assert code == 200, got
        assert got["text"] == _engine_answer(parts, pre + "alpha", 6)


class TestPartialResults:
    def test_partials_snapshot_mid_decode(self, parts):
        """The daemon's loop driven by hand: the partial text after each round
        grows as a chain of prefixes of the final text."""
        batcher = parts["engine"](parts["model"])
        daemon = ServingDaemon(batcher)  # not started: rounds by hand
        ticket = daemon.submit(Request(prompt="stream me a long answer please",
                                       max_new_tokens=48))
        eos = batcher.new_token_ids["eos_token_id"]
        snapshots = []
        for _ in range(64):
            daemon._drain()
            if not batcher.has_work():
                break
            batcher._round(batcher.stats, eos)
            daemon._collect()
            daemon._publish_partials()
            if daemon.partial(ticket):
                snapshots.append(daemon.partial(ticket))
        kind, final = daemon.result(ticket, timeout=0)
        assert kind == "ok", (kind, final)
        assert snapshots
        for a, b in zip(snapshots, snapshots[1:]):
            assert b.startswith(a), (a, b)
        assert final.startswith(snapshots[-1])

    def test_pending_result_carries_partial_text(self, parts):
        """An async ticket polled mid-decode returns 202 with the text so
        far; an engine that holds each round boundary open makes the polls
        land between rounds."""
        class SlowRoundBatcher(ContinuousBatcher):
            def _round(self, st, eos):
                super()._round(st, eos)
                time.sleep(0.25)

        base, stop = start(parts["engine"](parts["model"], cls=SlowRoundBatcher))
        try:
            code, out = _post(base, "/v1/generate", {
                "prompt": "stream me a long answer please", "max_new_tokens": 48,
                "async": True})
            assert code == 202
            ticket, partial_seen, final = out["ticket"], "", None
            for _ in range(600):
                with urllib.request.urlopen(base + f"/v1/result/{ticket}?timeout=0.05",
                                            timeout=60) as r:
                    code, out = r.status, json.loads(r.read())
                if code == 200:
                    final = out["text"]
                    break
                if out.get("partial"):
                    partial_seen = out["partial"]
            assert final is not None
            assert partial_seen and final.startswith(partial_seen), (partial_seen, final)
        finally:
            stop()


def test_daemon_serves_with_grad_off(parts, monkeypatch):
    """The daemon thread runs its rounds with grad mode off. The model here
    has parameters that require grad, and the attention calls take the
    kernels' route as it is on the card: ``check_no_grad`` on the inputs
    (raising while grad mode is on), then the plain version, since the
    tensors lie on the CPU. A text request, an image request and a request
    with an image input are served without that error, and every one of
    those calls ran with grad mode off, as did every round of the loop."""
    model = parts["new_model"]()
    for p in model.parameters():
        p.requires_grad_(True)
    grad_modes = []

    def routed(name, ref):
        def call(q, k, v, *args, **kw):
            grad_modes.append(torch.is_grad_enabled())
            _launch.check_no_grad(name, ("q", "k", "v"), (q, k, v))
            return ref(q, k, v, *args, **kw)
        return call

    flash = routed("flash_block_attention", fa.flash_block_attention_ref)
    for mod in (qwen2_mot, siglip):
        monkeypatch.setattr(mod, "flash_block_attention", flash)
    monkeypatch.setattr(qwen2_mot, "decode_attention",
                        routed("decode_attention", dec.decode_attention_ref))
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):  # the route, grad on
        flash(q, q, q, torch.tensor([2]), torch.tensor([0]), False)
    grad_modes.clear()
    round_modes = []

    class Recording(ContinuousBatcher):
        def _round(self, st, eos):
            round_modes.append(torch.is_grad_enabled())
            super()._round(st, eos)

    base, stop = start(parts["engine"](model, parts["pipe"](model), cls=Recording,
                                       gen_chunk=2))
    try:
        code, text = _post(base, "/v1/generate", {"prompt": "alpha", "max_new_tokens": 4})
        assert code == 200, text
        code, vqa = _post(base, "/v1/generate", {"prompt": "what?", "max_new_tokens": 4,
                                                 "image_png_b64": _png_b64(1)})
        assert code == 200, vqa
        code, image = _post(base, "/v1/images", {"prompt": "x", "height": 32, "width": 32,
                                                 "num_timesteps": 3})
        assert code == 200, image
    finally:
        stop()
    assert grad_modes and not any(grad_modes)
    assert round_modes and not any(round_modes)
