"""The port's resident inference server (clibd_tpu_torch/engine/serve.py and
`cli serve`) against clibd_tpu's, at the tiny size of tests/test_serve.py:
one weight set feeds both services (through the bridge), and the port's
embeddings agree with the JAX service's; padded micro-batching keeps rows
independent, concurrent requests coalesce, the HTTP layer round-trips and
rejects malformed input, and the gallery (fp32 or int8, from a file or from
arrays) reloads while serving.  Every input comes from a numpy generator
seeded inside its test or fixture."""

import base64
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from clibd_tpu.config import schema as jax_schema
from clibd_tpu.engine import serve as jax_serve
from clibd_tpu.models import init_clibd_params
from clibd_tpu_torch.config import schema as port_schema
from clibd_tpu_torch.engine import serve as port_serve
from clibd_tpu_torch.engine.extract import save_embedding_export
from clibd_tpu_torch.models.convert import model_from_jax
from tests.fixtures import TINY_VOCAB, random_jpeg_bytes, write_tiny_vocab

LEVELS = ("order", "family", "genus", "species")
ATOL = 5e-3  # bf16 forwards in two packages (tests/test_serve.py's bound)


def _tiny_cfg(schema, **mods):
    cfg = schema.GlobalConfig()
    mc = cfg.model_config
    mc.output_dim = 16
    mc.image.vit = schema.ViTConfig(image_size=64, patch_size=16, hidden_size=32, num_layers=1,
                                    num_heads=4, mlp_dim=64)
    mc.dna.bert = schema.BertConfig(vocab_size=1027, hidden_size=32, num_layers=1, num_heads=4,
                                    intermediate_size=64, max_position_embeddings=140,
                                    with_mlm_head=True)
    for path, value in mods.items():
        schema.set_by_path(mc, path, value)
    return mc


def _both(seed=0, **mods):
    """(JAX params, JAX config, port model on the CPU, port config) of one
    weight set."""
    jmc = _tiny_cfg(jax_schema, **mods)
    params = jax.tree.map(np.asarray, init_clibd_params(jax.random.PRNGKey(seed), jmc))
    pmc = _tiny_cfg(port_schema, **mods)
    return params, jmc, model_from_jax(params, pmc, "cpu"), pmc


def _port_service(model, mc, **kw):
    kw = {"window_ms": 1.0, "buckets": (1,), "image_size": 64, "resize_to": 72, **kw}
    return port_serve.InferenceService(model, mc, device="cpu", **kw)


def _labels(n, prefix=""):
    return [{lv: f"{prefix}{lv}{i}" for lv in LEVELS} for i in range(n)]


def _export(path, image=None, dna=None, language=None, prefix=""):
    n = len(next(x for x in (image, dna, language) if x is not None))
    save_embedding_export(str(path), {
        "encoded_image_feature": image, "encoded_dna_feature": dna,
        "encoded_language_feature": language, "label_list": _labels(n, prefix),
        "file_name_list": [f"{prefix}f{i}.jpg" for i in range(n)]})


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    params, jmc, model, mc = _both()
    rng = np.random.default_rng(1)
    n, d = 6, mc.output_dim
    feats = _unit_rows(rng, n, d)
    jpeg = random_jpeg_bytes(rng, h=64, w=80)
    svc = _port_service(model, mc, window_ms=200.0, max_batch=4, buckets=(1, 2, 4))
    feats[0] = svc.embed(image_bytes=jpeg)["image"]
    svc.close()
    keys_path = tmp_path_factory.mktemp("serve") / "keys.hdf5"
    _export(keys_path, image=feats, dna=feats[::-1].copy())
    service = _port_service(model, mc, keys_path=str(keys_path), window_ms=200.0, max_batch=4,
                            buckets=(1, 2, 4))
    yield {"service": service, "params": params, "jmc": jmc, "model": model, "mc": mc,
           "jpeg": jpeg, "rng": np.random.default_rng(2)}
    service.close()


def test_embed_matches_jax_service(served):
    """The port's service and the JAX package's, on one weight set, give the
    same image and DNA embeddings (unit norm)."""
    svc, jpeg = served["service"], served["jpeg"]
    barcode = "ACGTACGTAAACCCGGGTTTACGT"
    out = svc.embed(image_bytes=jpeg, dna=barcode)
    jsvc = jax_serve.InferenceService(served["params"], served["jmc"], window_ms=1.0,
                                      buckets=(1,), image_size=64, resize_to=72)
    try:
        want = jsvc.embed(image_bytes=jpeg, dna=barcode)
    finally:
        jsvc.close()
    for m in ("image", "dna"):
        assert out[m].dtype == np.float32 and out[m].shape == (16,)
        np.testing.assert_allclose(out[m], want[m], atol=ATOL)
        assert abs(float(np.linalg.norm(out[m])) - 1.0) < 1e-5
    assert out["language"] is None


def test_rows_independent_of_bucket_neighbours(served):
    """One padded forward: the same query row is bit-identical whether its
    neighbours are zeros or other images, and equals the direct B=1
    forward to bf16 noise."""
    from clibd_tpu_torch.engine.extract import to_device
    from clibd_tpu_torch.models.clibd import clibd_apply

    svc, jpeg = served["service"], served["jpeg"]
    x0 = svc.preprocess_image(jpeg)
    x_other = svc.preprocess_image(random_jpeg_bytes(np.random.default_rng(7), h=64, w=80))
    zeros = np.stack([x0, np.zeros_like(x0), np.zeros_like(x0), np.zeros_like(x0)])
    mixed = np.stack([x0, x_other, x_other, x_other])
    out_zeros = svc._apply["image"](zeros)
    out_mixed = svc._apply["image"](mixed)
    np.testing.assert_array_equal(out_zeros[0], out_mixed[0])
    with torch.inference_mode():
        direct = clibd_apply(served["model"], served["mc"],
                             image_input=to_device(x0[None], torch.device("cpu")))["image"]
    np.testing.assert_allclose(out_zeros[0], direct[0].numpy(), atol=ATOL)


def test_concurrent_requests_coalesce(served):
    """4 concurrent embeds inside one 200 ms window → fewer batches than
    requests, each request its own output."""
    svc, rng = served["service"], served["rng"]
    jpegs = [random_jpeg_bytes(rng, h=64, w=80) for _ in range(4)]
    b0 = svc.stats.batches
    with ThreadPoolExecutor(max_workers=4) as pool:
        outs = list(pool.map(lambda j: svc.embed(image_bytes=j), jpegs))
    assert all(o["image"] is not None for o in outs)
    batches = svc.stats.batches - b0
    assert 1 <= batches < 4, f"no coalescing happened ({batches} batches)"
    assert not np.allclose(outs[0]["image"], outs[1]["image"])
    for j, o in zip(jpegs, outs):  # each slice is its own request's row
        np.testing.assert_allclose(o["image"], svc._apply["image"](
            svc.preprocess_image(j)[None])[0], atol=ATOL)


def test_search_finds_planted_key(served):
    svc, jpeg = served["service"], served["jpeg"]
    out = svc.search(image_bytes=jpeg, k=3)
    assert out["image"]["predictions"][0]["species"] == "species0"
    assert out["image"]["scores"][0] == pytest.approx(1.0, abs=1e-4)
    assert out["image"]["key_type"] == "encoded_image_feature"
    assert len(out["image"]["predictions"]) == 3 and len(out["embeddings"]["image"]) == 16
    # cross-modal: the image query against the DNA gallery (rows reversed)
    out2 = svc.search(image_bytes=jpeg, k=1, against="dna")
    assert out2["image"]["key_type"] == "encoded_dna_feature"
    assert out2["image"]["predictions"][0]["species"] == "species5"
    with pytest.raises(KeyError, match="encoded_language_feature"):
        svc.search(image_bytes=jpeg, against="language")


def test_bucket_list_always_reaches_max_batch(served):
    svc = _port_service(served["model"], served["mc"], window_ms=300.0, buckets=(1, 2),
                        max_batch=3)
    try:
        assert svc.buckets == (1, 2, 3)
        rng = np.random.default_rng(3)
        jpegs = [random_jpeg_bytes(rng, h=64, w=80) for _ in range(3)]
        with ThreadPoolExecutor(max_workers=3) as pool:
            outs = list(pool.map(lambda j: svc.embed(image_bytes=j), jpegs))
        assert all(o["image"] is not None for o in outs)
    finally:
        svc.close()


def test_unsupported_modality_and_bad_image_rejected_upfront():
    _, _, model, mc = _both(**{"dna.enable": False})
    assert model.dna_encoder is None
    svc = _port_service(model, mc)
    try:
        with pytest.raises(ValueError, match="no DNA encoder"):
            svc.embed(dna="ACGT")
        with pytest.raises(ValueError, match="undecodable image"):
            svc.embed(image_bytes=b"definitely not a jpeg")
        with pytest.raises(ValueError, match="language-vocab"):
            svc.embed(text="diptera")
        assert svc.stats.batches == 0
    finally:
        svc.close()


def test_load_shedding(served):
    svc = _port_service(served["model"], served["mc"], max_queue=2)
    svc._closed.set()  # park the batcher so the queue fills
    svc._queue.put(None)
    svc._batcher.join(timeout=10)
    try:
        svc._queue.put({"future": None})
        svc._queue.put({"future": None})
        with pytest.raises(RuntimeError, match="overloaded"):
            svc.embed(dna="ACGT")
        assert svc.stats.snapshot()["errors"] == 1
    finally:
        while not svc._queue.empty():
            svc._queue.get_nowait()
        svc.close()


def test_close_fails_queued_requests(served):
    from concurrent.futures import Future

    svc = _port_service(served["model"], served["mc"])
    svc._closed.set()
    svc._queue.put(None)
    svc._batcher.join(timeout=10)
    assert not svc._batcher.is_alive()
    orphan = {"future": Future(), "dna": svc.preprocess_dna("ACGT")}
    svc._queue.put(orphan)
    svc.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        orphan["future"].result(timeout=1)
    with pytest.raises(RuntimeError, match="shutting down"):
        svc.embed(dna="ACGT")


def test_text_queries(tmp_path):
    """WordPiece text → language embedding equal to the JAX service's; a
    text search against the language gallery; an up-front error without a
    vocabulary."""
    vocab_path = write_tiny_vocab(str(tmp_path / "vocab.txt"))
    params, jmc, model, mc = _both(**{"language.bert.vocab_size": len(TINY_VOCAB)})
    text = "diptera cecidomyiidae"
    svc = _port_service(model, mc, buckets=(1, 2), language_vocab=vocab_path)
    jsvc = jax_serve.InferenceService(params, jmc, window_ms=1.0, buckets=(1,), image_size=64,
                                      resize_to=72, language_vocab=vocab_path)
    try:
        out = svc.embed(text=text)
        assert out["language"] is not None and out["image"] is None
        np.testing.assert_allclose(out["language"], jsvc.embed(text=text)["language"], atol=ATOL)
        feats = _unit_rows(np.random.default_rng(2), 4, mc.output_dim)
        feats[2] = out["language"]
        keys_path = tmp_path / "lang_keys.hdf5"
        _export(keys_path, language=feats)
        svc.reload_keys(str(keys_path))
        res = svc.search(text=text, k=2)
        assert res["language"]["key_type"] == "encoded_language_feature"
        assert res["language"]["predictions"][0]["species"] == "species2"
    finally:
        svc.close()
        jsvc.close()
    svc3 = _port_service(model, mc)
    try:
        with pytest.raises(ValueError, match="language-vocab"):
            svc3.embed(text=text)
    finally:
        svc3.close()


def test_clip_text_queries(tmp_path):
    """open_clip-backbone text through the CLIP BPE tokenizer, equal to the
    JAX service's; an up-front error naming clip.bpe_path without one."""
    import gzip

    bpe = tmp_path / "bpe.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2", "d i", "di p", "dip t"]))
    mods = {"backbone": "open_clip", "image.enable": False, "dna.enable": False,
            "clip.context_length": 16, "clip.text_hidden": 16, "clip.text_layers": 1,
            "clip.text_heads": 2, "clip.text_mlp": 32, "clip.embed_dim": 16,
            "clip.bpe_path": str(bpe)}
    params, jmc, model, mc = _both(**mods)
    text = "diptera cecidomyiidae"
    svc = _port_service(model, mc, buckets=(1, 2))
    jsvc = jax_serve.InferenceService(params, jmc, window_ms=1.0, buckets=(1,), image_size=64)
    try:
        out = svc.embed(text=text)
        np.testing.assert_allclose(out["language"], jsvc.embed(text=text)["language"], atol=ATOL)
        svc.pre_warm()  # the clip-text warm branch
    finally:
        svc.close()
        jsvc.close()
    mc.clip.bpe_path = ""
    svc2 = _port_service(model, mc)
    try:
        with pytest.raises(ValueError, match="bpe_path"):
            svc2.embed(text=text)
    finally:
        svc2.close()


def test_search_without_keys_raises(served):
    svc = _port_service(served["model"], served["mc"])
    try:
        with pytest.raises(RuntimeError, match="no key set"):
            svc.search(dna="ACGT")
        with pytest.raises(ValueError, match="provide image bytes"):
            svc.embed()
    finally:
        svc.close()


def _start(svc):
    server = port_serve.make_server(svc, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def call(path, payload=None):
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()

    return server, call


def test_http_roundtrip(served):
    svc, jpeg = served["service"], served["jpeg"]
    server, raw = _start(svc)

    def call(path, payload=None):
        status, _, body = raw(path, payload)
        return status, json.loads(body)

    try:
        status, health = call("/healthz")
        assert status == 200 and health["status"] == "ok" and health["keys"] == 6
        assert health["buckets"] == [1, 2, 4]
        b64 = base64.b64encode(jpeg).decode()
        status, emb = call("/embed", {"image_b64": b64, "dna": "ACGTACGT"})
        assert status == 200 and emb["language"] is None
        assert len(emb["image"]) == len(emb["dna"]) == 16
        status, res = call("/search", {"image_b64": b64, "k": 2})
        assert status == 200 and res["image"]["predictions"][0]["species"] == "species0"
        status, stats = call("/stats")
        assert status == 200 and stats["requests"] >= 2
        status, headers, body = raw("/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        metrics = dict(line.split() for line in body.decode().splitlines()
                       if line and not line.startswith("#"))
        assert float(metrics["clibd_requests_total"]) >= 2
        assert float(metrics["clibd_gallery_keys"]) == 6
        assert float(metrics["clibd_batcher_up"]) == 1
        assert "clibd_latency_p50_ms" in metrics
        bad_img = base64.b64encode(b"not an image").decode()
        for path, payload, want in (("/embed", {}, 400), ("/embed", {"image_b64": "!!!"}, 400),
                                    ("/embed", {"image_b64": bad_img}, 400),
                                    ("/embed", [1, 2], 400), ("/embed", {"dna": 5}, 400),
                                    ("/search", {"dna": "ACGT", "against": "x"}, 400),
                                    ("/nope", {"dna": "A"}, 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                call(path, payload)
            assert e.value.code == want, path
    finally:
        server.shutdown()
        server.server_close()


TINY_EXP = (
    "model_output_name: serve_test\n"
    "dataset: bioscan_1m\n"
    "batch_size: 4\n"
    "output_dim: 16\n"
    "load_ckpt: false\n"
    "image:\n  vit:\n    image_size: 64\n    patch_size: 16\n"
    "    hidden_size: 32\n    num_layers: 1\n    num_heads: 4\n"
    "    mlp_dim: 64\n"
    "dna:\n  bert:\n    vocab_size: 1027\n    hidden_size: 32\n"
    "    num_layers: 1\n    num_heads: 4\n    intermediate_size: 64\n"
    "    max_position_embeddings: 140\n    with_mlm_head: true\n")


def test_cmd_serve_builds_service_and_shuts_down(tmp_path, monkeypatch):
    """cmd_serve minus serve_forever: builds the service on the asked device
    from the experiment config (image geometry from the ViT config), starts
    the real HTTP server, and tears both down."""
    import clibd_tpu_torch.cli as cli

    exp = tmp_path / "tiny.yaml"
    exp.write_text(TINY_EXP)
    built = {}
    orig_make_server = port_serve.make_server

    def spy_make_server(service, host="127.0.0.1", port=8000):
        built["service"] = service
        server = orig_make_server(service, host=host, port=port)

        class Wrap:
            server_address = server.server_address

            def serve_forever(self):
                raise KeyboardInterrupt  # immediate clean exit

            def shutdown(self):
                pass  # serve_forever never ran

            def server_close(self):
                server.server_close()

        return Wrap()

    monkeypatch.setattr(port_serve, "make_server", spy_make_server)
    rc = cli.main(["serve", "-e", str(exp), "--port", "0", "--no-warm", "--max-batch", "3",
                   "--device", "cpu", f"model_output_dir={tmp_path}/out",
                   f"project_root_path={tmp_path}"])
    assert rc == 0
    svc = built["service"]
    assert svc.image_size == 64 and svc.resize_to == round(64 * 256 / 224)
    assert svc.buckets == (1, 2, 3) and svc.keys is None and svc.device.type == "cpu"
    assert svc._closed.is_set() and not svc._batcher.is_alive()


def test_cli_serve_parser_wiring(monkeypatch):
    import clibd_tpu_torch.cli as cli

    seen = {}

    def fake_serve(args, overrides):
        seen.update(vars(args))
        seen["overrides"] = overrides
        return 0

    monkeypatch.setattr(cli, "cmd_serve", fake_serve)
    rc = cli.main(["serve", "-e", "x.yaml", "--port", "0", "--keys", "k.hdf5", "--window-ms",
                   "2", "--max-batch", "8", "--keys-dtype", "int8", "pipeline.num_workers=0"])
    assert rc == 0
    assert seen["command"] == "serve" and seen["max_batch"] == 8 and seen["device"] == "cuda"
    assert seen["window_ms"] == 2.0 and seen["keys"] == "k.hdf5" and seen["keys_dtype"] == "int8"
    assert seen["overrides"] == ["pipeline.num_workers=0"]
    assert "compile_cache" not in seen
    with pytest.raises(SystemExit):
        cli.main(["serve", "-e", "x.yaml", "--compile-cache", "d"])


def test_preprocess_honors_checkpoint_tokenizer_and_transform():
    """An overlap-tokenizer checkpoint gets overlap token dicts, a
    `transform_with_resize` one the long-edge eval transform; the token
    dict flows through the batcher and agrees with the JAX service."""
    from clibd_tpu.data.tokenizers import tokenize_dna_batch_overlapping
    from clibd_tpu.data.transforms import eval_transform

    mods = {"dna.tokenizer": "overlap", "dna.kmer": 4, "dna.max_bp": 120,
            "dna.bert.vocab_size": 259, "dna.bert.max_position_embeddings": 130,
            "transform_with_resize": True}
    params, jmc, model, mc = _both(**mods)
    svc = _port_service(model, mc, buckets=(1, 2), max_batch=2)
    jsvc = jax_serve.InferenceService(params, jmc, window_ms=1.0, buckets=(1,), image_size=64,
                                      resize_to=72)
    try:
        barcode = "ACGTACGTACGTACGTACGT"
        tok = svc.preprocess_dna(barcode)
        assert isinstance(tok, dict) and set(tok) == {"input_ids", "attention_mask"}
        ids, att = tokenize_dna_batch_overlapping([barcode], k=4, stride=1, max_bp=120)
        np.testing.assert_array_equal(tok["input_ids"], ids[0])
        np.testing.assert_array_equal(tok["attention_mask"], att[0, : ids.shape[1]])
        jpeg = random_jpeg_bytes(np.random.default_rng(3), h=64, w=96)
        img = svc.preprocess_image(jpeg)
        np.testing.assert_array_equal(img, np.asarray(eval_transform(jpeg, size=64, resize_to=72,
                                                                     long_edge=True)))
        svc.pre_warm()  # the dict-shaped DNA warm batch
        np.testing.assert_allclose(svc.embed(dna=barcode)["dna"],
                                   jsvc.embed(dna=barcode)["dna"], atol=ATOL)
    finally:
        svc.close()
        jsvc.close()


def test_keyset_int8_gallery(tmp_path):
    """keys_dtype int8: the gallery holds int8 rows on the device, warms, and
    finds the planted neighbour; its scores agree with the JAX KeySet's."""
    rng = np.random.default_rng(5)
    feats = _unit_rows(rng, 64, 16)
    path = tmp_path / "keys.hdf5"
    _export(path, image=feats)
    ks = port_serve.KeySet(str(path), dtype="int8", device="cpu")
    qk = ks.features["encoded_image_feature"]
    assert qk.q.dtype == torch.int8 and qk.scale.dtype == torch.float32
    ks.warm()
    ks_raw = port_serve.KeySet(str(path), dtype="int8", rerank_oversample=0, device="cpu")
    jks = jax_serve.KeySet(str(path), dtype="int8", rerank_oversample=0)
    q = feats[7][None] + 0.001
    sims, idx = ks.search(q, "encoded_image_feature", k=3)
    assert idx[0, 0] == 7 and sims[0, 0] > 0.99
    got_s, got_i = ks_raw.search(q, "encoded_image_feature", k=3)
    want_s, want_i = jks.search(q, "encoded_image_feature", k=3)
    assert got_i[0, 0] == want_i[0, 0] == 7
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)


def test_gallery_read_never_blocks_writer(tmp_path):
    """open_gallery_readonly takes no HDF5 file lock: a writer process
    truncating the live path while the server's read handle is open
    succeeds."""
    import subprocess
    import sys

    import h5py

    path = tmp_path / "live.hdf5"
    _export(path, image=np.random.default_rng(5).normal(size=(4, 8)).astype(np.float32))
    writer_code = (
        "import h5py, numpy as np\n"
        f"with h5py.File({str(path)!r}, 'w') as w:\n"
        "    w.create_dataset('encoded_image_feature', data=np.zeros((2, 8), np.float32))\n")
    reader = port_serve.open_gallery_readonly(str(path))
    try:
        assert reader["encoded_image_feature"].shape == (4, 8)
        res = subprocess.run([sys.executable, "-c", writer_code], capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
    finally:
        reader.close()
    with h5py.File(str(path), "r") as f:
        assert f["encoded_image_feature"].shape == (2, 8)


def test_gallery_hot_reload(served, tmp_path):
    """POST /reload swaps in a grown gallery, a bad path is a 400 that
    leaves the old gallery serving, and /healthz counts reloads."""
    svc, jpeg = served["service"], served["jpeg"]
    emb = svc.embed(image_bytes=jpeg)["image"]
    feats = _unit_rows(np.random.default_rng(11), 10, emb.shape[0])
    feats[9] = emb
    new_path = tmp_path / "grown.hdf5"
    _export(new_path, image=feats, prefix="new_")
    server, raw = _start(svc)

    def call(path, payload=None):
        status, _, body = raw(path, payload)
        return status, json.loads(body)

    old_path, reloads = svc.keys_path, svc.reloads
    try:
        status, out = call("/reload", {"keys": str(new_path)})
        assert status == 200 and out["keys"] == 10 and out["previous"] == 6
        _, res = call("/search", {"image_b64": base64.b64encode(jpeg).decode(), "k": 1})
        assert res["image"]["predictions"][0]["species"] == "new_species9"
        _, health = call("/healthz")
        assert health["keys"] == 10 and health["reloads"] == reloads + 1
        with pytest.raises(urllib.error.HTTPError) as e:
            call("/reload", {"keys": str(tmp_path / "missing.hdf5")})
        assert e.value.code == 400
        _, health = call("/healthz")
        assert health["keys"] == 10 and health["reloads"] == reloads + 1
    finally:
        svc.reload_keys(old_path)
        server.shutdown()
        server.server_close()


def test_reload_watch_auto_swaps(served, tmp_path):
    """A gallery file change, stable across two polls, reloads with no HTTP
    call; a torn write is retried with the old gallery serving until a
    valid file lands."""
    import shutil
    import time

    svc = served["service"]
    fixture_path = svc.keys_path
    watched = tmp_path / "watched.hdf5"
    shutil.copy(fixture_path, watched)
    svc.reload_keys(str(watched))
    old_n = svc.keys.n

    def write_gallery(n):
        _export(watched, image=_unit_rows(np.random.default_rng(n), n, 16), prefix="w_")

    def wait_for(pred, timeout=60.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return False

    svc.start_reload_watch(0.05)
    try:
        write_gallery(old_n + 3)
        assert wait_for(lambda: svc.keys.n == old_n + 3), svc.keys.n
        reloads_before = svc.reloads
        watched.write_bytes(b"not an hdf5 file")
        time.sleep(0.5)
        assert svc.keys.n == old_n + 3 and svc.reloads == reloads_before
        write_gallery(old_n + 5)
        assert wait_for(lambda: svc.keys.n == old_n + 5), "no recovery after the torn write"
    finally:
        svc.stop_reload_watch()
        svc.reload_keys(fixture_path)
    assert svc._watcher is None


def test_search_snapshots_gallery_across_reload(served, tmp_path):
    """A reload landing between the search and the label lookup does not
    pair old-gallery indices with new-gallery labels."""
    svc, jpeg = served["service"], served["jpeg"]
    emb = svc.embed(image_bytes=jpeg)["image"]
    feats = np.asarray([emb] + list(np.eye(emb.shape[0], dtype=np.float32)[:5]))
    new_path = tmp_path / "swapped.hdf5"
    _export(new_path, image=feats, prefix="swapped_")
    old_path, old_keys = svc.keys_path, svc.keys
    orig_search = old_keys.search

    def search_then_swap(queries, key_type, k):
        out = orig_search(queries, key_type, k)
        svc.reload_keys(str(new_path))  # lands before the label lookup
        return out

    old_keys.search = search_then_swap
    try:
        res = svc.search(image_bytes=jpeg, k=1)
        assert res["image"]["predictions"][0]["species"] == "species0"
        assert svc.keys.labels["species"][0] == "swapped_species0"
    finally:
        old_keys.search = orig_search
        svc.reload_keys(old_path)


def test_keyset_selector_auto_policy(tmp_path):
    """selector 'auto' is approx only where the host re-rank restores
    exactness (int8 + oversample), exact otherwise, as in the JAX KeySet;
    fp32 with explicit approx keeps the re-rank and equals exact fp32."""
    feats = _unit_rows(np.random.default_rng(9), 32, 16)
    path = tmp_path / "keys.hdf5"
    _export(path, image=feats)
    for kw in ({}, {"dtype": "int8"}, {"dtype": "int8", "rerank_oversample": 0},
               {"dtype": "int8", "selector": "exact"}, {"selector": "approx"},
               {"selector": "approx", "rerank_oversample": 0}):
        got = port_serve.KeySet(str(path), device="cpu", **kw)
        want = jax_serve.KeySet(str(path), **kw)
        assert (got.selector, got.rerank_oversample, sorted(got._host_fp32)) == \
            (want.selector, want.rerank_oversample, sorted(want._host_fp32)), kw
        assert got._device_k == want._device_k
    ks_auto = port_serve.KeySet(str(path), device="cpu")
    assert ks_auto.selector == "exact" and ks_auto.rerank_oversample == 0
    sims, idx = port_serve.KeySet(str(path), dtype="int8", device="cpu").search(
        feats[3][None] + 0.001, "encoded_image_feature", k=3)
    assert idx[0, 0] == 3 and sims[0, 0] > 0.99
    ks_fa = port_serve.KeySet(str(path), selector="approx", device="cpu")
    q = feats[5][None] + 0.001
    s_exact, i_exact = ks_auto.search(q, "encoded_image_feature", k=3)
    s_fa, i_fa = ks_fa.search(q, "encoded_image_feature", k=3)
    np.testing.assert_array_equal(i_exact, i_fa)
    np.testing.assert_allclose(s_exact, s_fa, atol=1e-5)
    with pytest.raises(ValueError, match="selector"):
        port_serve.KeySet(str(path), selector="fast", device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_keyset_from_arrays_equals_the_file_form(tmp_path, dtype):
    """KeySet.from_arrays (the card's way in: no h5py there) holds what the
    path form reads, and searches alike; the caller's arrays stay as they
    were."""
    rng = np.random.default_rng(21)
    image, dna = rng.normal(size=(40, 16)).astype(np.float32), _unit_rows(rng, 40, 16)
    path = tmp_path / "keys.hdf5"
    _export(path, image=image, dna=dna)
    image_before = image.copy()
    from_file = port_serve.KeySet(str(path), dtype=dtype, device="cpu")
    labels = {lv: [d[lv] for d in _labels(40)] for lv in LEVELS}
    from_arrays = port_serve.KeySet.from_arrays(
        {"encoded_image_feature": image, "encoded_dna_feature": dna,
         "encoded_language_feature": None}, labels, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(image, image_before)
    assert from_arrays.labels == from_file.labels and from_arrays.n == from_file.n == 40
    assert sorted(from_arrays.features) == sorted(from_file.features)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    for key_type in from_file.features:
        got = from_arrays.search(q, key_type, k=4)
        want = from_file.search(q, key_type, k=4)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("where", ["service", "keyset"])
def test_sharded_gallery_raises(served, where):
    """The key-sharded gallery, once raising, is ported: the fixture's
    gallery sharded over two devices (the CPU named twice; 6 rows, 3 a
    shard) answers as the unsharded one does, the service's search and a
    KeySet's alike."""
    svc = served["service"]
    devices = ["cpu", "cpu"]
    if where == "service":
        sharded = port_serve.InferenceService(served["model"], served["mc"],
                                              keys_path=svc.keys_path, keys_mesh=devices,
                                              device="cpu", window_ms=1.0, buckets=(1,),
                                              image_size=64, resize_to=72)
        try:
            for against in ("image", "dna"):
                got = sharded.search(image_bytes=served["jpeg"], k=4, against=against)
                want = svc.search(image_bytes=served["jpeg"], k=4, against=against)
                assert got["image"]["predictions"] == want["image"]["predictions"]
                np.testing.assert_allclose(got["image"]["scores"], want["image"]["scores"],
                                           rtol=0, atol=1e-6)
        finally:
            sharded.close()
        return
    keys = port_serve.KeySet(svc.keys_path, mesh=devices, device="cpu")
    assert all(len(f.shards) == 2 for f in keys.features.values())
    q = served["rng"].normal(size=(3, served["mc"].output_dim)).astype(np.float32)
    for key_type in keys.features:
        got, want = keys.search(q, key_type, k=5), svc.keys.search(q, key_type, k=5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_bench_serve_accounting_on_the_cpu():
    """The bench_serve tool's two runs on a tiny model: unbatched is one
    request per device batch, coalesced no more batches than requests; the
    speedup is the ratio of the two rates."""
    from clibd_tpu_torch.models import init_clibd_model
    from clibd_tpu_torch.tools import bench_serve

    mc = bench_serve.tiny_config()
    model = init_clibd_model(mc, torch.Generator().manual_seed(0), "cpu")
    res = bench_serve.bench(model, mc, clients=3, per_client=2, device="cpu")
    un, co = res["unbatched"], res["coalesced"]
    assert un["requests"] == co["requests"] == 6
    assert un["batches"] == 6 and un["mean_batch"] == 1.0
    assert 1 <= co["batches"] <= 6 and co["mean_batch"] == 6 / co["batches"]
    assert un["p50_ms"] <= un["p95_ms"] and co["p50_ms"] <= co["p95_ms"]
    assert res["speedup"] == pytest.approx(co["req_per_s"] / un["req_per_s"])
