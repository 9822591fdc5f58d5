"""Serve soak: live gallery writers and client load against a resident
server: the port of the repository's `tools/soak_serve.py`.

    python3 -m clibd_tpu_torch.tools.soak_serve --seconds 60 --clients 8   # the card
    python3 -m clibd_tpu_torch.tools.soak_serve --cpu --seconds 15         # a tiny model

The reference's backend appends embeddings to an HDF5 file that a consumer
reads (scripts/save_embedding/extract_embedding_for_backend.py); here the
consumer is the port's resident service (`engine/serve.InferenceService`
behind `make_server`, the body of `serve --reload-watch`).  A writer
subprocess cycles through the three patterns a gallery writer can use:

1. a long-lived appender (`AppendableEmbeddingWriter` + flush), the
   reference's own flow;
2. a truncate-in-place rewrite (h5py "w" on the live path), which the
   service's lock-free gallery reads must survive;
3. an atomic replace (write a temporary file, then `os.replace`).

Meanwhile client threads send /embed and /search over HTTP.  It passes
when the writer never errors, no request gets a 5xx or a network error,
the watcher reloads at least twice, and once the writer stops the served
gallery converges to the last row count written.  Prints one JSON verdict
line and exits 0 only when it passes.

On the card it serves the flagship's widths (ViT-B/16, BarcodeBERT, a
seeded fresh init); `--cpu` serves a tiny model on the CPU.  Needs h5py.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# one python -c program, parameterised by argv:
# soak_writer <path> <dim> <period_s> <duration_s> <n0>
# the duration counts from after the imports
_WRITER = r"""
import os, sys, time
import numpy as np
sys.path.insert(0, %(repo)r)
from clibd_tpu_torch.engine.extract import AppendableEmbeddingWriter, save_embedding_export

path, d, period, duration, n0 = (sys.argv[1], int(sys.argv[2]),
                                 float(sys.argv[3]), float(sys.argv[4]),
                                 int(sys.argv[5]))
deadline = time.time() + duration
n = n0 + 1  # every write changes the row count, so the served count
            # converging to FINAL is unambiguous against the first gallery
rng = np.random.default_rng(123)

def rows(k, start):
    f = rng.normal(size=(k, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    labels = [{lv: f"{lv}{start + i}" for lv in
               ("order", "family", "genus", "species")} for i in range(k)]
    return f, labels, [f"r{start + i}.jpg" for i in range(k)]

def full_payload(n):
    f, labels, names = rows(n, 0)
    return {"encoded_image_feature": f, "encoded_dna_feature": f[::-1].copy(),
            "encoded_language_feature": None, "label_list": labels,
            "file_name_list": names}

# phase 1: the reference's long-lived appender, flushed per batch so that
# the watcher sees the file grow while the handle stays open
w = AppendableEmbeddingWriter(path, d, compress=False)
f, labels, names = rows(n, 0)
w.append({"encoded_image_feature": f, "encoded_dna_feature": f[::-1].copy()},
         labels, names)
w.file.flush()
print("WROTE", n, flush=True)
appends = 0
while appends < 3 and time.time() < deadline:
    time.sleep(period)
    f, labels, names = rows(2, n)
    w.append({"encoded_image_feature": f,
              "encoded_dna_feature": f[::-1].copy()}, labels, names)
    w.file.flush()
    n += 2
    appends += 1
    print("WROTE", n, flush=True)
w.close()

# phase 2: truncate-in-place and atomic os.replace in turns until the deadline
i = 0
while time.time() < deadline:
    time.sleep(period)
    i += 1
    n += 1
    if i %% 2:
        save_embedding_export(path, full_payload(n), compress=False)
    else:
        save_embedding_export(path + ".tmp", full_payload(n), compress=False)
        os.replace(path + ".tmp", path)
    print("WROTE", n, flush=True)
print("FINAL", n, flush=True)
"""


def http_json(port: int, path: str, payload=None, timeout: float = 120.0):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def soak_config(cpu: bool):
    """The flagship's widths, or a tiny model for the CPU."""
    from ..config.schema import BertConfig, ExperimentConfig, ViTConfig

    cfg = ExperimentConfig()
    if cpu:
        cfg.output_dim = 16
        cfg.image.vit = ViTConfig(image_size=64, patch_size=16, hidden_size=32, num_layers=1,
                                  num_heads=4, mlp_dim=64)
        cfg.dna.bert = BertConfig(vocab_size=1027, hidden_size=32, num_layers=1, num_heads=4,
                                  intermediate_size=64, max_position_embeddings=140,
                                  with_mlm_head=True)
    return cfg


def soak(cpu: bool = False, seconds: float = 20.0, clients: int = 2, write_period: float = 1.5,
         watch_interval: float = 0.25, settle_seconds=None, workdir=None) -> dict:
    import torch

    from ..engine.extract import save_embedding_export
    from ..engine.serve import InferenceService, make_server
    from ..models.clibd import init_clibd_model
    from .bench_serve import make_jpeg

    device = torch.device("cpu" if cpu else "cuda")
    cfg = soak_config(cpu)
    image_size = cfg.image.vit.image_size
    d = cfg.output_dim
    workdir = workdir or tempfile.mkdtemp(prefix="clibd_soak_")
    gallery = os.path.join(workdir, "gallery.hdf5")
    rng = np.random.default_rng(0)
    n0 = 6
    feats = rng.normal(size=(n0, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    save_embedding_export(gallery, {
        "encoded_image_feature": feats, "encoded_dna_feature": feats[::-1].copy(),
        "encoded_language_feature": None,
        "label_list": [{lv: f"{lv}{i}" for lv in ("order", "family", "genus", "species")}
                       for i in range(n0)],
        "file_name_list": [f"f{i}.jpg" for i in range(n0)]}, compress=False)

    model = init_clibd_model(cfg, torch.Generator().manual_seed(0), device)
    svc = InferenceService(model, cfg, keys_path=gallery, window_ms=8.0, max_batch=8,
                           buckets=(1, 2, 4, 8), image_size=image_size,
                           resize_to=round(image_size * 256 / 224), device=device)
    svc.pre_warm()
    svc.start_reload_watch(watch_interval)
    server = make_server(svc, host="127.0.0.1", port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    writer = subprocess.Popen(
        [sys.executable, "-c", _WRITER % {"repo": REPO}, gallery, str(d), str(write_period),
         str(seconds), str(n0)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    # both pipes drained as they arrive: stdout starts the clients' clock
    # at the writer's first write, and an undrained stderr could fill its
    # pipe and stall the writer before its deadline
    writer_lines: list = []
    err_lines: list = []
    first_write = threading.Event()

    def pump_out() -> None:
        for line in writer.stdout:
            writer_lines.append(line)
            if line.startswith("WROTE"):
                first_write.set()
        first_write.set()  # EOF: never leave the parent waiting

    def pump_err() -> None:
        for line in writer.stderr:
            err_lines.append(line)

    pumps = [threading.Thread(target=pump_out, daemon=True),
             threading.Thread(target=pump_err, daemon=True)]
    for t in pumps:
        t.start()
    try:
        if not first_write.wait(timeout=300):
            raise RuntimeError("soak writer produced no output in 300s")
        deadline = time.time() + seconds
        jpegs = [make_jpeg(rng, image_size, image_size) for _ in range(4)]
        barcodes = ["".join(rng.choice(list("ACGT"), size=120)) for _ in range(4)]
        counts = {"ok": 0, "4xx": 0, "5xx": 0, "neterr": 0}
        lock = threading.Lock()

        def client(idx: int) -> None:
            i = 0
            while time.time() < deadline:
                i += 1
                b64 = base64.b64encode(jpegs[(idx + i) % 4]).decode()
                try:
                    if i % 2:
                        status, _ = http_json(port, "/embed", {"image_b64": b64,
                                                               "dna": barcodes[(idx + i) % 4]})
                    else:
                        status, _ = http_json(port, "/search", {"image_b64": b64, "k": 1})
                    key = "ok" if status < 400 else "4xx"
                except urllib.error.HTTPError as e:
                    key = "5xx" if e.code >= 500 else "4xx"
                except (urllib.error.URLError, OSError):
                    key = "neterr"
                with lock:
                    counts[key] += 1

        with ThreadPoolExecutor(max_workers=clients) as pool:
            list(pool.map(client, range(clients)))

        writer_hung = False
        try:
            writer.wait(timeout=120)
        except subprocess.TimeoutExpired:
            writer_hung = True  # a verdict (ok false) all the same
            writer.kill()
            writer.wait()
        for t in pumps:  # the pumps may lag the process's exit
            t.join(timeout=30)
        final = None
        for line in writer_lines:
            if line.startswith("FINAL"):
                final = int(line.split()[1])
        settle = settle_seconds if settle_seconds is not None else 10.0
        settle_by = time.time() + max(20 * watch_interval, settle)
        health = {}
        while time.time() < settle_by:
            time.sleep(watch_interval)
            _, health = http_json(port, "/healthz")
            if (final is not None and health.get("keys") == final
                    and health.get("reloads", 0) >= 2):
                break
    finally:
        if writer.poll() is None:
            writer.kill()
            writer.wait()
        server.shutdown()
        svc.close()

    ok = (not writer_hung and writer.returncode == 0 and final is not None
          and counts["5xx"] == 0 and counts["neterr"] == 0 and counts["ok"] > 0
          and health.get("keys") == final and health.get("reloads", 0) >= 2)
    verdict = {"ok": ok, "seconds": seconds, "clients": clients, "requests": counts,
               "reloads": health.get("reloads"), "final_keys_written": final,
               "final_keys_served": health.get("keys"), "writer_rc": writer.returncode,
               "writer_hung": writer_hung,
               "writer_err_tail": "".join(err_lines).strip().splitlines()[-3:],
               "stats": svc.stats.snapshot(), "device": device.type}
    print(json.dumps(verdict), flush=True)
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="a tiny model on the CPU")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--write-period", type=float, default=1.5)
    ap.add_argument("--watch-interval", type=float, default=0.25)
    ap.add_argument("--settle-seconds", type=float, default=None,
                    help="how long the served gallery may take to converge after the "
                         "writer stops (default 10)")
    ap.add_argument("--workdir", default=None,
                    help="the gallery's directory (default: a fresh temporary one)")
    args = ap.parse_args(argv)
    from ..utils.profiling import require_card

    require_card("soak_serve", "cpu" if args.cpu else "cuda")
    verdict = soak(args.cpu, args.seconds, args.clients, args.write_period, args.watch_interval,
                   args.settle_seconds, args.workdir)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
