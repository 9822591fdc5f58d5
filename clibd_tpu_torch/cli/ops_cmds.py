"""Operational commands: the port of `clibd_tpu/cli/ops_cmds.py`.

`serve` (`cmd_serve`, `:14-71`), the resident HTTP inference server, on one
device (the card unless `--device cpu` is passed); `--shard-keys` splits the
gallery over every local device of that type.  `doctor` (`:75-181`), the
deployment diagnostic, probes `--device` under a timeout; `configs` lists
the bundled experiment configs; `bench` runs `tools/bench.py`, the
throughput benchmark, on `--device`."""

from __future__ import annotations

import json
import os
import signal
import sys

import torch

from .common import _checkpoint_candidates, _dataset_hdf5_path, _load_cfg, _resolve_params


def cmd_serve(args, overrides) -> int:
    """Resident inference server (`engine/serve.py`): loads the checkpoint
    once, runs every bucketed forward once (`pre_warm`), then serves /embed
    and /search over HTTP with micro-batched forwards.  `--shard-keys`
    shards the gallery's rows over the local devices of `--device`'s type
    (`parallel.local_mesh`: every card, or the CPU).  The JAX package's
    `--compile-cache` (its XLA compilation cache) has no counterpart and is
    not a flag here."""
    from ..engine import serve
    from ..parallel.mesh import local_mesh

    cfg = _load_cfg(args, overrides)
    mc = cfg.model_config
    device = torch.device(args.device)
    keys_mesh = local_mesh(device.type) if args.shard_keys else None
    model = _resolve_params(cfg, device)
    # the image geometry of the checkpoint's image tower
    image_size = mc.clip.image_size if mc.backbone == "open_clip" else mc.image.vit.image_size
    service = serve.InferenceService(
        model, mc, keys_path=args.keys,
        buckets=tuple(b for b in (1, 2, 4, 8, 16, 32) if b <= args.max_batch),
        window_ms=args.window_ms, max_batch=args.max_batch,
        image_size=image_size, resize_to=round(image_size * 256 / 224),
        keys_mesh=keys_mesh, keys_dtype=args.keys_dtype, keys_rerank=args.keys_rerank,
        keys_selector=args.keys_selector, language_vocab=args.language_vocab,
        text_max_len=mc.language.max_len, max_queue=args.max_queue, device=device)
    if not args.no_warm:
        print("warming the bucketed forwards ...", flush=True)
        service.pre_warm()
    if args.reload_watch > 0:
        if not args.keys:
            service.close()
            print("--reload-watch needs --keys", file=sys.stderr)
            return 2
        service.start_reload_watch(args.reload_watch)
    server = serve.make_server(service, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(keys: {service.keys.n if service.keys else 'none'})", flush=True)

    # SIGTERM (an orchestrator's stop signal) → the same clean exit as
    # Ctrl-C: raised in the main thread, which is inside serve_forever
    def _terminate(signum, frame):
        raise KeyboardInterrupt

    prev_handler = signal.signal(signal.SIGTERM, _terminate)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        server.shutdown()
        server.server_close()
        service.close()
    return 0


def cmd_doctor(args, overrides) -> int:
    """Deployment diagnostic: device reachability (with a timeout: a hung
    driver or rendezvous blocks the first device call forever), native
    decoder availability, the process group's identity, and optionally the
    config / dataset / checkpoint resolution of an experiment.  One JSON
    object; rc 1 if any check fails."""
    import threading

    report: dict = {"python": sys.version.split()[0], "torch": torch.__version__}

    # the device probe runs in a daemon thread, so that an unreachable
    # device or rendezvous cannot hang the diagnostic
    probe: dict = {}

    def _probe():
        import time

        import torch.distributed as dist

        from ..parallel.mesh import _MULTIHOST_ENV_HINTS, maybe_initialize_distributed

        t0 = time.perf_counter()
        probe["distributed_hints"] = {
            k: os.environ[k] for k in _MULTIHOST_ENV_HINTS if os.environ.get(k)}
        # the sequence every other device command runs at startup:
        # rendezvous first, then the device
        probe["distributed"] = maybe_initialize_distributed(args.device)
        device = torch.device(args.device)
        probe["platform"] = device.type
        if device.type == "cuda":
            probe["device_count"] = torch.cuda.device_count()
            probe["device_name"] = torch.cuda.get_device_name(device)
        else:
            probe["device_count"] = 1
        probe["process_index"] = dist.get_rank() if dist.is_initialized() else 0
        probe["process_count"] = dist.get_world_size() if dist.is_initialized() else 1
        x = torch.ones((256, 256), device=device)
        float((x @ x).sum())  # a real device round trip
        probe["device_roundtrip_s"] = round(time.perf_counter() - t0, 3)
        if probe["distributed"]:
            dist.destroy_process_group()

    def _probe_guarded():
        try:
            _probe()
        except Exception as e:  # the failure goes into the report
            probe["exception"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=_probe_guarded, daemon=True)
    t.start()
    t.join(timeout=args.timeout)
    # keep what the probe recorded before it hung or failed: the
    # distributed hints are what explains a rendezvous hang
    if t.is_alive():
        report["device"] = {"status": "unreachable",
                            "detail": f"no response within {args.timeout}s "
                                      "(driver or rendezvous hang)", **probe}
    elif "device_roundtrip_s" not in probe:
        report["device"] = {"status": "error", **probe}
    else:
        report["device"] = {"status": "ok", **probe}

    try:
        from ..data.native import load_native_decoder, native_lib_path

        dec = load_native_decoder(build_if_missing=args.build_native)
        report["native_decoder"] = {
            "status": "ok" if dec is not None else "unavailable",
            "lib": native_lib_path(),
        }
    except Exception as e:  # a broken leg is reported, never raised
        report["native_decoder"] = {"status": "error", "detail": str(e)}

    if args.experiment:
        exp: dict = {}
        try:
            cfg = _load_cfg(args, overrides)
            exp["config"] = "ok"
            hdf5 = args.hdf5 or _dataset_hdf5_path(cfg)
            exp["hdf5"] = {"path": hdf5, "exists": bool(hdf5) and os.path.exists(hdf5)}
            # the chain `_resolve_params` walks, without loading
            from ..engine.checkpoint import resolve_checkpoint_path

            mc = cfg.model_config
            ckpt = None
            for cand in _checkpoint_candidates(cfg):
                ckpt = resolve_checkpoint_path(cand)
                if ckpt:
                    break
            exp["checkpoint"] = {"resolved": ckpt,
                                 "load_ckpt": mc.load_ckpt,
                                 "would_fresh_init": not (ckpt and mc.load_ckpt)}
        except Exception as e:
            exp["error"] = f"{type(e).__name__}: {e}"
        report["experiment"] = exp

    ok = report["device"]["status"] == "ok" and \
        report["native_decoder"]["status"] in ("ok", "unavailable") and \
        "error" not in report.get("experiment", {})
    report["status"] = "ok" if ok else "problems"
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


def cmd_configs(args, overrides) -> int:
    from ..config import available_configs

    for name in available_configs():
        print(name)
    return 0


def cmd_bench(args, overrides) -> int:
    """The throughput benchmark (`tools/bench.py`) on `--device`: the
    flagship at batch 256, one JSON line."""
    from ..tools.bench import BATCH, flagship_config, run_bench

    print(json.dumps(run_bench(flagship_config(), BATCH, args.device)))
    return 0
