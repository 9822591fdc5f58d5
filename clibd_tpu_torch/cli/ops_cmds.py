"""`serve`: the port of `clibd_tpu/cli/ops_cmds.py::cmd_serve` (`:14-71`), the
resident HTTP inference server, on one device (the card unless `--device
cpu` is passed); `--shard-keys` splits the gallery over every local device
of that type.  `doctor`, `configs` and `bench` are not ported yet."""

from __future__ import annotations

import signal
import sys

import torch

from .common import _load_cfg, _resolve_params


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
