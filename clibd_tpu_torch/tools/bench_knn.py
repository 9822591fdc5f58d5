"""The eval grid's kNN at BIOSCAN-1M's shapes on one card: the port of the
repository's `tools/bench_knn.py`.

    python3 -m clibd_tpu_torch.tools.bench_knn [--seen 40000] [--unseen 8000] [--keys 21118]
        [--skip-full] [--int8] [--device cpu]

Synthetic 40,000 seen and 8,000 unseen queries against the 21,118-record
key gallery (BASELINE.md), 768-wide, over the whole `inference_and_eval`
grid: the 21 query x key cells of matching width x 2 splits = 42 searches
at k = 5 (the grid's k 1/3/5).  Reports the key upload and normalisation,
the device leg (prepared keys; each query matrix uploaded once, as the
grid does; fp32 products with TF32 off, then `top_k_lower_index_first`;
every search's result copied to the host) and then the whole
`inference_and_eval` with its metrics and predictions on the host, each
on the host clock after a device sync.

--int8: instead of the grid, the int8 gallery against fp32 at the eval
grid's shape (40,000 x 21,118) and a serving shape (256 queries x
1,000,000 keys), on clustered data so that label agreement is measurable:
fp32 and int8 search ms, the host re-rank's ms, recall@1 of int8 alone and
re-ranked against exact fp32, label agreement, the gallery's size.  The JAX
script's `--selector approx` (the TPU's approx_max_k) has no counterpart
here: the port selects exactly.

On the card it prints the card's name and power limit; `--device cpu` runs
it on the CPU, only when asked.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

Q_TYPES = ("encoded_image_feature", "encoded_dna_feature", "encoded_language_feature",
           "averaged_feature", "concatenated_feature")
K_TYPES = Q_TYPES + ("all_key_features",)


def synth_labels(n, rng, n_species=1000):
    sp = rng.integers(0, n_species, n)
    return [{"order": f"o{su % 10}", "family": f"f{su % 100}",
             "genus": f"g{su % 400}", "species": f"s{su}"} for su in sp]


def synth_grid(seen: int, unseen: int, keys: int, dim: int = 768, seed: int = 0) -> tuple:
    """(keys, seen, unseen) feature dicts as the JAX script draws them."""
    rng = np.random.default_rng(seed)

    def mat(n):
        return rng.standard_normal((n, dim), dtype=np.float32)

    def trio(n):
        img, dna, lang = mat(n), mat(n), mat(n)
        return {"encoded_image_feature": img, "encoded_dna_feature": dna,
                "encoded_language_feature": lang, "averaged_feature": (img + dna) / 2,
                "concatenated_feature": np.concatenate([img, dna], axis=1)}

    s, u, k = trio(seen), trio(unseen), trio(keys)
    k["all_key_features"] = np.concatenate([k["encoded_image_feature"],
                                            k["encoded_dna_feature"],
                                            k["encoded_language_feature"]])
    key_labels = synth_labels(keys, rng)
    s["label_list"] = synth_labels(seen, rng)
    u["label_list"] = synth_labels(unseen, rng)
    k["label_list"] = key_labels
    k["all_key_features_label"] = key_labels * 3
    return k, s, u


def grid_cells(keys: dict, seen: dict) -> list:
    """The (query type, key type) cells of matching width, in the grid's order."""
    return [(qt, kt) for qt in Q_TYPES for kt in K_TYPES
            if keys[kt].shape[1] == seen[qt].shape[1]]


def device_leg(keys, seen, unseen, device: torch.device | str = "cuda", chunk: int = 4096,
               k: int = 5) -> dict:
    """The grid's 42 searches on `device` → {prep_s, search_s, searches,
    scores, indices, sims}: indices[(split, qt, kt)] and sims[...] are that
    search's top-k."""
    from ..ops.knn import knn_search, prepare_keys

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    prep = {kt: prepare_keys(keys[kt], device=device) for kt in K_TYPES}
    sync()
    t_prep = time.perf_counter() - t0
    knn_search(seen[Q_TYPES[0]][:chunk], prep[Q_TYPES[0]], k=k, query_chunk=chunk,
               keys_normalized=True)  # warm-up
    cells = grid_cells(keys, seen)
    out, sims, n_scores = {}, {}, 0
    t0 = time.perf_counter()
    dev_q = {}  # one upload per (split, query type), as inference_and_eval
    for qt, kt in cells:
        for name, split in (("seen", seen), ("unseen", unseen)):
            if (name, qt) not in dev_q:
                dev_q[(name, qt)] = torch.from_numpy(split[qt]).to(device)
            sim, idx = knn_search(dev_q[(name, qt)], prep[kt], k=k, query_chunk=chunk,
                                  keys_normalized=True)
            out[(name, qt, kt)], sims[(name, qt, kt)] = idx, sim
            n_scores += split[qt].shape[0] * keys[kt].shape[0]
    sync()
    return {"prep_s": t_prep, "search_s": time.perf_counter() - t0, "searches": 2 * len(cells),
            "scores": n_scores, "indices": out, "sims": sims}


def subset_on_cpu(keys, seen, unseen, rows: int, chunk: int = 4096, k: int = 5) -> tuple:
    """The same searches for the first `rows` queries of each split on the
    CPU → (`device_leg`'s result for them, seconds)."""
    head = {n: {qt: s[qt][:rows] for qt in Q_TYPES} for n, s in (("seen", seen),
                                                                  ("unseen", unseen))}
    t0 = time.perf_counter()
    res = device_leg(keys, head["seen"], head["unseen"], "cpu", chunk=chunk, k=k)
    return res, time.perf_counter() - t0


def near_tie_check(keys, seen, unseen, got: dict, want: dict, rows: int,
                   tol: float = 1e-5) -> dict:
    """The first `rows` queries' top-k of `got` (a `device_leg` result)
    against `want` (the same searches, another device): the scores agree
    within `tol` at every rank, and where the indices differ the key `got`
    put there scores (fp64, on the host) within `tol` of `want`'s score at
    that rank: an order of near-equal scores that fp32 sums in another
    order may flip → {rows_differing, max_score_diff, ok}."""
    splits = {"seen": seen, "unseen": unseen}
    differing, max_diff, ok = 0, 0.0, True
    for cell, idx in want["indices"].items():
        name, qt, kt = cell
        g_idx, g_sim = got["indices"][cell][:rows], got["sims"][cell][:rows]
        w_sim = want["sims"][cell][:rows]
        max_diff = max(max_diff, float(np.abs(g_sim - w_sim).max()))
        bad = np.nonzero((g_idx != idx[:rows]).any(axis=1))[0]
        differing += len(bad)
        if len(bad):
            q = splits[name][qt][bad].astype(np.float64)
            kk = keys[kt][g_idx[bad]].astype(np.float64)  # [rows, k, D]
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            kk /= np.linalg.norm(kk, axis=2, keepdims=True)
            exact = np.einsum("rd,rkd->rk", q, kk)
            ok &= bool(np.abs(exact - w_sim[bad]).max() <= tol)
    ok &= max_diff <= tol
    return {"rows_differing": differing, "max_score_diff": max_diff, "ok": ok}


def full_leg(keys, seen, unseen, device: torch.device | str = "cuda",
             chunk: int = 4096) -> tuple:
    """`inference_and_eval` over the whole grid → (acc_dict, seconds)."""
    from ..engine.evaluate import inference_and_eval

    device = torch.device(device)
    t0 = time.perf_counter()
    acc_dict, _, _ = inference_and_eval(keys, seen, unseen, k_list=(1, 3, 5), query_chunk=chunk,
                                        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return acc_dict, time.perf_counter() - t0


def bench_int8(d: int = 768, device: torch.device | str = "cuda", shapes=None) -> list:
    """The int8 gallery against fp32 (clustered synthetic data) at each
    (queries, keys, label) of `shapes` → one row each."""
    from ..ops.knn import knn_search, prepare_keys, rerank_candidates

    device = torch.device(device)
    shapes = shapes or ((40000, 21118, "eval-grid shape (40k q x 21k keys)"),
                        (256, 1000000, "serving shape (256 q x 1M keys)"))
    rows = []
    for nq, nk, label in shapes:
        rng = np.random.default_rng(0)
        centers = rng.standard_normal((2000, d)).astype(np.float32)
        key_cluster = rng.integers(0, 2000, nk)
        keys = centers[key_cluster] + 0.2 * rng.standard_normal((nk, d)).astype(np.float32)
        queries = (centers[rng.integers(0, 2000, nq)]
                   + 0.2 * rng.standard_normal((nq, d)).astype(np.float32))

        def best(fn, reps=2):
            t = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                res = fn()
                t = min(t, time.perf_counter() - t0)
            return res, t

        prep32 = prepare_keys(keys, device=device)
        knn_search(queries, prep32, k=5, keys_normalized=True, device=device)
        (_, i32), t32 = best(lambda: knn_search(queries, prep32, k=5, keys_normalized=True,
                                                device=device))
        qk = prepare_keys(keys, device=device, dtype="int8")
        knn_search(queries, qk, k=20, device=device)
        (_, cand), t8 = best(lambda: knn_search(queries, qk, k=20, device=device))
        t0 = time.perf_counter()
        _, i_rr = rerank_candidates(queries, cand, keys, k=5)
        t_rr = time.perf_counter() - t0
        row = {"label": label, "fp32_ms": t32 * 1e3, "int8_ms": t8 * 1e3,
               "rerank_ms": t_rr * 1e3,
               "recall1_raw": float(np.mean(cand[:, 0] == i32[:, 0])),
               "recall1_reranked": float(np.mean(i_rr[:, 0] == i32[:, 0])),
               "label_agree_raw": float(np.mean(key_cluster[cand[:, 0]]
                                                == key_cluster[i32[:, 0]])),
               "gallery_gb": (nk * d * 4 / 1e9, nk * (d + 4) / 1e9)}
        rows.append(row)
        print(f"{label}: fp32 {row['fp32_ms']:.1f} ms | int8 {row['int8_ms']:.1f} ms | host "
              f"rerank {row['rerank_ms']:.1f} ms | idx recall@1 raw {row['recall1_raw']:.4f} "
              f"reranked {row['recall1_reranked']:.4f} | raw label agree "
              f"{row['label_agree_raw']:.4f} | gallery {row['gallery_gb'][0]:.2f} GB -> "
              f"{row['gallery_gb'][1]:.2f} GB", flush=True)
        del prep32, qk
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seen", type=int, default=40000)
    ap.add_argument("--unseen", type=int, default=8000)
    ap.add_argument("--keys", type=int, default=21118)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--skip-full", action="store_true",
                    help="only the device leg (the host's metrics are slow)")
    ap.add_argument("--int8", action="store_true",
                    help="instead of the grid: the int8 gallery against fp32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.profiling import require_card

    require_card("bench_knn", args.device)
    if args.int8:
        return bench_int8(args.dim, args.device)
    keys, seen, unseen = synth_grid(args.seen, args.unseen, args.keys, args.dim)
    dev = device_leg(keys, seen, unseen, args.device, chunk=args.chunk)
    gscores = dev["scores"] / 1e9
    print(f"key upload+normalize (6 matrices): {dev['prep_s']:.3f}s", flush=True)
    print(f"device kNN grid: {dev['searches']} searches in {dev['search_s']:.3f}s "
          f"({gscores:.2f}G scores, ~{2 * dev['scores'] * args.dim / dev['search_s'] / 1e12:.2f} "
          f"TF/s)", flush=True)
    result = {"device": dev}
    if not args.skip_full:
        acc_dict, t_full = full_leg(keys, seen, unseen, args.device, args.chunk)
        print(f"full inference_and_eval (metrics+preds on host): {t_full:.3f}s (device leg was "
              f"{dev['search_s']:.3f}s -> host overhead {t_full - dev['search_s']:.1f}s)",
              flush=True)
        print(f"grid cells: {sum(len(v) for v in acc_dict.values())}")
        result.update(acc_dict=acc_dict, full_s=t_full)
    return result


if __name__ == "__main__":
    main()
