# A copy of clibd_tpu/data/builders_5m.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""BIOSCAN-5M-scale HDF5 builders: multiprocessing image ingestion, chunked
resizable writes, resume support, and the 1M-split-on-5M re-slicer.

Reference equivalents (scripts/data_processing/):
- generate_hdf5_file_5m.py:1-338 (+ _small_5m, multiprocessing pool variants):
  Pool over image read/encode, skip-bad-images (:79-86), chunked appends
  (`add_new_info_to_the_dataset`, :93-101);
- create_hdf5_5M_data_with_1m_split.py:1-101: build a new HDF5 holding the
  1M pretrain split's records found inside the 5M file.

TPU-framework notes: this is pure host tooling. Unlike the reference, rows
stream through a fixed-size chunk pipeline (a 5M build never materializes a
split in RAM), image byte columns grow their padded width on demand
(maxshape=(None, None) resize), and a per-group `rows_written` cursor makes
interrupted builds resumable.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import h5py
import numpy as np

from .builders import LEVELS, read_image_bytes
from .tokenizers import WordPieceTokenizer, taxonomy_text

_STR = h5py.special_dtype(vlen=bytes)


def _read_one(args: Tuple[int, str, bool]) -> Tuple[int, Optional[bytes]]:
    idx, path, validate = args
    return idx, read_image_bytes(path, validate=validate)


class ChunkedSplitWriter:
    """Appends rows to one split group with resizable datasets.

    Columns: image [N, W] uint8 (W grows on demand) + image_mask [N],
    barcode/order/family/genus/species/sampleid/processid/image_file vlen
    bytes, optional pre-tokenized language_tokens_* [N, text_max_len].
    `rows_written` group attr = resume cursor.
    """

    def __init__(self, f: h5py.File, split: str,
                 tokenizer: Optional[WordPieceTokenizer] = None,
                 text_max_len: int = 20, compression: Optional[str] = None):
        self.tokenizer = tokenizer
        self.text_max_len = text_max_len
        kw = {"compression": compression} if compression else {}
        if split in f:
            self.g = f[split]
        else:
            g = f.create_group(split)
            g.create_dataset("image", shape=(0, 1), maxshape=(None, None),
                             dtype=np.uint8, chunks=(64, 4096), **kw)
            g.create_dataset("image_mask", shape=(0,), maxshape=(None,),
                             dtype=np.int64, chunks=(4096,), **kw)
            for name in ("barcode", "sampleid", "processid", "image_file") + LEVELS:
                g.create_dataset(name, shape=(0,), maxshape=(None,),
                                 dtype=_STR, chunks=(4096,), **kw)
            if tokenizer is not None:
                for name in ("input_ids", "token_type_ids", "attention_mask"):
                    g.create_dataset(f"language_tokens_{name}",
                                     shape=(0, text_max_len),
                                     maxshape=(None, text_max_len),
                                     dtype=np.int64, chunks=(4096, text_max_len), **kw)
            g.attrs["rows_written"] = 0
            self.g = g

    @property
    def rows_written(self) -> int:
        return int(self.g.attrs.get("rows_written", 0))

    def truncate(self, n_rows: int) -> None:
        """Roll back to the first n_rows (crash-recovery: a chunk appended
        whose bookkeeping never landed must be dropped, not duplicated)."""
        g = self.g
        for name, ds in g.items():
            ds.resize((n_rows,) + ds.shape[1:])
        g.attrs["rows_written"] = n_rows

    def append(self, records: Dict[str, Sequence], jpeg_bytes: List[bytes]) -> None:
        n = len(jpeg_bytes)
        if n == 0:
            return
        g = self.g
        start = g["image"].shape[0]
        width = max((len(b) for b in jpeg_bytes), default=1)
        new_w = max(g["image"].shape[1], width)
        g["image"].resize((start + n, new_w))
        block = np.zeros((n, new_w), dtype=np.uint8)
        mask = np.zeros(n, dtype=np.int64)
        for i, b in enumerate(jpeg_bytes):
            block[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            mask[i] = len(b)
        g["image"][start:] = block
        g["image_mask"].resize((start + n,))
        g["image_mask"][start:] = mask

        for name in ("barcode", "sampleid", "processid", "image_file") + LEVELS:
            col = records[name]
            ds = g[name]
            ds.resize((start + n,))
            ds[start:] = [str(v).encode("utf-8") for v in col]

        if self.tokenizer is not None:
            texts = [taxonomy_text(records["order"][i], records["family"][i],
                                   records["genus"][i], records["species"][i])
                     for i in range(n)]
            toks = self.tokenizer.encode_batch(texts, max_length=self.text_max_len)
            for name in ("input_ids", "token_type_ids", "attention_mask"):
                ds = g[f"language_tokens_{name}"]
                ds.resize((start + n, self.text_max_len))
                ds[start:] = toks[name].astype(np.int64)

        g.attrs["rows_written"] = start + n


def build_split_hdf5_parallel(
    output_path: str,
    metadata,  # pandas DataFrame: split column + record fields
    image_dir: str,
    split_column: str = "split",
    image_file_column: str = "image_file",
    tokenizer: Optional[WordPieceTokenizer] = None,
    split_name_map: Optional[Dict[str, str]] = None,
    compression: Optional[str] = None,
    chunk_size: int = 4096,
    num_processes: Optional[int] = None,
    resume: bool = False,
    validate_images: bool = True,
    log_every: int = 1,
    use_threads: bool = False,
) -> dict:
    """5M-scale build: per-split chunked streaming; each chunk's image reads
    fan out over a multiprocessing Pool (reference image_process, pool over
    process_batch_of_images_to_bytes); bad images skipped with a warning.

    resume=True re-opens output_path and continues each split after its
    `rows_written` cursor (crash-safe restarts at chunk granularity).
    use_threads=True swaps the process pool for threads (useful under pytest
    or when the workload is IO-bound).  Returns {"records": n, "skipped": k,
    "records_per_s": r}.
    """
    split_name_map = split_name_map or {}
    if num_processes is None:
        num_processes = max(os.cpu_count() or 1, 1)
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)

    if use_threads or num_processes == 1:
        from concurrent.futures import ThreadPoolExecutor as PoolCls

        def run_pool(fn, args):
            with PoolCls(max_workers=num_processes) as pool:
                return list(pool.map(fn, args))
    else:
        # forkserver: plain fork() from a multi-threaded parent (e.g. under a
        # prefetching loader or pytest) risks deadlocks in the child
        from multiprocessing import get_context

        ctx = get_context("forkserver")

        def run_pool(fn, args):
            with ctx.Pool(processes=num_processes) as pool:
                return pool.map(fn, args, chunksize=64)

    mode = "a" if (resume and os.path.exists(output_path)) else "w"
    total = skipped = 0
    t0 = time.time()
    with h5py.File(output_path, mode) as f:
        for split_value, frame in metadata.groupby(split_column):
            group_name = split_name_map.get(str(split_value), str(split_value))
            writer = ChunkedSplitWriter(f, group_name, tokenizer=tokenizer,
                                        compression=compression)
            rows = frame.reset_index(drop=True)
            n_chunks = -(-len(rows) // chunk_size)
            # resume bookkeeping: chunks over the source frame are
            # deterministic; `written_per_chunk` records how many rows each
            # ingested chunk contributed (skips make counts differ), so a
            # restarted build continues at the first missing chunk
            written_per_chunk = list(writer.g.attrs.get("written_per_chunk", []))
            # chunk numbering is only meaningful for the chunk_size it was
            # written with — resuming with a different size would silently
            # skip or duplicate source rows
            stored_cs = writer.g.attrs.get("resume_chunk_size")
            if resume and written_per_chunk and stored_cs is not None \
                    and int(stored_cs) != chunk_size:
                raise ValueError(
                    f"[{group_name}] resume with chunk_size={chunk_size} but the "
                    f"interrupted build used {int(stored_cs)}; rerun with "
                    f"chunk_size={int(stored_cs)} (or rebuild from scratch)")
            writer.g.attrs["resume_chunk_size"] = chunk_size
            if resume:
                # a crash during/after append() but before the bookkeeping
                # write leaves rows (possibly with unevenly-resized columns)
                # that no chunk entry accounts for — trim back to consistency
                consistent = int(sum(written_per_chunk))
                actual = max(int(ds.shape[0]) for ds in writer.g.values())
                if actual > consistent:
                    print(f"[{group_name}] trimming {actual - consistent} "
                          f"rows from an unbookkept chunk before resuming", flush=True)
                    writer.truncate(consistent)
            for c in range(n_chunks):
                if resume and c < len(written_per_chunk):
                    continue  # already ingested
                chunk = rows.iloc[c * chunk_size:(c + 1) * chunk_size]
                args = [
                    (i, os.path.join(image_dir, chunk.iloc[i][image_file_column]), validate_images)
                    for i in range(len(chunk))
                ]
                results = run_pool(_read_one, args)
                keep_idx = [i for i, b in results if b is not None]
                jpegs = dict(results)
                skipped += len(chunk) - len(keep_idx)
                kept = chunk.iloc[keep_idx]

                def col(*names, default=""):
                    for name in names:
                        if name in kept.columns:
                            return list(kept[name])
                    return [default] * len(kept)

                records = {
                    "barcode": col("barcode", "nucraw"),
                    "sampleid": col("sampleid"),
                    "processid": col("processid", "sampleid"),
                    "image_file": list(kept[image_file_column]),
                }
                for level in LEVELS:
                    records[level] = col(level, default="not_classified")
                writer.append(records, [jpegs[i] for i in keep_idx])
                written_per_chunk.append(len(keep_idx))
                writer.g.attrs["written_per_chunk"] = written_per_chunk
                total += len(keep_idx)
                f.flush()
                if log_every and (c + 1) % log_every == 0:
                    dt = time.time() - t0
                    print(f"[{group_name}] chunk {c + 1}/{n_chunks}: "
                          f"{total} records ({total / max(dt, 1e-9):.0f}/s)",
                          flush=True)
    dt = time.time() - t0
    return {"records": total, "skipped": skipped,
            "records_per_s": round(total / max(dt, 1e-9), 1)}


def create_hdf5_with_subset_split(
    source_path: str,
    output_path: str,
    sampleids_per_split: Dict[str, Sequence[str]],
    source_split: str = "no_split_and_seen_train",
    chunk_size: int = 8192,
) -> dict:
    """Re-slice a big HDF5 into a new file whose groups hold the given
    sampleids (reference create_hdf5_5M_data_with_1m_split.py:15-74: find the
    1M pretrain split's sampleids inside the 5M file, copy those rows).

    Rows are located by sampleid within `source_split` and copied column-by-
    column in index-sorted chunks (HDF5 fancy indexing needs sorted indices;
    row order in the output follows source order, like the reference's
    key_to_index mapping).
    """
    counts = {}
    with h5py.File(source_path, "r") as src, h5py.File(output_path, "w") as dst:
        g = src[source_split]
        src_ids = [s.decode() if isinstance(s, bytes) else str(s)
                   for s in g["sampleid"][...]]
        id_to_idx = {s: i for i, s in enumerate(src_ids)}
        for split, ids in sampleids_per_split.items():
            idx = np.array(sorted(id_to_idx[s] for s in ids if s in id_to_idx))
            out = dst.create_group(split)
            for name, ds in g.items():
                if idx.size == 0:
                    shape = (0,) + ds.shape[1:]
                    out.create_dataset(name, shape=shape, dtype=ds.dtype)
                    continue
                parts = [ds[idx[lo:lo + chunk_size].tolist()]
                         for lo in range(0, len(idx), chunk_size)]
                out.create_dataset(name, data=np.concatenate(parts, axis=0))
            counts[split] = int(idx.size)
    return counts
