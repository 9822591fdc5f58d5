# A copy of clibd_tpu/data/tokenizers.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""Tokenizers: vectorized DNA k-mer tokenization + self-contained WordPiece.

DNA parity target (reference bioscanclip/model/dna_encoder.py:53-63 and
bioscanclip/util/util.py:77-98): pad/truncate the barcode to 660 bases with
'N', split into non-overlapping 5-mers, map through a torchtext vocab built
from `product("ACGT", repeat=5)` with specials ["<MASK>", "<CLS>", "<UNK>"],
and prepend token id 0.  The resulting vocabulary is

    <MASK>=0, <CLS>=1, <UNK>=2, AAAAA=3, AAAAC=4, ..., TTTTT=4**5+2

(every k-mer occurs exactly once in the iterator, so torchtext keeps the
product() insertion order, i.e. base-4 counting with A<C<G<T).  Any k-mer
containing a non-ACGT character maps to <UNK>=2.

Instead of the reference's per-string Python loop (a CPU hot spot at 5M
scale, util/dataset.py:416-429), tokenization here is a single vectorized
NumPy computation over a [N, max_bp] byte matrix: id = 3 + Σ base_i·4^(k-1-i),
masked to <UNK> where any base is invalid — O(N·L) numpy ops, no Python loop
per sequence.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List, Sequence

import numpy as np

MASK_ID = 0
CLS_ID = 1
UNK_ID = 2
NUM_SPECIALS = 3

_BASE_LUT = np.full(256, 4, dtype=np.uint8)  # 4 = invalid
for i, b in enumerate(b"ACGT"):
    _BASE_LUT[b] = i


def dna_vocab_size(k: int = 5) -> int:
    return 4**k + NUM_SPECIALS


def kmer_vocab(k: int = 5) -> List[str]:
    """Full vocabulary list in id order (for docs/tests)."""
    from itertools import product

    return ["<MASK>", "<CLS>", "<UNK>"] + ["".join(p) for p in product("ACGT", repeat=k)]


def tokenize_dna_batch(
    barcodes: Sequence[str] | np.ndarray,
    k: int = 5,
    max_bp: int = 660,
    prepend_cls: bool = True,
) -> np.ndarray:
    """Tokenize a batch of DNA barcode strings.

    Returns int32 [N, 1 + max_bp//k] (or [N, max_bp//k] without the prepended
    id-0 token).  Matches the reference pipeline
    `lambda x: [0, *vocab(tokenizer(pad(x)))]` exactly.
    """
    n = len(barcodes)
    num_kmers = max_bp // k
    # Build a [N, max_bp] byte matrix, padding/truncating with 'N'.
    mat = np.full((n, max_bp), ord("N"), dtype=np.uint8)
    if isinstance(barcodes, np.ndarray) and barcodes.dtype.kind == "S":
        for i, s in enumerate(barcodes):
            b = s[:max_bp]
            mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    else:
        for i, s in enumerate(barcodes):
            if isinstance(s, bytes):
                b = s[:max_bp]
            else:
                b = s.encode("ascii", "replace")[:max_bp]
            mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)

    bases = _BASE_LUT[mat]  # [N, max_bp] in {0..3, 4=invalid}
    usable = bases[:, : num_kmers * k].reshape(n, num_kmers, k).astype(np.int32)
    invalid = (usable >= 4).any(axis=-1)
    powers = (4 ** np.arange(k - 1, -1, -1)).astype(np.int32)
    ids = NUM_SPECIALS + (usable * powers).sum(axis=-1)
    ids = np.where(invalid, UNK_ID, ids).astype(np.int32)
    if prepend_cls:
        out = np.empty((n, num_kmers + 1), dtype=np.int32)
        out[:, 0] = MASK_ID  # reference prepends literal id 0 (<MASK>)
        out[:, 1:] = ids
        return out
    return ids


def tokenize_dna(barcode: str, k: int = 5, max_bp: int = 660) -> np.ndarray:
    return tokenize_dna_batch([barcode], k=k, max_bp=max_bp)[0]


# ---------------------------------------------------------------------------
# Overlapping k-mer tokenizer (reference NewKmerTokenizer, util/util.py:101-126,
# 849-879: k=4, stride=1, specials ["[MASK]", "[UNK]"], used with the newer
# HF-style BarcodeBERT checkpoints).
# ---------------------------------------------------------------------------


def tokenize_dna_batch_overlapping(
    barcodes: Sequence[str],
    k: int = 4,
    stride: int = 1,
    max_bp: int = 660,
) -> tuple:
    """Returns (ids [N, (max_bp-k)//stride + 1], attention_mask [N, max_bp//stride])."""
    n = len(barcodes)
    mat = np.full((n, max_bp), ord("N"), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int64)
    for i, s in enumerate(barcodes):
        b = s.encode("ascii", "replace") if isinstance(s, str) else s
        b = b[:max_bp]
        lengths[i] = len(b)
        mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)

    num_tokens = (max_bp - k) // stride + 1
    bases = _BASE_LUT[mat].astype(np.int32)
    idx = np.arange(num_tokens)[:, None] * stride + np.arange(k)[None, :]
    windows = bases[:, idx]  # [N, num_tokens, k]
    invalid = (windows >= 4).any(axis=-1)
    powers = (4 ** np.arange(k - 1, -1, -1)).astype(np.int32)
    # specials here: [MASK]=0, [UNK]=1 then kmers
    ids = 2 + (windows * powers).sum(axis=-1)
    ids = np.where(invalid, 1, ids).astype(np.int32)

    # Reference quirk kept intentionally: the mask has max_bp//stride entries
    # (660) while ids has (max_bp-k)//stride+1 (657) — NewKmerTokenizer
    # (util/util.py:110-112) computes the mask against the padded sequence
    # length, not the token count.  Valid positions = len(x)//stride.
    mask_len = max_bp // stride
    att = (np.arange(mask_len)[None, :] < (lengths[:, None] // stride)).astype(np.int32)
    return ids, att


# ---------------------------------------------------------------------------
# WordPiece text tokenizer (BERT-uncased style), self-contained.
#
# The reference tokenizes "order family genus species" with the HF
# prajjwal1/bert-small tokenizer, padding="max_length", max_length=20,
# truncation=True (util/dataset.py:280-288).  That tokenizer is standard
# bert-base-uncased WordPiece; this implementation reproduces it from a
# vocab.txt file without any network/HF dependency.
# ---------------------------------------------------------------------------


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: dict | str,
        lowercase: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_chars_per_word: int = 100,
    ):
        if isinstance(vocab, str):
            vocab = load_vocab_txt(vocab)
        self.vocab = vocab
        self.lowercase = lowercase
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_chars_per_word = max_chars_per_word

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- basic tokenization (whitespace + punctuation split, accent strip) --
    def _basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        tokens: List[str] = []
        current = []
        for ch in text:
            if ch.isspace():
                if current:
                    tokens.append("".join(current))
                    current = []
            elif _is_punct(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
        return tokens

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_length: int = 20) -> dict:
        ids = [self.cls_id]
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        attention = [1] * len(ids)
        while len(ids) < max_length:
            ids.append(self.pad_id)
            attention.append(0)
        return {
            "input_ids": np.asarray(ids, dtype=np.int32),
            "token_type_ids": np.zeros(max_length, dtype=np.int32),
            "attention_mask": np.asarray(attention, dtype=np.int32),
        }

    def encode_batch(self, texts: Iterable[str], max_length: int = 20) -> dict:
        encs = [self.encode(t, max_length) for t in texts]
        return {
            k: np.stack([e[k] for e in encs]) for k in ("input_ids", "token_type_ids", "attention_mask")
        }


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def load_vocab_txt(path: str) -> dict:
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def taxonomy_text(order: str, family: str, genus: str, species: str) -> str:
    """The reference's language input: 'order family genus species'
    (util/dataset.py:152-155)."""
    return f"{order} {family} {genus} {species}"
