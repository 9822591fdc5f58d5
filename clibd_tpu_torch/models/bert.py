"""Generic BERT encoder: the port of `clibd_tpu/models/bert.py`, serving both
BarcodeBERT (DNA, with the MLM head) and BERT-small (taxonomic text).

Word + position + token-type embeddings → LayerNorm → post-LN blocks, and
the optional MLM head (transform dense → GELU → LN → decoder).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import BertConfig
from .layers import LayerNorm, Linear, TransformerStack, attention_mask_bias, gelu, trunc_normal_
from .lora import Lora


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        D = cfg.hidden_size
        self.word = nn.Parameter(torch.zeros(cfg.vocab_size, D))
        self.position = nn.Parameter(torch.zeros(cfg.max_position_embeddings, D))
        self.token_type = nn.Parameter(torch.zeros(cfg.type_vocab_size, D))
        self.ln = LayerNorm(D)


class MLMHead(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.transform = Linear(dim, dim)
        self.ln = LayerNorm(dim)
        self.decoder = Linear(dim, out_dim)


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig, lora_rank: int = 0, head_dim: Optional[int] = None):
        """head_dim: output width of the MLM decoder (the reference replaces
        it by a Linear to output_dim for the DNA head); default vocab_size."""
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.embeddings = Embeddings(cfg)
        self.blocks = TransformerStack(cfg.num_layers, D, cfg.intermediate_size)
        self.mlm_head = (MLMHead(D, head_dim if head_dim is not None else cfg.vocab_size)
                         if cfg.with_mlm_head else None)
        self.lora = Lora(cfg.num_layers, D, lora_rank) if lora_rank > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """`init_bert_params`: trunc-normal embeddings, stacked blocks,
        torch-default MLM head linears, LoRA A uniform / B zero."""
        with torch.no_grad():
            for t in (self.embeddings.word, self.embeddings.position, self.embeddings.token_type):
                trunc_normal_(t, generator)
        self.blocks.reset_parameters(generator)
        if self.mlm_head is not None:
            self.mlm_head.transform.reset_parameters(generator)
            self.mlm_head.decoder.reset_parameters(generator)
        if self.lora is not None:
            self.lora.reset_parameters(generator)

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, compute_dtype=torch.bfloat16,
                fast_math: bool = True, remat=False) -> torch.Tensor:
        """`bert_encode` → last hidden states [B, N, D]."""
        cfg = self.cfg
        emb = self.embeddings
        N = input_ids.shape[1]
        x = emb.word[input_ids.long()] + emb.position[:N][None]
        if token_type_ids is None:
            x = x + emb.token_type[0][None, None]
        else:
            x = x + emb.token_type[token_type_ids.long()]
        fast = fast_math and compute_dtype != torch.float32
        if fast:
            x = emb.ln(x.to(compute_dtype), cfg.layernorm_eps, fast=True)
        else:
            x = emb.ln(x.float(), cfg.layernorm_eps).to(compute_dtype)
        mask_bias = None if attention_mask is None else attention_mask_bias(attention_mask)
        return self.blocks(x, num_heads=cfg.num_heads, pre_ln=False, ln_eps=cfg.layernorm_eps,
                           mask_bias=mask_bias, lora=self.lora, compute_dtype=compute_dtype,
                           fast_math=fast_math, remat=remat)

    def mlm_head_apply(self, hidden: torch.Tensor, compute_dtype=torch.bfloat16,
                       fast_math: bool = True) -> torch.Tensor:
        """HF BertForMaskedLM cls.predictions: dense → GELU → LN → decoder."""
        fast = fast_math and compute_dtype != torch.float32
        head = self.mlm_head
        h = gelu(head.transform(hidden, compute_dtype), fast=fast)
        h = head.ln(h, self.cfg.layernorm_eps, fast=fast)
        return head.decoder(h, compute_dtype)
