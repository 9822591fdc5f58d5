"""Core transformer layers: the port of `clibd_tpu/models/layers.py`.

Stateless layers are plain functions on tensors; `TransformerStack` is the
module that holds one tower's per-layer weights stacked `[L, ...]` exactly as
the JAX pytree does, and a Python loop over the layers replaces `lax.scan`.

Conventions kept from the reference so one weight set feeds both packages:
weights are stored `[in, out]` for `x @ W`, q/k/v are one fused `[D, 3D]`
projection, and matmuls run in `compute_dtype` with outputs in that dtype
(the counterpart of `preferred_element_type=compute_dtype`); bias adds are a
separate op, as in `layers.py:112-118`.  LayerNorm and softmax accumulate in
fp32.  `layernorm` is `ops.layernorm.layernorm`: the plain version on a CPU
tensor, one kernel forward and one backward on a CUDA tensor.

Attention dispatch: a key-only mask (or none) goes to
`ops.attention.flash_attention_qkv` -- the CUDA kernels on a CUDA tensor,
their plain versions on a CPU tensor, differentiable either way -- with the
TPU kernel's numerics (fp32 scores, bf16 P).  A query-dependent mask takes
the eager path, which keeps the reference XLA path's numerics (scores in
compute_dtype).

Parameters are trainable tensors; which of them train is set by
`models.clibd.set_trainable` (the JAX package's `trainable_mask`).
Rematerialisation (`transformer_stack(remat=...)`, `layers.py:269-297`) is
`torch.utils.checkpoint` of each block: `True` recomputes everything in the
backward, and a policy spec ("attn", "qkv", "mlp", "+"-joins, "dots") is
selective activation checkpointing that saves the named intermediates, which
the forward tags with `checkpoint_name` as the JAX code tags them.

Two opt-in kernels, read from the same environment variables as the
reference (`layers.py:49,61`) into module attributes that a test or a
measurement may set (`kernel_knobs`):
* `ATTN_FUSE_OUTPROJ` (`CLIBD_ATTN_FUSE_OUTPROJ=1`): the key-only-mask branch
  runs `ops.attention.flash_attention_qkv_outproj`, attention and
  out-projection in one kernel, its output tagged "attn_ctx";
* `MLP_IMPL` (`CLIBD_MLP_IMPL=pallas`): the MLP runs `ops.mlp.fused_mlp`,
  fc1, activation and fc2 in one kernel, its [B, N, D] output tagged
  "mlp_mid" (the intermediate never exists); the activation is gelu_tanh
  under fast math, else exact gelu, or quick_gelu (`layers.py:347-364`).

Deliberately absent (TPU-only): `ATTENTION_IMPL` / `flash_context` (the port
has one policy), `SCAN_UNROLL`, `vmem_safe_block_b` and the attention
`block_b`, and the TPU tiling knobs `CLIBD_ATTN_BLOCK_B`,
`CLIBD_MLP_ROWS_BLOCK` and `CLIBD_MLP_F_BLOCK`.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import flash_attention_qkv, flash_attention_qkv_outproj
from ..ops.layernorm import layernorm
from ..ops.mlp import fused_mlp

ATTN_FUSE_OUTPROJ = os.environ.get("CLIBD_ATTN_FUSE_OUTPROJ", "0") == "1"
MLP_IMPL = os.environ.get("CLIBD_MLP_IMPL", "xla")


@contextlib.contextmanager
def kernel_knobs(fuse_outproj: bool, mlp_impl: str):
    """Set `ATTN_FUSE_OUTPROJ` and `MLP_IMPL` for the code run inside, as
    the environment variables would at import."""
    global ATTN_FUSE_OUTPROJ, MLP_IMPL
    saved = ATTN_FUSE_OUTPROJ, MLP_IMPL
    ATTN_FUSE_OUTPROJ, MLP_IMPL = fuse_outproj, mlp_impl
    try:
        yield
    finally:
        ATTN_FUSE_OUTPROJ, MLP_IMPL = saved


BLOCK_KEYS = ("qkv_w", "qkv_b", "out_w", "out_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
              "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    if b is not None:
        y = y + b.to(compute_dtype)
    return y


def gelu(x: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """Exact erf GELU; fast=True is the tanh approximation."""
    return F.gelu(x, approximate="tanh" if fast else "none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


_ACTIVATIONS = {"gelu": gelu, "quick_gelu": quick_gelu}


def attention_mask_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """HF-style extended mask: [B, N] {0, 1} → additive [B, 1, 1, N] bias."""
    neg = torch.finfo(torch.float32).min
    return ((1.0 - attention_mask.float()) * neg)[:, None, None, :].to(dtype)


# The name of the intermediate the ops being dispatched produce, for the
# selective remat policies (per thread: autograd may recompute a block on
# its own device thread, which then sets the name itself).
_CHECKPOINT_NAME = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """The ops run inside produce the intermediate `name`: the counterpart
    of `jax.ad_checkpoint.checkpoint_name`.  Wrap only the op whose output is
    the named tensor, since a policy saves the output of every op inside."""
    prev = getattr(_CHECKPOINT_NAME, "name", None)
    _CHECKPOINT_NAME.name = name
    try:
        yield
    finally:
        _CHECKPOINT_NAME.name = prev


def _lora_delta(xc, a, b, compute_dtype):
    return torch.matmul(torch.matmul(xc, a.to(compute_dtype)), b.to(compute_dtype))


def fused_qkv_attention(
    x: torch.Tensor,
    qkv_w: torch.Tensor,
    qkv_b: torch.Tensor,
    out_w: torch.Tensor,
    out_b: torch.Tensor,
    num_heads: int,
    mask_bias: Optional[torch.Tensor] = None,
    lora: Optional[Dict[str, torch.Tensor]] = None,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Multi-head self-attention with fused QKV and optional LoRA on q/v
    (and k, for the q/k/v variant).  x [B, N, D]; mask_bias [B, 1, 1, N] or a
    query-dependent [., 1, N, N] additive bias."""
    B, N, D = x.shape
    head_dim = D // num_heads
    xc = x.to(compute_dtype)
    proj, bias = torch.matmul(xc, qkv_w.to(compute_dtype)), qkv_b.to(compute_dtype)
    with checkpoint_name("qkv"):
        qkv = proj + bias

    dq = dk = dv = None
    if lora is not None:
        dq = _lora_delta(xc, lora["a_q"], lora["b_q"], compute_dtype)
        dv = _lora_delta(xc, lora["a_v"], lora["b_v"], compute_dtype)
        if "a_k" in lora:
            dk = _lora_delta(xc, lora["a_k"], lora["b_k"], compute_dtype)

    key_only = mask_bias is None or (
        mask_bias.shape[0] == B and mask_bias.shape[1] == 1 and mask_bias.shape[2] == 1)
    if key_only:
        if lora is not None:
            qkv = qkv + torch.cat([dq, dk if dk is not None else torch.zeros_like(dq), dv], dim=-1)
        mask_row = None if mask_bias is None else mask_bias[:, 0, 0, :]
        qkv = qkv.contiguous()
        if ATTN_FUSE_OUTPROJ:
            w, b = out_w.to(compute_dtype), out_b.to(compute_dtype)
            with checkpoint_name("attn_ctx"):
                return flash_attention_qkv_outproj(qkv, w, b, num_heads, mask_row=mask_row)
        with checkpoint_name("attn_ctx"):
            ctx = flash_attention_qkv(qkv, num_heads, mask_row=mask_row)
        return torch.matmul(ctx, out_w.to(compute_dtype)) + out_b.to(compute_dtype)

    q, k, v = qkv.split(D, dim=-1)
    if lora is not None:
        q = q + dq
        v = v + dv
        if dk is not None:
            k = k + dk

    def split_heads(t):
        return t.reshape(B, N, num_heads, head_dim).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(head_dim))
    scores = scores + mask_bias.to(compute_dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(compute_dtype)
    ctx = torch.matmul(probs, v).transpose(1, 2)
    with checkpoint_name("attn_ctx"):
        ctx = ctx.reshape(B, N, D)
    return torch.matmul(ctx, out_w.to(compute_dtype)) + out_b.to(compute_dtype)


# Names a remat policy can elect to save (tagged above and in the MLP):
#   attn → "attn_ctx" [B,N,D]   the attention context (the flash forward's
#          output): without it the backward re-runs the forward kernel on
#          top of the backward kernel's own recompute of P
#   qkv  → "qkv"      [B,N,3D]  the fused qkv projection output
#   mlp  → "mlp_mid"  [B,N,F]   the post-GELU MLP intermediate
_REMAT_TAGS = {"attn": "attn_ctx", "qkv": "qkv", "mlp": "mlp_mid"}
# "dots": every matmul without batch dims (the projections), as XLA's
# dots_with_no_batch_dims_saveable
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy(spec):
    """A remat spec → the policy of selective activation checkpointing, or
    None for `True` (blanket remat: save nothing, recompute everything).
    "attn" / "qkv" / "mlp" or "+"-joined combinations save only those
    tagged intermediates; "dots" saves every projection matmul's output."""
    if spec is True:
        return None
    if spec == "dots":
        def saves(op):
            return op in _DOT_OPS
    else:
        try:
            names = tuple(_REMAT_TAGS[p] for p in str(spec).split("+"))
        except KeyError:
            raise ValueError(
                f"unknown remat policy {spec!r}: expected True, 'dots', or a "
                f"'+'-joined subset of {sorted(_REMAT_TAGS)}") from None

        def saves(op):
            return getattr(_CHECKPOINT_NAME, "name", None) in names

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if saves(op) else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


class TransformerStack(nn.Module):
    """One tower's blocks, weights stacked [L, ...] (`layers.py:300-399`):
    qkv_w [L,D,3D], qkv_b [L,3D], out_w [L,D,D], out_b [L,D], fc1_w [L,D,F],
    fc1_b [L,F], fc2_w [L,F,D], fc2_b [L,D], ln{1,2}_{scale,bias} [L,D]."""

    def __init__(self, num_layers: int, dim: int, mlp_dim: int):
        super().__init__()
        L, D, Fd = num_layers, dim, mlp_dim
        shapes = {
            "qkv_w": (L, D, 3 * D), "qkv_b": (L, 3 * D), "out_w": (L, D, D), "out_b": (L, D),
            "fc1_w": (L, D, Fd), "fc1_b": (L, Fd), "fc2_w": (L, Fd, D), "fc2_b": (L, D),
            "ln1_scale": (L, D), "ln1_bias": (L, D), "ln2_scale": (L, D), "ln2_bias": (L, D),
        }
        for name in BLOCK_KEYS:
            self.register_parameter(name, nn.Parameter(torch.zeros(shapes[name])))
        self.num_layers = L

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Trunc-normal 0.02 matrices, zero biases, unit LN scales
        (`init_stacked_block_params`)."""
        with torch.no_grad():
            for name in ("qkv_w", "out_w", "fc1_w", "fc2_w"):
                trunc_normal_(getattr(self, name), generator)
            for name in ("qkv_b", "out_b", "fc1_b", "fc2_b", "ln1_bias", "ln2_bias"):
                getattr(self, name).zero_()
            self.ln1_scale.fill_(1.0)
            self.ln2_scale.fill_(1.0)

    def forward(self, x, num_heads: int, pre_ln: bool, ln_eps: float,
                mask_bias=None, lora: Optional[nn.Module] = None,
                compute_dtype=torch.bfloat16, activation: str = "gelu",
                fast_math: bool = True, remat=False) -> torch.Tensor:
        return transformer_stack(
            {n: getattr(self, n) for n in BLOCK_KEYS}, x, num_heads, pre_ln, ln_eps,
            mask_bias=mask_bias, lora=None if lora is None else lora.stacked(),
            compute_dtype=compute_dtype, activation=activation, fast_math=fast_math,
            remat=remat)


def _unstack(stacked: Dict[str, torch.Tensor]) -> list:
    """{name: [L, ...]} → L dicts of per-layer views.  One unbind per tensor,
    so the backward stacks the L layer gradients once."""
    names = list(stacked)
    return [dict(zip(names, views)) for views in zip(*(stacked[n].unbind(0) for n in names))]


def transformer_stack(stacked: Dict[str, torch.Tensor], x: torch.Tensor, num_heads: int,
                      pre_ln: bool, ln_eps: float, mask_bias=None,
                      lora: Optional[Dict[str, torch.Tensor]] = None,
                      compute_dtype=torch.bfloat16, activation: str = "gelu",
                      fast_math: bool = True, remat=False) -> torch.Tensor:
    """Run the stacked blocks in order.  pre_ln: ViT/timm ordering; else BERT
    post-LN.  fast_math (bf16 only): tanh GELU and bf16 LN arithmetic.
    remat: False = no rematerialisation; True = checkpoint each block and
    recompute all of it in the backward; a policy spec (`remat_policy`) saves
    the named intermediates so the backward skips their recompute -- "attn"
    keeps the forward kernel from running again in the backward.  Policies
    never change the math, only what is stored."""
    fast = fast_math and compute_dtype != torch.float32
    act = (lambda t: gelu(t, fast=fast)) if activation == "gelu" else _ACTIVATIONS[activation]
    kernel_act = ("gelu_tanh" if fast else "gelu") if activation == "gelu" else activation

    def block(h, p, lo):
        def attn(inp):
            return fused_qkv_attention(inp, p["qkv_w"], p["qkv_b"], p["out_w"], p["out_b"],
                                       num_heads=num_heads, mask_bias=mask_bias, lora=lo,
                                       compute_dtype=compute_dtype)

        def mlp(inp):
            if MLP_IMPL == "pallas":
                args = [t.to(compute_dtype) for t in (inp, p["fc1_w"], p["fc1_b"], p["fc2_w"],
                                                      p["fc2_b"])]
                with checkpoint_name("mlp_mid"):
                    return fused_mlp(*args, activation=kernel_act)
            pre = linear(inp, p["fc1_w"], p["fc1_b"], compute_dtype)
            with checkpoint_name("mlp_mid"):
                hmid = act(pre)
            return linear(hmid, p["fc2_w"], p["fc2_b"], compute_dtype)

        if pre_ln:
            h = h + attn(layernorm(h, p["ln1_scale"], p["ln1_bias"], ln_eps, fast=fast))
            return h + mlp(layernorm(h, p["ln2_scale"], p["ln2_bias"], ln_eps, fast=fast))
        h = layernorm(h + attn(h), p["ln1_scale"], p["ln1_bias"], ln_eps, fast=fast)
        return layernorm(h + mlp(h), p["ln2_scale"], p["ln2_bias"], ln_eps, fast=fast)

    if remat:
        policy = remat_policy(remat)
        context_fn = (functools.partial(create_selective_checkpoint_contexts, policy)
                      if policy is not None else None)
        kwargs = {} if context_fn is None else {"context_fn": context_fn}

        def run(h, p, lo):
            return checkpoint(block, h, p, lo, use_reentrant=False, **kwargs)
    else:
        run = block
    layers = _unstack(stacked)
    lora_layers = [None] * len(layers) if lora is None else _unstack(lora)
    for p, lo in zip(layers, lora_layers):
        x = run(x, p, lo)
    return x


# ---------------------------------------------------------------------------
# Initialisers (torch.Generator counterparts of `layers.py:407-442`)
# ---------------------------------------------------------------------------


def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Normal(0, std) truncated at ±2 std, in place."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def uniform_(t: torch.Tensor, generator: torch.Generator, bound: float) -> torch.Tensor:
    return nn.init.uniform_(t, -bound, bound, generator=generator)


class Linear(nn.Module):
    """Weights [in, out] (+ bias [out]) under the names `w` / `b`."""

    def __init__(self, in_dim: int, out_dim: int, with_bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim)) if with_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch nn.Linear default: U(±1/sqrt(in)) for weight and bias."""
        bound = 1.0 / math.sqrt(self.w.shape[0])
        with torch.no_grad():
            uniform_(self.w, generator, bound)
            if self.b is not None:
                uniform_(self.b, generator, bound)

    def forward(self, x, compute_dtype=torch.bfloat16):
        return linear(x, self.w, self.b, compute_dtype)


class LayerNorm(nn.Module):
    """LN parameters under the names `scale` / `bias` (ones / zeros)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, eps: float, fast: bool = False):
        return layernorm(x, self.scale, self.bias, eps, fast=fast)
