"""The port's hand-written CUDA kernels on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither jax nor `tests/conftest.py`'s fixtures, so it runs on a machine that
has PyTorch for CUDA and no jax:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q

Each kernel (the attention forward and backward, the attention with its
out-projection fused in, the fused MLP, and the chip-probe kernels: the
scale copy, the tiled GEMM at every tile, the attention from separate
q, k, v; the fused-qkv schedules of tools/exp_flash.py: the phased and
batched forwards, the phased backward) is held against its plain PyTorch version (which the CPU tests hold against clibd_tpu) at the slices' shapes,
and a tiny model on the card against the same model on the CPU, in
extraction and in a training step, and with both opt-in kernels on.
"""

import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from clibd_tpu_torch.config import BertConfig, ExperimentConfig, ViTConfig
from clibd_tpu_torch.models import clibd_apply, init_clibd_model
from clibd_tpu_torch.models.layers import kernel_knobs
from clibd_tpu_torch.ops import attention, elementwise, gemm
from clibd_tpu_torch.ops.attention import (
    attention_bhnd,
    attention_bhnd_reference,
    flash_attention_qkv,
    flash_attention_qkv_batched,
    flash_attention_qkv_bwd,
    flash_attention_qkv_bwd_phased,
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_outproj,
    flash_attention_qkv_outproj_reference,
    flash_attention_qkv_phased,
    flash_attention_qkv_reference,
    phased_smem_bytes,
)
from clibd_tpu_torch.ops.elementwise import scale_copy
from clibd_tpu_torch.ops.gemm import OUT_DTYPES, TILES, tiled_matmul, tiled_matmul_reference
from clibd_tpu_torch.ops.mlp import fused_mlp, fused_mlp_reference

NEG = np.finfo(np.float32).min
# Both sides round P and V to bf16 after fp32 maths; a probability within
# float noise of a bf16 rounding boundary may round the other way: one bf16
# ulp of P (2^-8 of p <= 1) times |v| (< 5 for these normal inputs).
FP32_ATOL = 2e-2
# bf16 qkv: the output itself is bf16, so one bf16 ulp of |out| (< 4) on top.
BF16_ATOL = 4e-2
# unit-norm fp32 embeddings of a 2-layer model, card against CPU: float noise
# plus the rare P rounding flip above, as in test_torch_extract_eval.py
EMB_ATOL = 1e-3
# bf16 on the card against bf16 on the CPU: the same rounding points, other
# accumulation orders in the GEMMs
BF16_COSINE_MIN = 0.99
# backward kernel against its plain version, per part (dq, dk, dv): both round
# P, dS and the inputs to bf16 at the same points, so they differ where a
# value within float noise of a bf16 boundary rounds the other way, and by
# the bf16 rounding of the output itself; bounded relative to the part's
# largest entry
BWD_REL_TOL = 2e-2
# out-projection and fused MLP against their plain versions, relative to the
# output's largest entry: both round at the same points (P, ctx, h to bf16),
# so they differ by rounding flips of values within float noise of a bf16
# boundary and by the bf16 rounding of the output itself
FUSED_REL_TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, N, H, masked, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * 64)).astype(np.float32)
    mask = None
    if masked:
        keep = rng.random((B, N)) > 0.3
        keep[:, 0] = True
        keep[0] = False  # batch row 0: every key masked
        mask = np.where(keep, 0.0, NEG).astype(np.float32)
    return qkv, mask


# (B, N, H) edges of the forward kernel: one key; a 64-key block one short,
# whole and one past, at one, two and four blocks; the overlap tower's N;
# B = 1 and odd B, H = 1, 8 and 12 (as chip_smoke.py's FWD_EDGES)
FWD_EDGES = [(1, 1, 1), (3, 63, 8), (5, 64, 12), (1, 65, 1), (3, 127, 8), (5, 128, 12),
             (1, 129, 1), (3, 256, 8), (5, 257, 12), (1, 657, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,masked", [(8, 197, 12, False), (8, 133, 12, False),
                                           (8, 20, 8, True), (8, 657, 12, True)]
                         + [(B, N, H, masked) for B, N, H in FWD_EDGES for masked in (False, True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_version(cuda_device, B, N, H, masked, dtype):
    qkv, mask = _inputs(B, N, H, masked, seed=N)
    t = torch.from_numpy(qkv).to(cuda_device, dtype)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = flash_attention_qkv.launches
    got = flash_attention_qkv(t, H, m)
    torch.cuda.synchronize()
    assert flash_attention_qkv.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, N, H * 64)
    want = flash_attention_qkv_reference(t, H, m).float()
    err = float((got.float() - want).abs().max())
    assert err <= (FP32_ATOL if dtype == torch.float32 else BF16_ATOL), err


def test_chip_smoke_holds_the_forward_kernel_to_the_wgmma_ptxas_limits():
    """chip_smoke.py's build phase checks the forward kernel's ptxas report
    (stack bytes, no C7519) with the other wgmma attention kernels; read
    from the file with ast, which runs nothing."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    sources = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "WGMMA_ATTENTION_SOURCES"
                           for t in node.targets))
    assert "flash_attention_qkv" in sources
    assert {"flash_attention_qkv_phased", "flash_attention_qkv_batched", "attention_bhnd",
            "flash_attention_qkv_bwd_phased", "flash_attention_qkv_bwd"} <= set(sources)


def test_chip_smoke_holds_the_backward_at_its_edges_and_records():
    """chip_smoke.py's backward checks: BWD_EDGES (read with ast) take
    either side of the whole-row route's 208 keys and every N the forward's
    edges take, at B = 1, 3, 5 and H = 1, 8, 12; BWD_RECORDED_MS holds the
    mma.sync design's times at the four shapes of the phase."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if getattr(t, "id", None) in ("BWD_EDGES", "BWD_RECORDED_MS", "SHAPES")}
    edges = consts["BWD_EDGES"]
    Ns = {N for _, N, _ in edges}
    assert {207, 208, 209} <= Ns and {N for _, N, _ in FWD_EDGES} <= Ns | {300} and 300 in Ns
    assert {B for B, _, _ in edges} == {1, 3, 5} and {H for _, _, H in edges} == {1, 8, 12}
    assert set(consts["BWD_RECORDED_MS"]) == {name for name, *_ in consts["SHAPES"]}
    assert consts["BWD_RECORDED_MS"]["vit"] == 2.2553


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    ok = torch.zeros(2, 5, 3 * 128, device=cuda_device, dtype=torch.bfloat16)
    before = flash_attention_qkv.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_qkv(torch.zeros(2, 5, 3 * 96, device=cuda_device), 1)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_qkv(ok.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_qkv(ok.transpose(0, 1), 2)
    with pytest.raises(ValueError, match="mask"):
        flash_attention_qkv(ok, 2, torch.zeros(2, 5))
    assert flash_attention_qkv.launches == before
    # the keys stream in tiles: a long sequence (the overlap DNA tower's) is taken
    long = torch.zeros(1, 657, 3 * 64, device=cuda_device, dtype=torch.bfloat16)
    assert torch.equal(flash_attention_qkv(long, 1), torch.zeros(1, 657, 64, device=cuda_device,
                                                                 dtype=torch.bfloat16))
    assert flash_attention_qkv.launches == before + 1


@pytest.mark.cuda
def test_knn_breaks_ties_lower_index_first_on_the_card(cuda_device):
    """kNN on the card with every key three times (keys i, i + 7, i + 14):
    of equal scores the lower key index first, as jax.lax.top_k orders
    them, for k from 1 to 8 (each the first k of the whole ranking, so a
    tie across the k-th place keeps its lower indices), and a query equal
    to a key finds its three copies in index order."""
    from clibd_tpu_torch.ops.knn import knn_search

    rng = np.random.default_rng(7)
    rows = rng.standard_normal((7, 64)).astype(np.float32)
    keys = torch.from_numpy(np.concatenate([rows, rows, rows])).to(cuda_device)
    queries = torch.from_numpy(np.concatenate([rows[[0, 3, 6]],
                                               rng.standard_normal((4, 64)).astype(np.float32)]))
    _, everyone = knn_search(queries.to(cuda_device), keys, k=21, query_chunk=3)
    for k in range(1, 9):
        sims, idx = knn_search(queries.to(cuda_device), keys, k=k, query_chunk=3)
        np.testing.assert_array_equal(idx, everyone[:, :k])  # a tie at the k-th place too
        for r in range(7):
            order = sorted(range(k), key=lambda j: (-sims[r, j], idx[r, j]))
            assert order == list(range(k)), (k, r, sims[r], idx[r])
        if k >= 3:
            assert idx[:3, :3].tolist() == [[0, 7, 14], [3, 10, 17], [6, 13, 20]]


def _tiny_cfg():
    cfg = ExperimentConfig()
    cfg.image.vit = ViTConfig(image_size=32, patch_size=16, hidden_size=128, num_layers=2,
                              num_heads=2, mlp_dim=256)
    cfg.dna.max_bp = 80
    cfg.dna.bert = BertConfig(vocab_size=1027, hidden_size=128, num_layers=2, num_heads=2,
                              intermediate_size=256, max_position_embeddings=40,
                              with_mlm_head=True)
    cfg.language.bert = BertConfig(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2,
                                   intermediate_size=256, max_position_embeddings=24)
    cfg.output_dim = 64
    return cfg


@pytest.mark.cuda
def test_tiny_model_on_the_card_matches_the_cpu(cuda_device):
    """clibd_apply through the kernel (6 launches: 2 layers x 3 encoders)
    against the same weights and inputs through the plain version on the CPU."""
    cfg = _tiny_cfg()
    cpu_model = init_clibd_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    rng = np.random.default_rng(1)
    att = (rng.random((3, 20)) > 0.3).astype(np.int32)
    att[:, 0] = 1
    ids = rng.integers(0, 300, (3, 20)).astype(np.int32)
    inputs = {"image": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
              "dna": rng.integers(0, 1027, (3, 17)).astype(np.int32),
              "language": {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                           "attention_mask": att}}

    def run(model, device, dtype):
        def put(x):
            return ({k: put(v) for k, v in x.items()} if isinstance(x, dict)
                    else torch.from_numpy(x).to(device))
        x = put(inputs)
        with torch.inference_mode():
            out = clibd_apply(model, cfg, x["image"], x["dna"], x["language"],
                              compute_dtype=dtype)
        return {m: out[m].float().cpu() for m in ("image", "dna", "language")}

    before = flash_attention_qkv.launches
    got32 = run(gpu_model, cuda_device, torch.float32)
    assert flash_attention_qkv.launches == before + 6
    want32 = run(cpu_model, "cpu", torch.float32)
    got16 = run(gpu_model, cuda_device, torch.bfloat16)
    want16 = run(cpu_model, "cpu", torch.bfloat16)
    for m in want32:
        err = float((got32[m] - want32[m]).abs().max())
        assert err <= EMB_ATOL, (m, err)
        cos = torch.nn.functional.cosine_similarity(got16[m], want16[m], dim=-1)
        assert float(cos.min()) >= BF16_COSINE_MIN, (m, cos)


def _parts_err(got, want, H):
    """max |got - want| / max |want| for each of dq, dk, dv (0 where both are
    all zeros: at N=1 dS, so dq and dk, are exactly 0)."""
    D = H * 64
    return [float((got[..., i * D:(i + 1) * D].float() - want[..., i * D:(i + 1) * D].float())
                  .abs().max() / want[..., i * D:(i + 1) * D].float().abs().max().clamp_min(1e-30))
            for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,masked", [(197, 12, False), (133, 12, False), (20, 8, True),
                                         (33, 2, True), (657, 12, True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernel_matches_plain_version(cuda_device, N, H, masked, dtype):
    qkv, mask = _inputs(8, N, H, masked, seed=N + 1)
    dout = np.random.default_rng(N).standard_normal((8, N, H * 64)).astype(np.float32)
    t = torch.from_numpy(qkv).to(cuda_device, dtype)
    g = torch.from_numpy(dout).to(cuda_device, dtype)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = flash_attention_qkv_bwd.launches
    got = flash_attention_qkv_bwd(t, g, H, m)
    torch.cuda.synchronize()
    assert flash_attention_qkv_bwd.launches == before + 1
    assert got.dtype == dtype and got.shape == t.shape
    assert torch.isfinite(got).all()
    want = flash_attention_qkv_bwd_reference(t, g, H, m)
    errs = _parts_err(got, want, H)
    assert max(errs) <= BWD_REL_TOL, errs


# (B, N, H) either side of the backward's route threshold (the whole row on
# chip up to 208 keys, key-tiled past them), a block edge of each route and
# one key, at odd B and H = 1, 8, 12
BWD_ROUTE_EDGES = [(3, 1, 8), (5, 64, 1), (3, 65, 12), (3, 207, 8), (5, 208, 12), (1, 209, 1),
                   (3, 209, 12), (5, 257, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H", BWD_ROUTE_EDGES)
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_kernel_either_side_of_its_route_threshold(cuda_device, B, N, H, masked):
    qkv, mask = _inputs(B, N, H, masked, seed=3 * N + B)
    dout = np.random.default_rng(N + 1).standard_normal((B, N, H * 64)).astype(np.float32)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(dout).to(cuda_device, torch.bfloat16)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    assert attention.flash_attention_qkv_bwd_route(N) == (0 if N <= 208 else 1)
    got = flash_attention_qkv_bwd(t, g, H, m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    errs = _parts_err(got, flash_attention_qkv_bwd_reference(t, g, H, m), H)
    assert max(errs) <= BWD_REL_TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,masked", [(197, 12, False), (657, 12, True)])
def test_bwd_kernel_is_deterministic(cuda_device, N, H, masked):
    """Both routes give the same bits from the same inputs: no CTA of
    either adds into another's output (the key-tiled route's dQ comes from
    its row kernel's second sweep, dK and dV from its column kernel)."""
    qkv, mask = _inputs(16, N, H, masked, seed=N + 2)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    g = torch.randn(16, N, H * 64, device=cuda_device, dtype=torch.bfloat16)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    first = flash_attention_qkv_bwd(t, g, H, m)
    assert all(torch.equal(first, flash_attention_qkv_bwd(t, g, H, m)) for _ in range(3))


@pytest.mark.cuda
def test_autograd_through_the_op_runs_both_kernels(cuda_device):
    """grad of the op on the card: one forward and one backward launch, and
    the gradient is the backward kernel's own output; a strided dO is taken."""
    qkv, mask = _inputs(4, 20, 8, True, seed=7)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16).requires_grad_()
    m = torch.from_numpy(mask).to(cuda_device)
    g = torch.randn(4, 8 * 64, 20, device=cuda_device, dtype=torch.bfloat16).transpose(1, 2)
    f0, b0 = flash_attention_qkv.launches, flash_attention_qkv_bwd.launches
    out = flash_attention_qkv(t, 8, m)
    (grad,) = torch.autograd.grad(out, t, g)
    torch.cuda.synchronize()
    assert (flash_attention_qkv.launches - f0, flash_attention_qkv_bwd.launches - b0) == (1, 1)
    assert torch.equal(grad, flash_attention_qkv_bwd(t.detach(), g, 8, m))


@pytest.mark.cuda
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    ok = torch.zeros(2, 5, 3 * 128, device=cuda_device, dtype=torch.bfloat16)
    dout = torch.zeros(2, 5, 128, device=cuda_device, dtype=torch.bfloat16)
    before = flash_attention_qkv_bwd.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_qkv_bwd(torch.zeros(2, 5, 3 * 96, device=cuda_device), dout, 1)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_qkv_bwd(ok, dout[:, :4], 2)
    with pytest.raises(ValueError, match="mask"):
        flash_attention_qkv_bwd(ok, dout, 2, torch.zeros(2, 5))
    assert flash_attention_qkv_bwd.launches == before
    # the keys and queries stream in tiles: a long sequence is taken
    long = torch.zeros(1, 657, 3 * 64, device=cuda_device, dtype=torch.bfloat16)
    assert torch.equal(flash_attention_qkv_bwd(long, long[..., :64], 1), long)
    assert flash_attention_qkv_bwd.launches == before + 1


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Loss gradients of a tiny tri-modal model through both kernels, under
    the "attn" remat policy, against the same weights on the CPU, in fp32:
    every trainable parameter gets a gradient, and the forward kernel is not
    re-run in the backward."""
    from clibd_tpu_torch.ops.loss import clip_loss

    cfg = _tiny_cfg()
    cpu_model = init_clibd_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    rng = np.random.default_rng(2)
    att = (rng.random((4, 20)) > 0.3).astype(np.int32)
    att[:, 0] = 1
    ids = rng.integers(0, 300, (4, 20)).astype(np.int32)
    inputs = {"image": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
              "dna": rng.integers(0, 1027, (4, 17)).astype(np.int32),
              "language": {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                           "attention_mask": att}}
    labels = np.array([0, 1, 0, 2])

    def grads(model, device):
        def put(x):
            return ({k: put(v) for k, v in x.items()} if isinstance(x, dict)
                    else torch.from_numpy(x).to(device))
        x = put(inputs)
        out = clibd_apply(model, cfg, x["image"], x["dna"], x["language"],
                          compute_dtype=torch.float32, remat="attn")
        loss = clip_loss(out, torch.from_numpy(labels).to(device), out["logit_scale"], cfg.loss)
        params = [p for p in model.parameters() if p.requires_grad]
        return loss, torch.autograd.grad(loss, params)

    f0, b0 = flash_attention_qkv.launches, flash_attention_qkv_bwd.launches
    loss_gpu, g_gpu = grads(gpu_model, cuda_device)
    torch.cuda.synchronize()
    assert (flash_attention_qkv.launches - f0, flash_attention_qkv_bwd.launches - b0) == (6, 6)
    loss_cpu, g_cpu = grads(cpu_model, "cpu")
    assert abs(float(loss_gpu) - float(loss_cpu)) <= 1e-4 * abs(float(loss_cpu))
    for a, b in zip(g_gpu, g_cpu):
        a = a.cpu().flatten()
        assert torch.isfinite(a).all()
        assert float((a - b.flatten()).abs().max()) <= 2e-2 * float(b.abs().max()) + 1e-6


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _outproj_inputs(B, N, H, masked, seed, device, dtype):
    qkv, mask = _inputs(B, N, H, masked, seed)
    rng = np.random.default_rng(seed + 1)
    D = H * 64
    w = torch.from_numpy((rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(D) * 0.1).astype(np.float32))
    return (torch.from_numpy(qkv).to(device, dtype), w.to(device, dtype), b.to(device, dtype),
            None if mask is None else torch.from_numpy(mask).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,masked", [(197, 12, False), (133, 12, False), (20, 8, True),
                                         (33, 2, True), (657, 12, True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_outproj_kernel_matches_plain_version(cuda_device, N, H, masked, dtype):
    t, w, b, m = _outproj_inputs(8, N, H, masked, N + 3, cuda_device, dtype)
    before = flash_attention_qkv_outproj.launches
    got = flash_attention_qkv_outproj(t, w, b, H, m)
    torch.cuda.synchronize()
    assert flash_attention_qkv_outproj.launches == before + 1
    assert got.dtype == dtype and got.shape == (8, N, H * 64)
    assert torch.isfinite(got).all()
    want = flash_attention_qkv_outproj_reference(t, w, b, H, m)
    assert _rel(got, want) <= FUSED_REL_TOL
    if masked:  # batch row 0 has every key masked
        assert _rel(got[0], want[0]) <= FUSED_REL_TOL


# the bf16 kernel's edges: one key; a query tile one row short of 64, full,
# and one row past it; a single batch element and odd ones; every H it
# takes (2, 4, 6, 8, 12); masked rows, batch row 0 fully masked
@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,masked", [(1, 1, 12, False), (3, 63, 12, True), (1, 64, 8, False),
                                           (5, 65, 2, True), (3, 65, 12, False), (1, 20, 8, True),
                                           (2, 40, 4, True), (3, 70, 6, False)])
def test_outproj_kernel_edges(cuda_device, B, N, H, masked):
    t, w, b, m = _outproj_inputs(B, N, H, masked, B + N + H, cuda_device, torch.bfloat16)
    before = flash_attention_qkv_outproj.launches
    got = flash_attention_qkv_outproj(t, w, b, H, m)
    torch.cuda.synchronize()
    assert flash_attention_qkv_outproj.launches == before + 1
    assert got.shape == (B, N, H * 64) and torch.isfinite(got).all()
    want = flash_attention_qkv_outproj_reference(t, w, b, H, m)
    assert _rel(got, want) <= FUSED_REL_TOL
    if masked:  # batch row 0 has every key masked: the mean of V, projected
        assert _rel(got[0], want[0]) <= FUSED_REL_TOL


@pytest.mark.cuda
def test_outproj_kernel_is_deterministic(cuda_device):
    """Two launches on the same inputs give the same bits: every product is
    summed in one fixed order, whatever the rings' timing."""
    t, w, b, m = _outproj_inputs(7, 197, 12, True, 11, cuda_device, torch.bfloat16)
    first = flash_attention_qkv_outproj(t, w, b, 12, m)
    second = flash_attention_qkv_outproj(t, w, b, 12, m)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_outproj_autograd_runs_the_kernels(cuda_device):
    """grad of the out-projection operator on the card: one out-projection,
    one forward (ctx for dW) and one backward launch; gradients for qkv,
    W_out and the bias close to the same backward on the CPU."""
    t, w, b, m = _outproj_inputs(4, 20, 8, True, 5, cuda_device, torch.float32)
    g = torch.randn(4, 20, 512, device=cuda_device)
    counts = [f.launches for f in (flash_attention_qkv_outproj, flash_attention_qkv,
                                   flash_attention_qkv_bwd)]
    leaves = [x.detach().requires_grad_() for x in (t, w, b)]
    got = torch.autograd.grad(flash_attention_qkv_outproj(*leaves, 8, m), leaves, g)
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip((flash_attention_qkv_outproj, flash_attention_qkv,
                                            flash_attention_qkv_bwd), counts)] == [1, 1, 1]
    cpu = [x.detach().cpu().requires_grad_() for x in (t, w, b)]
    want = torch.autograd.grad(flash_attention_qkv_outproj(*cpu, 8, m.cpu()), cpu, g.cpu())
    for a, e in zip(got, want):
        assert _rel(a.cpu(), e) <= FUSED_REL_TOL


def _mlp_inputs(R, D, Fd, seed, device, dtype):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((R, D)), rng.standard_normal((D, Fd)) / np.sqrt(D),
              rng.standard_normal(Fd) * 0.1, rng.standard_normal((Fd, D)) / np.sqrt(Fd),
              rng.standard_normal(D) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(device, dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,Fd,activation", [
    (8 * 197, 768, 3072, "gelu_tanh"), (8 * 133 + 5, 768, 3072, "gelu_tanh"),
    (8 * 77, 512, 2048, "gelu_tanh"), (37, 256, 128, "gelu"), (37, 256, 128, "quick_gelu"),
    # the edges of the bf16 kernel's ring and cluster: one row, a partial and
    # a whole row block, one past it, an odd count of row blocks (the cluster
    # of two gets a CTA with no rows), the ragged 63*197; F = 64 and 128
    # (fewer F chunks than ring stages); every D it takes
    (1, 768, 3072, "gelu_tanh"), (37, 768, 3072, "gelu_tanh"), (64, 768, 3072, "gelu_tanh"),
    (65, 768, 3072, "gelu_tanh"), (64 * 3, 768, 3072, "gelu_tanh"),
    (63 * 197, 768, 3072, "gelu_tanh"), (37, 768, 64, "gelu_tanh"), (65, 768, 128, "gelu"),
    (64 * 3, 512, 64, "quick_gelu"), (65, 512, 2048, "gelu_tanh"), (64 * 3, 256, 3072, "gelu")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_kernel_matches_plain_version(cuda_device, R, D, Fd, activation, dtype):
    args = _mlp_inputs(R, D, Fd, R + D, cuda_device, dtype)
    before = fused_mlp.launches
    got = fused_mlp(*args, activation=activation)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert got.dtype == dtype and got.shape == (R, D) and torch.isfinite(got).all()
    assert _rel(got, fused_mlp_reference(*args, activation)) <= FUSED_REL_TOL


@pytest.mark.cuda
def test_fused_mlp_kernel_is_deterministic(cuda_device):
    """Two launches on the same inputs give the same bits: no atomics, and the
    products are summed in one fixed order whatever the ring's timing."""
    args = _mlp_inputs(8 * 197 + 5, 768, 3072, 7, cuda_device, torch.bfloat16)
    first = fused_mlp(*args)
    second = fused_mlp(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_fused_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    before = flash_attention_qkv_outproj.launches, fused_mlp.launches
    t, w, b, _ = _outproj_inputs(2, 5, 3, False, 0, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_attention_qkv_outproj(t, w, b, 3)  # D = 192
    t, w, b, _ = _outproj_inputs(2, 5, 2, False, 0, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="out_w"):
        flash_attention_qkv_outproj(t, w[:64], b, 2)
    x, w1, b1, w2, b2 = _mlp_inputs(5, 384, 128, 0, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="not taken"):
        fused_mlp(x, w1, b1, w2, b2)
    x, w1, b1, w2, b2 = _mlp_inputs(5, 256, 128, 0, cuda_device, torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        fused_mlp(x, w1.float(), b1, w2, b2)
    assert (flash_attention_qkv_outproj.launches, fused_mlp.launches) == before


def _tiny_clip_cfg():
    cfg = ExperimentConfig()
    cfg.backbone = "open_clip"
    cfg.disable_lora = True
    c = cfg.clip
    c.image_size, c.patch_size, c.vision_hidden, c.vision_layers = 32, 16, 256, 2
    c.vision_heads, c.vision_mlp = 4, 512
    c.vocab_size, c.context_length, c.text_hidden, c.text_layers = 300, 16, 256, 2
    c.text_heads, c.text_mlp, c.embed_dim = 4, 512, 64
    cfg.output_dim = 64
    cfg.dna.max_bp = 80
    cfg.dna.bert = BertConfig(vocab_size=1027, hidden_size=256, num_layers=2, num_heads=4,
                              intermediate_size=512, max_position_embeddings=40,
                              with_mlm_head=True)
    return cfg


@pytest.mark.cuda
def test_tiny_bioclip_with_fused_kernels_on_the_card_matches_the_cpu(cuda_device):
    """clibd_apply of a 2-layer open_clip model with both opt-in kernels on:
    4 out-projection launches (vision + DNA) and 6 fused-MLP launches (three
    towers), and the embeddings close to the same model on the CPU."""
    cfg = _tiny_clip_cfg()
    cpu_model = init_clibd_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda_device)
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 298, (3, 16)).astype(np.int32)
    ids[:, 0], ids[:, 9], ids[:, 10:] = 298, 299, 0
    inputs = {"image": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
              "dna": rng.integers(0, 1027, (3, 17)).astype(np.int32), "language": ids}

    def run(model, device, dtype):
        x = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
        with torch.inference_mode(), kernel_knobs(True, "pallas"):
            out = clibd_apply(model, cfg, x["image"], x["dna"], {"input_ids": x["language"]},
                              compute_dtype=dtype)
        return {m: out[m].float().cpu() for m in ("image", "dna", "language")}

    before = flash_attention_qkv_outproj.launches, fused_mlp.launches, flash_attention_qkv.launches
    got32 = run(gpu_model, cuda_device, torch.float32)
    after = flash_attention_qkv_outproj.launches, fused_mlp.launches, flash_attention_qkv.launches
    assert [a - b for a, b in zip(after, before)] == [4, 6, 0]
    want32 = run(cpu_model, "cpu", torch.float32)
    got16 = run(gpu_model, cuda_device, torch.bfloat16)
    want16 = run(cpu_model, "cpu", torch.bfloat16)
    for m in want32:
        assert float((got32[m] - want32[m]).abs().max()) <= EMB_ATOL, m
        cos = torch.nn.functional.cosine_similarity(got16[m], want16[m], dim=-1)
        assert float(cos.min()) >= BF16_COSINE_MIN, (m, cos)


# GEMM against its plain version, relative to max |plain|: exact bf16
# products on both sides, fp32 sums in another order; a bf16 out adds one
# rounding that such a difference can flip
GEMM_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


# the copy's sizes: the probe's, odd ones below one 16-byte vector, one, and
# one and a scalar, and one that wraps each CTA's ring of 8 slots of 16 KB
# 2.5 times with a ragged end (random data, so a slot refilled before its
# store has read it shows)
SCALE_COPY_SIZES = [8192 * 2048, 4099, 3, 1, 4, 5, 132 * 4096 * 20 + 4103]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCALE_COPY_SIZES)
def test_scale_copy_kernel_is_exact(cuda_device, n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n, dtype=np.float32))
    x = x.to(cuda_device)
    before = scale_copy.launches
    got = scale_copy(x, 2.0)
    torch.cuda.synchronize()
    assert scale_copy.launches == before + 1
    assert torch.equal(got, x * 2.0)
    assert torch.equal(got, scale_copy(x, 2.0))  # two launches, the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("out_dtype", OUT_DTYPES, ids=["fp32", "bf16"])
def test_tiled_gemm_kernel_matches_plain_version(cuda_device, tile, out_dtype):
    bm, bn, bk = TILES[tile][:3]
    M, N, K = 2 * bm, 3 * bn, 5 * bk  # several CTAs each way and a K loop longer than the ring
    rng = np.random.default_rng(bm + bn + bk)
    a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device,
                                                                           torch.bfloat16)
            for s in ((M, K), (K, N)))
    before = tiled_matmul.launches
    got = tiled_matmul(a, b, tile, out_dtype)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (M, N)
    want = tiled_matmul_reference(a, b, out_dtype).float()
    assert float((got.float() - want).abs().max()) <= GEMM_REL_TOL[out_dtype] * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("shape", ["more_tiles_than_sms", "one_slot_of_k"])
def test_tiled_gemm_kernel_at_its_edges(cuda_device, tile, shape):
    """A persistent grid walking more tiles than the card has SMs (M != N, a
    tile count that is no multiple of 132), and K of one 64-deep slot; BN >
    64 with random B, so a wrong offset between B's 64-column boxes shows;
    two launches bit-identical."""
    bm, bn, bk = TILES[tile][:3]
    M, N, K = (16 * bm, 9 * bn, 3 * bk) if shape == "more_tiles_than_sms" else (2 * bm, 3 * bn, bk)
    rng = np.random.default_rng(M + N + K)
    a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda_device,
                                                                           torch.bfloat16)
            for s in ((M, K), (K, N)))
    for out_dtype in OUT_DTYPES:
        got = tiled_matmul(a, b, tile, out_dtype)
        assert torch.equal(got, tiled_matmul(a, b, tile, out_dtype))
        want = tiled_matmul_reference(a, b, out_dtype).float()
        assert float((got.float() - want).abs().max()) <= GEMM_REL_TOL[out_dtype] * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N", [(1, 1, 1), (3, 12, 63), (3, 12, 64), (1, 1, 65), (3, 1, 256),
                                   (1, 12, 256)])
def test_attention_bhnd_kernel_at_its_edges(cuda_device, B, H, N):
    """One key, a query tile one row short, a whole 64-key block and one key
    past it, the 256 keys a row holds; B = 1 and 3, H = 1 and 12; two
    launches bit-identical."""
    rng = np.random.default_rng(B + H + N)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, 64), dtype=np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3))
    got = attention_bhnd(q, k, v)
    assert torch.equal(got, attention_bhnd(q, k, v))
    assert float((got.float() - attention_bhnd_reference(q, k, v).float()).abs().max()) \
        <= FP32_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(4, 197), (4, 133), (4, 20), (2, 256)])
def test_attention_bhnd_kernel_matches_plain_version(cuda_device, B, N):
    rng = np.random.default_rng(N)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 12, N, 64), dtype=np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3))
    before = attention_bhnd.launches
    got = attention_bhnd(q, k, v)
    torch.cuda.synchronize()
    assert attention_bhnd.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float((got.float() - attention_bhnd_reference(q, k, v).float()).abs().max()) \
        <= FP32_ATOL


@pytest.mark.cuda
def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    before = scale_copy.launches, tiled_matmul.launches, attention_bhnd.launches
    z = torch.zeros(1000, 1024, device=cuda_device, dtype=torch.bfloat16)
    sq = torch.zeros(1024, 1024, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of the tile"):
        tiled_matmul(z, sq, "t64x64x64")
    with pytest.raises(ValueError, match="multiples of the tile"):
        tiled_matmul(sq[:, :1000].contiguous(), z, "t64x64x64")
    with pytest.raises(ValueError, match="contiguous"):
        tiled_matmul(sq.t(), sq, "t64x64x64")
    with pytest.raises(TypeError, match="fp32 only"):
        scale_copy(torch.zeros(8, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        scale_copy(torch.zeros(8, 8, device=cuda_device).t())
    q = torch.zeros(1, 2, 20, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds"):
        attention_bhnd(*(torch.zeros(1, 1, 300, 64, device=cuda_device, dtype=torch.bfloat16),) * 3)
    with pytest.raises(ValueError, match="head dim"):
        attention_bhnd(q[..., :32], q[..., :32], q[..., :32])
    with pytest.raises(TypeError, match="bf16 only"):
        attention_bhnd(q.float(), q.float(), q.float())
    assert (scale_copy.launches, tiled_matmul.launches, attention_bhnd.launches) == before


@pytest.mark.cuda
def test_probe_kernels_have_no_fallback(cuda_device, monkeypatch):
    """On the card each probe op launches its kernel or raises: with the
    kernel's entry point failing, the call raises instead of running the
    plain version."""
    def refuse(what, *args, **kwargs):
        raise RuntimeError(f"{what} kernel launch failed: refused for the test")

    for module in (elementwise, gemm, attention):
        monkeypatch.setattr(module, "launch", refuse)
    sq = torch.zeros(64, 64, device=cuda_device, dtype=torch.bfloat16)
    q = torch.zeros(1, 1, 20, 64, device=cuda_device, dtype=torch.bfloat16)
    for call in (lambda: scale_copy(torch.zeros(16, device=cuda_device)),
                 lambda: tiled_matmul(sq, sq, "t64x64x64"),
                 lambda: attention_bhnd(q, q, q)):
        with pytest.raises(RuntimeError, match="refused for the test"):
            call()


EXP_FLASH_SHAPES = [(197, 12, False), (133, 12, True), (20, 8, True), (37, 2, True)]
# the forward kernels' edges, at an odd batch of 3: one key; a whole 64-key
# block and one key past it (a query tile with one live row); N = 256, the
# most they take; a query tile one row short; H = 2 and 12, random V, and
# batch row 0 fully masked where masked
EXP_FLASH_EDGES = [(1, 2, False), (64, 12, True), (65, 2, True), (256, 12, True), (63, 12, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,masked", EXP_FLASH_SHAPES + EXP_FLASH_EDGES)
@pytest.mark.parametrize("variant", ["phased", "batched"])
def test_exp_flash_forward_kernels_match_plain_version(cuda_device, variant, N, H, masked):
    op = {"phased": flash_attention_qkv_phased, "batched": flash_attention_qkv_batched}[variant]
    B = 4 if (N, H, masked) in EXP_FLASH_SHAPES else 3
    qkv, mask = _inputs(B, N, H, masked, seed=N + 2)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = op.launches
    got = op(t, H, m)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, H * 64)
    want = flash_attention_qkv_reference(t, H, m).float()
    assert float((got.float() - want).abs().max()) <= BF16_ATOL
    if masked:  # the fully masked batch row is the mean of V
        v = t[0, :, 2 * H * 64:].float().mean(0)
        assert float((got[0].float() - v).abs().max()) <= BF16_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["phased", "batched"])
def test_exp_flash_forward_kernels_are_deterministic(cuda_device, variant):
    """Two launches on the same inputs give the same bits (no atomics, a
    fixed order of products)."""
    op = {"phased": flash_attention_qkv_phased, "batched": flash_attention_qkv_batched}[variant]
    qkv, mask = _inputs(5, 197, 12, True, seed=9)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    m = torch.from_numpy(mask).to(cuda_device)
    assert torch.equal(op(t, 12, m), op(t, 12, m))


@pytest.mark.cuda
def test_phased_forward_takes_every_group_that_fits(cuda_device):
    """At N=20 and N=197 every head group of 12 heads fits (the kernel keeps
    one row of S in registers, not G tiles of it in shared memory): each
    agrees with the plain version; None picks the largest that fits (all 12
    here)."""
    limit = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    for N in (20, 197):
        qkv, mask = _inputs(3, N, 12, True, seed=11)
        t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
        m = torch.from_numpy(mask).to(cuda_device)
        want = flash_attention_qkv_reference(t, 12, m).float()
        for G in (1, 2, 3, 4, 6, 12, 0, None):
            assert 0 < phased_smem_bytes(N, 12, G or 12) <= limit
            got = flash_attention_qkv_phased(t, 12, m, G)
            assert float((got.float() - want).abs().max()) <= BF16_ATOL, (N, G)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,masked", EXP_FLASH_SHAPES)
def test_bwd_phased_kernel_matches_plain_version_and_bwd_kernel(cuda_device, N, H, masked):
    qkv, mask = _inputs(4, N, H, masked, seed=N + 3)
    dout = np.random.default_rng(N + 4).standard_normal((4, N, H * 64)).astype(np.float32)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(dout).to(cuda_device, torch.bfloat16)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    before = flash_attention_qkv_bwd_phased.launches
    got = flash_attention_qkv_bwd_phased(t, g, H, m)
    torch.cuda.synchronize()
    assert flash_attention_qkv_bwd_phased.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == t.shape and torch.isfinite(got).all()
    assert max(_parts_err(got, flash_attention_qkv_bwd_reference(t, g, H, m), H)) <= BWD_REL_TOL
    assert max(_parts_err(got, flash_attention_qkv_bwd(t, g, H, m), H)) <= BWD_REL_TOL


# the phased backward's edges (B, N, H, masked): one key; a query block one
# row short, whole, one row past; the 208 keys it takes at most; odd B,
# H = 1, 2 and 12, batch row 0 fully masked where masked
BWD_PHASED_EDGES = [(3, 1, 2, False), (5, 63, 12, True), (3, 64, 1, True), (1, 65, 12, False),
                    (5, 130, 2, True), (3, 208, 12, True), (7, 208, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,masked", BWD_PHASED_EDGES)
def test_bwd_phased_kernel_at_its_edges(cuda_device, B, N, H, masked):
    qkv, mask = _inputs(B, N, H, masked, seed=N + 5)
    dout = np.random.default_rng(N + 6).standard_normal((B, N, H * 64)).astype(np.float32)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(dout).to(cuda_device, torch.bfloat16)
    m = None if mask is None else torch.from_numpy(mask).to(cuda_device)
    got = flash_attention_qkv_bwd_phased(t, g, H, m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert max(_parts_err(got, flash_attention_qkv_bwd_reference(t, g, H, m), H)) <= BWD_REL_TOL
    assert max(_parts_err(got, flash_attention_qkv_bwd(t, g, H, m), H)) <= BWD_REL_TOL


@pytest.mark.cuda
def test_bwd_phased_kernel_is_deterministic(cuda_device):
    """Two launches on the same inputs give the same bits (no atomics)."""
    qkv, mask = _inputs(6, 197, 12, True, seed=13)
    dout = np.random.default_rng(14).standard_normal((6, 197, 768)).astype(np.float32)
    t = torch.from_numpy(qkv).to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(dout).to(cuda_device, torch.bfloat16)
    m = torch.from_numpy(mask).to(cuda_device)
    assert torch.equal(flash_attention_qkv_bwd_phased(t, g, 12, m),
                       flash_attention_qkv_bwd_phased(t, g, 12, m))


@pytest.mark.cuda
def test_exp_flash_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    counted = (flash_attention_qkv_phased, flash_attention_qkv_batched,
               flash_attention_qkv_bwd_phased)
    before = [f.launches for f in counted]
    z197 = torch.zeros(2, 197, 3 * 768, device=cuda_device, dtype=torch.bfloat16)
    z256 = torch.zeros(1, 256, 3 * 768, device=cuda_device, dtype=torch.bfloat16)
    z257 = torch.zeros(1, 257, 3 * 768, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention_qkv_phased(z257, 12, None, 3)  # N past the 256 keys a row holds
    with pytest.raises(ValueError, match="divide"):
        flash_attention_qkv_phased(z197, 12, None, 5)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention_qkv_phased(z197[..., :3 * 320].contiguous(), 5, None, 5)  # no G of 5
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention_qkv_batched(z257, 12)  # N past the 256 keys a row holds
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention_qkv_bwd_phased(z256, z256[..., :768], 12)  # N past 208
    for call in (lambda: flash_attention_qkv_phased(z197.float(), 12),
                 lambda: flash_attention_qkv_batched(z197.float(), 12),
                 lambda: flash_attention_qkv_bwd_phased(z197.float(), z197[..., :768].float(), 12)):
        with pytest.raises(TypeError, match="bf16 only"):
            call()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_qkv_batched(torch.zeros(2, 5, 3 * 96, device=cuda_device,
                                                dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="mask"):
        flash_attention_qkv_phased(z197, 12, torch.zeros(2, 197))
    assert [f.launches for f in counted] == before


@pytest.mark.cuda
def test_exp_flash_kernels_have_no_fallback(cuda_device, monkeypatch):
    """On the card each experiment op launches its kernel or raises: with the
    kernel's entry point failing, the call raises instead of running the
    plain version."""
    def refuse(what, *args, **kwargs):
        raise RuntimeError(f"{what} kernel launch failed: refused for the test")

    monkeypatch.setattr(attention, "launch", refuse)
    t = torch.zeros(1, 20, 3 * 128, device=cuda_device, dtype=torch.bfloat16)
    for call in (lambda: flash_attention_qkv_phased(t, 2),
                 lambda: flash_attention_qkv_batched(t, 2),
                 lambda: flash_attention_qkv_bwd_phased(t, t[..., :128], 2)):
        with pytest.raises(RuntimeError, match="refused for the test"):
            call()
