"""What does the fused-MLP kernel's gelu_tanh cost, form against form?

    python -m clibd_tpu_torch.tools.exp_mlp_activation

The bf16 kernel (`csrc/fused_mlp.cu`, `activate_fast`) computes gelu_tanh
as v * sigmoid(2u) with `__expf` and `__fdividef`: two special-function
operations an element, between the two products.  This harness builds the
kernel again with that line replaced by each form of `FORMS`, loads every
build side by side, and in one process:

- h's accuracy: with W2 = I and b2 = 0 the kernel's output is bf16(h)
  itself, so it prints the share of h that differs from the activation
  computed in fp64 on the same fp32 pre-activation and rounded to bf16;
- the kernel's ms at the three main-path shapes (`chip_smoke.py` phase 7's
  R = 500*N), the forms interleaved (a, b, c, c, b, a), each by CUDA events
  (median of 20, `utils/profiling.cuda_ms`); the weights transposed once,
  outside the timed call.

Needs a CUDA card and nvcc, and raises without; prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from ..ops.cuda_build import CSRC, NVCC_FLAGS, build_dir, find_nvcc
from ..ops.mlp import ACTIVATIONS, fused_mlp_reference
from ..utils.profiling import card_line, cuda_ms

# The kernel's own line, and each form that replaces it
KERNEL_FORM = ("  if (act == GELU_TANH)\n"
               "    return __fdividef(v, 1.f + __expf(-1.5957691216057308f * (v + 0.044715f * v * v * v)));\n")
FORMS = {
    "expf": KERNEL_FORM,
    # one special-function operation, 0.5 v (1 + tanh u)
    "tanh_approx": (
        "  if (act == GELU_TANH) {\n"
        "    float t;\n"
        "    asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(t) : \"f\"(0.7978845608028654f * (v + 0.044715f * v * v * v)));\n"
        "    return 0.5f * v * (1.f + t);\n"
        "  }\n"),
    # ex2 in hardware, the reciprocal of 1 + e by three Newton steps on the
    # FMA pipe from a bit-trick seed (1.5e-7 relative); e capped at 2^120
    "newton": (
        "  if (act == GELU_TANH) {\n"
        "    float e;\n"
        "    asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(e) : \"f\"(fminf(-2.302208198144325f * (v + 0.044715f * v * v * v), 120.f)));\n"
        "    const float d = 1.f + e;\n"
        "    float r = __int_as_float(0x7EF311C3 - __float_as_int(d));\n"
        "    r *= fmaf(-d, r, 2.f);\n"
        "    r *= fmaf(-d, r, 2.f);\n"
        "    r *= fmaf(-d, r, 2.f);\n"
        "    return v * r;\n"
        "  }\n"),
}
SHAPES = (("vit", 500 * 197, 768, 3072), ("barcode_bert", 500 * 133, 768, 3072),
          ("clip_text", 500 * 77, 512, 2048))


def form_source(form: str) -> str:
    """`csrc/fused_mlp.cu` with its gelu_tanh line replaced by `form`'s."""
    src = (CSRC / "fused_mlp.cu").read_text()
    if KERNEL_FORM not in src:
        raise RuntimeError("fused_mlp.cu's gelu_tanh line is not KERNEL_FORM: update this harness")
    return src.replace(KERNEL_FORM, FORMS[form])


def build_forms() -> dict:
    """One nvcc per form, all together → {form: its clibd_fused_mlp}."""
    out = build_dir() / "activation_forms"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for form in FORMS:
        src = out / f"fused_mlp_{form}.cu"
        src.write_text(form_source(form))
        procs[form] = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out / f"fused_mlp_{form}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for form, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {form} form:\n{log}")
        f = ctypes.CDLL(str(out / f"fused_mlp_{form}.so")).clibd_fused_mlp
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fns[form] = f
    return fns


def call(f, x, w1t, b1, w2t, b2) -> torch.Tensor:
    """The kernel on x with the weights already K-major (W1^T, W2^T)."""
    out = torch.empty_like(x)
    rc = f(x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
           out.data_ptr(), x.shape[0], x.shape[1], w1t.shape[0], ACTIVATIONS.index("gelu_tanh"), 1,
           torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fused_mlp launch failed: CUDA error {rc}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("exp_mlp_activation needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    fns = build_forms()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    R, D = 64 * 197, 768
    x = torch.randn(R, D, generator=g).to(dev, torch.bfloat16)
    w1 = (torch.randn(D, D, generator=g) * (2 / D ** 0.5)).to(dev, torch.bfloat16)
    b1 = (0.5 * torch.randn(D, generator=g)).to(dev)
    eye, zero = torch.eye(D, device=dev, dtype=torch.bfloat16), torch.zeros(D, device=dev)
    pre = x.double() @ w1.double() + b1.double()
    exact = torch.nn.functional.gelu(pre, approximate="tanh").to(torch.bfloat16)
    plain = fused_mlp_reference(x, w1, b1, eye, zero, "gelu_tanh")
    print(f"h at R={R} D=F={D}, pre-activation in [{float(pre.min()):.2f}, "
          f"{float(pre.max()):.2f}]: share of h that differs from fp64 then bf16: plain "
          f"{float((plain != exact).double().mean()):.6f}", flush=True)
    for form, f in fns.items():
        h = call(f, x, w1.t().contiguous(), b1, eye, zero)
        print(f"  {form}: {float((h != exact).double().mean()):.6f}", flush=True)

    order = list(fns) + list(fns)[::-1]
    for name, R, D, F in SHAPES:
        x = torch.randn(R, D, generator=g).to(dev, torch.bfloat16)
        w1t = (torch.randn(F, D, generator=g) / D ** 0.5).to(dev, torch.bfloat16)
        w2t = (torch.randn(D, F, generator=g) / F ** 0.5).to(dev, torch.bfloat16)
        b1, b2 = 0.1 * torch.randn(F, generator=g).to(dev), 0.1 * torch.randn(D, generator=g).to(dev)
        want = fused_mlp_reference(x, w1t.t(), b1, w2t.t(), b2, "gelu_tanh").float()
        times = {form: [] for form in fns}
        for form in order:
            times[form].append(cuda_ms(lambda: call(fns[form], x, w1t, b1, w2t, b2)))
        for form, f in fns.items():
            got = call(f, x, w1t, b1, w2t, b2).float()
            ms = statistics.mean(times[form])
            print(f"{name} R={R} D={D} F={F} {form}: {ms:.4f} ms (medians {times[form]}), "
                  f"{4 * R * D * F / ms / 1e9:.1f} TFLOP/s, max|kernel - plain| / max|plain| "
                  f"{float((got - want).abs().max() / want.abs().max()):.3e}  [{card}]", flush=True)


if __name__ == "__main__":
    main()
