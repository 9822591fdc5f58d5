"""`tools/exp_probe_sched` builds scratch variants of the two probe kernels
(`csrc/attention_bhnd.cu`, `csrc/tiled_gemm.cu`) by editing their sources;
on the CPU, hold each edit to the committed sources, so that a change to a
kernel that moves one of its seams fails here and not on the card."""

import pytest
import torch

from clibd_tpu_torch.ops.gemm import TILES
from clibd_tpu_torch.tools.exp_probe_sched import (
    ATTN_SOURCE,
    GEMM_SECTIONS,
    GEMM_SOURCE,
    SLAB_COUNTS,
    attn_variants,
    gemm_variants,
    main,
    tiles_of,
)


def test_attention_variants_fix_the_slabs_a_cta_walks():
    src = ATTN_SOURCE.read_text()
    variants = attn_variants(src)
    assert set(variants) == {"kernel"} | {f"slabs{n}" for n in SLAB_COUNTS}
    assert variants["kernel"] == src
    for n in SLAB_COUNTS:
        text = variants[f"slabs{n}"]
        assert f"  return {n};\n" in text and "  return best;\n" not in text


def test_an_earlier_source_is_built_as_it_is():
    """a source without the seams (an earlier kernel) has no edited variants"""
    src = "// an earlier kernel\nextern \"C\" int clibd_attention_bhnd();\n"
    assert attn_variants(src) == {"kernel": src}
    assert gemm_variants(src) == {"kernel": src}


def test_gemm_variants_edit_the_committed_kernel():
    src = GEMM_SOURCE.read_text()
    variants = gemm_variants(src)
    assert set(variants) == {"kernel", "group1", "group8", "sections"}
    assert variants["kernel"] == src
    assert "constexpr int GROUP_M = 1;" in variants["group1"]
    assert "constexpr int GROUP_M = 8;" in variants["group8"]
    sections = variants["sections"]
    # a tick at the start of each tile and after each of the five sections
    assert sections.count("clock64()") == 1 + len(GEMM_SECTIONS)
    assert sections.count("atomicAdd(g_prof") == len(GEMM_SECTIONS) + 1  # and the tile count
    assert "clibd_prof" in sections


def test_tiles_of_names_every_tile():
    assert tiles_of(GEMM_SOURCE.read_text()) == list(TILES)


def test_the_harness_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the harness would run")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        main([])


def test_copy_variants_edit_the_committed_kernel():
    from clibd_tpu_torch.tools.exp_probe_sched import COPY_SOURCE, COPY_VARIANTS, copy_variants

    src = COPY_SOURCE.read_text()
    variants = copy_variants(src)
    assert set(variants) == {"kernel", "unroll4", "capped", "hints"} == {"kernel"} | set(COPY_VARIANTS)
    assert variants["kernel"] == src
    for name, edits in COPY_VARIANTS.items():
        for old, new in edits:
            assert new in variants[name] and old not in variants[name]
    for hint in ("__ldcs(", "__stcs("):  # one streaming load and one store in the kernel
        assert variants["hints"].count(hint) == src.count(hint) + 1
    for text in variants.values():  # every edit keeps its statement whole
        assert text.count("(") - text.count(")") == src.count("(") - src.count(")")


def test_the_grid_stride_copy_gets_a_variant_without_hints():
    """the copy the ring replaced: its streaming loads and stores become
    plain ones; a copy with neither seam is built as it is"""
    from clibd_tpu_torch.tools.exp_probe_sched import COPY_HINTS, copy_variants

    src = "".join(f"    {old}v[u].x));\n" for old, _ in COPY_HINTS)
    variants = copy_variants(src)
    assert set(variants) == {"kernel", "no_hints"}
    assert "__ldcs" not in variants["no_hints"] and "__stcs" not in variants["no_hints"]
    plain = "// an earlier copy\nextern \"C\" int clibd_scale_copy();\n"
    assert copy_variants(plain) == {"kernel": plain}


def test_the_l2_slope_is_the_rate_of_a_straight_line():
    from clibd_tpu_torch.tools.exp_probe_sched import L2_MB, _slope

    rate = 4.5e12  # bytes a second
    times = [2 * mb * 2 ** 20 / rate * 1e3 + 0.004 for mb in L2_MB]  # ms, with a fixed cost
    assert abs(_slope(L2_MB, times) - 4.5) < 1e-9
