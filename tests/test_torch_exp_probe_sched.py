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
