"""`tools/exp_flash_sched` builds scratch variants of the phased and batched
forward kernels by editing their sources (and inlining the wgmma attention
core they share); on the CPU, hold each edit to the committed sources, so
that a change to a kernel that moves one of its seams fails here and not on
the card."""

import pytest

from clibd_tpu_torch.tools.exp_flash_sched import (
    NEW_VARIANTS,
    SECTIONS,
    SOURCES,
    variants_of,
    warpgroups,
)


@pytest.mark.parametrize("schedule", sorted(SOURCES))
def test_every_variant_edits_the_committed_kernel(schedule):
    src = SOURCES[schedule].read_text()
    kind, variants, sections = variants_of(src)
    assert kind == schedule and set(variants) == set(NEW_VARIANTS) and sections == SECTIONS
    assert variants["kernel"] == src
    # every other variant inlines the core, so that it can edit it
    for name in ("sections", "early_issue", "l2_only", "no_softmax", "kv_once"):
        assert '#include "wgmma_attention.cuh"' not in variants[name]
        assert "attend_items" in variants[name]
    # a tick after each of the ten sections, and the start
    assert variants["sections"].count("clock64()") == 11 == len(SECTIONS)
    assert "clibd_prof" in variants["sections"]
    assert variants["l2_only"].count(", 0);\n") == 1  # FusedQkv::load, every part of an item
    assert "fast_exp2" not in variants["no_softmax"].split("if (warp_live)")[1][:400]
    assert "if (k != 0 && L.q0 > 0)" in variants["kv_once"]
    assert variants["early_issue"].count("wait_box(L, m0 + 1 + ") == 4


def test_warpgroups_match_the_phased_kernel():
    """the tool's copy of the kernel's rule: W divides G, at most three"""
    src = SOURCES["phased"].read_text()
    assert "return G <= 3 ? G : G % 3 == 0 ? 3 : 2;" in src
    assert [warpgroups(G) for G in (1, 2, 3, 4, 6, 8, 12)] == [1, 2, 3, 2, 3, 2, 3]


def test_every_bwd_variant_edits_the_committed_kernel():
    """the committed backward's sections: five stretches of the kernel and
    eight of warpgroup 0's query blocks, each a tick of thread 0"""
    from clibd_tpu_torch.tools.exp_flash_sched import BWD_SECTIONS, BWD_SOURCE, bwd_variants

    src = BWD_SOURCE.read_text()
    kind, variants, sections = bwd_variants(src)
    assert kind == "bwd" and set(variants) == {"kernel", "sections"}
    assert variants["kernel"] == src and sections == BWD_SECTIONS and len(sections) == 13
    text = variants["sections"]
    # five stamps of the kernel, the block's start and its eight ticks, the end
    assert text.count("clock64()") == 5 + 1 + 8 + 1
    slots = {int(s) for s in __import__("re").findall(r"g_prof \+ (\d+)", text)}
    assert slots == set(range(14))  # and the count of blocks in g_prof[13]
    assert "clibd_prof" in text


def test_an_earlier_bwd_source_is_built_as_it_is():
    """a backward source of neither known kind has no edited variants; the
    previous mma.sync kernel's anchors give it its five sections"""
    from clibd_tpu_torch.tools import exp_flash_sched as tool

    src = "// an earlier kernel\nextern \"C\" int clibd_flash_attention_qkv_bwd_phased();\n"
    assert tool.bwd_variants(src) == ("other", {"kernel": src}, ())
    prev = ("namespace {\n" + tool.PREV_BWD_MARK + "\n" + tool.BWD_START + tool.PBW_STAGED
            + tool.PBW_ROWS + tool.PBW_COPIED + tool.PBW_END + 'extern "C" {\n')
    kind, variants, sections = tool.bwd_variants(prev)
    assert kind == "prev_bwd" and sections == tool.PREV_BWD_SECTIONS
    assert variants["sections"].count("clock64()") == len(sections) + 1
    assert variants["sections"].count("atomicAdd(g_prof") == len(sections)


def test_every_row1_variant_edits_the_committed_forward():
    """`--row1`: the main path's forward (csrc/flash_attention_qkv.cu) as it
    is, with its clock64 sections, with every load from L2 (the core
    inlined, FusedQkv::load edited) and without the softmax"""
    from clibd_tpu_torch.tools.exp_flash_sched import (ROW1_SECTIONS, ROW1_SOURCE,
                                                      ROW1_VARIANTS)

    src = ROW1_SOURCE.read_text()
    variants = {name: edit(src) for name, edit in ROW1_VARIANTS.items()}
    assert set(variants) == {"kernel", "sections", "l2_only", "no_softmax"}
    assert variants["kernel"] == src
    text = variants["sections"]
    # the nine sections: seven ticks in the block loop, the item's start, the
    # set-up and q-wait stamps, the context's start and end
    assert text.count("TICK_(") == 7 + 1 and len(ROW1_SECTIONS) == 9
    assert {int(k) for k in __import__("re").findall(r"prof_\[(\d)\] \+=", text)} == {0, 1, 8}
    assert "clibd_prof" in text and "atomicAdd(g_prof + i" in text
    assert variants["l2_only"].count(", 0);\n") == 1 and "attend_items" in variants["l2_only"]
    assert "al0 = al1 = 1.f;\n    return;" in variants["no_softmax"]


def test_every_row2_variant_edits_the_committed_backward():
    """`--row2`: the main path's backward (csrc/flash_attention_qkv_bwd.cu)
    as it is; the whole-row route's sections, the core inlined with the
    phased backward's ticks; the key-tiled route's sections, the source's
    clock64 hooks defined: eight sections of the row kernel, six of the
    column kernel, each ticked"""
    import re

    from clibd_tpu_torch.tools.exp_flash_sched import (BWD_SECTIONS, ROW2_COL_SECTIONS,
                                                      ROW2_PROF, ROW2_ROW_SECTIONS, ROW2_SOURCE,
                                                      ROW2_VARIANTS)

    src = ROW2_SOURCE.read_text()
    variants = {name: edit(src) for name, edit in ROW2_VARIANTS.items()}
    assert set(variants) == {"kernel", "sections_row", "sections_tiled"}
    assert variants["kernel"] == src
    row = variants["sections_row"]
    assert '#include "wgmma_attention_bwd.cuh"' not in row and "row_block<KT>" in row
    assert row.count("clock64()") == 5 + 1 + 8 + 1 == len(BWD_SECTIONS) + 2
    assert "clibd_prof" in row
    tiled = variants["sections_tiled"]
    assert tiled.startswith(ROW2_PROF) and "clibd_prof" in tiled
    # the hooks: the empty defaults, then each kernel's begin, ticks and end
    assert src.count("#define BWD_TICK(k)\n") == 1
    rows_kernel = src[src.index("bwd_rows_kernel("):src.index("bwd_cols_kernel(")]
    cols_kernel = src[src.index("bwd_cols_kernel("):src.index("cudaError_t launch_tiled(")]
    for body, first, names, n in ((rows_kernel, 0, ROW2_ROW_SECTIONS, 8),
                                  (cols_kernel, 8, ROW2_COL_SECTIONS, 6)):
        ticks = {int(k) for k in re.findall(r"BWD_TICK\((\d)\)", body)}
        assert ticks == set(range(len(names))) and len(names) == n, ticks
        assert body.count("BWD_PROF_BEGIN") == 1 and f"BWD_PROF_END({first})" in body


def test_row2_route_matches_the_kernel():
    """the tool's copy of the kernel's rule: the whole row on chip up to
    208 keys, key-tiled past them"""
    from clibd_tpu_torch.tools.exp_flash_sched import ROW2_ROUTES, ROW2_SOURCE, row2_route

    src = ROW2_SOURCE.read_text()
    assert "constexpr int route_for(int N) { return N <= 208 ? ROUTE_ROW : ROUTE_TILED; }" in src
    assert "enum Route : int { ROUTE_ROW = 0, ROUTE_TILED = 1 };" in src
    assert ROW2_ROUTES == {"row": 0, "tiled": 1}
    assert [row2_route(N) for N in (1, 20, 133, 197, 207, 208, 209, 300, 657)] == \
        ["row"] * 6 + ["tiled"] * 3


def test_an_earlier_file_builds_against_the_headers_beside_it():
    """a FILE's own directory comes ahead of csrc/ on nvcc's include path,
    so an earlier version builds against its own commit's headers"""
    from pathlib import Path

    from clibd_tpu_torch.ops.cuda_build import CSRC
    from clibd_tpu_torch.tools.exp_flash_sched import include_flags

    prev = Path("build/prev/clibd_tpu_torch/csrc")
    assert include_flags("other0", {"other0": prev}) == ["-I", str(prev), "-I", str(CSRC)]
    assert include_flags("row2_kernel", {"other0": prev}) == ["-I", str(CSRC)]
    assert include_flags("kernel", None) == ["-I", str(CSRC)]
