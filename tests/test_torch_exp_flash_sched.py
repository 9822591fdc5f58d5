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
