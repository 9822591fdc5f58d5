"""`tools/exp_outproj` builds scratch variants of the fused attention +
out-projection kernel by editing its source; on the CPU, hold each edit to
the committed source, so that a change to the kernel that moves one of its
seams fails here and not on the card."""

from clibd_tpu_torch.tools.exp_outproj import SOURCE, VARIANTS, variants_of


def test_every_variant_edits_the_committed_kernel():
    src = SOURCE.read_text()
    variants, sections = variants_of(src)
    assert set(variants) == set(VARIANTS) and len(sections) == 6
    assert variants["kernel"] == src
    assert all(variants[name] != src for name in VARIANTS if name != "kernel")
    # the attention variant has no projection, no_products no product
    assert "Wgmma<" not in variants["attention"] and "wfull" in variants["no_products"]
    assert "Wgmma<" not in variants["no_products"] and "Wgmma<" in variants["projection"]
    assert "online_tile(" not in variants["projection"]
    assert variants["sections"].count("clock64()") >= 8 and "clibd_prof" in variants["sections"]
    assert "__cluster_dims__(2, 1, 1)" in variants["cluster"]
    assert variants["cluster"].count("cluster_sync()") == 2
