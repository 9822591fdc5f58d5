# A copy of clibd_tpu/data/ncbi.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""NCBI-Entrez taxonomy lookup: species name → {order, family, genus}.

Reference: data/INSECT/get_all_species_taxo_labels_dict_and_save_to_json.py
(:1-95) — esearch the taxonomy db for each species, efetch the lineage, keep
order/family/genus ranks, default missing ranks to 'not_classified'.

Network-gated tooling (zero extra deps: urllib instead of Biopython; the
transport is injectable so tests run on canned XML responses and the
production path only needs outbound HTTPS).
"""

from __future__ import annotations

import json
import os
import time
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Sequence, Tuple

EUTILS = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils"
RANKS = ("genus", "family", "order")
NOT_CLASSIFIED = {r: "not_classified" for r in RANKS}


def _default_fetch(url: str) -> bytes:
    from urllib.request import urlopen

    with urlopen(url, timeout=30) as resp:
        return resp.read()


def esearch_taxonomy_url(term: str, email: str) -> str:
    from urllib.parse import quote

    return (f"{EUTILS}/esearch.fcgi?db=taxonomy&term={quote(term)}"
            f"&email={quote(email)}")


def efetch_taxonomy_url(tax_id: str, email: str) -> str:
    from urllib.parse import quote

    return (f"{EUTILS}/efetch.fcgi?db=taxonomy&id={quote(tax_id)}"
            f"&retmode=xml&email={quote(email)}")


def parse_esearch_ids(xml_bytes: bytes) -> List[str]:
    root = ET.fromstring(xml_bytes)
    return [e.text for e in root.findall(".//IdList/Id") if e.text]


def parse_lineage_ranks(xml_bytes: bytes, ranks: Sequence[str] = RANKS) -> Dict[str, str]:
    """TaxaSet XML → {rank: ScientificName} for the requested ranks, missing
    ones 'not_classified' (reference LineageEx walk, :33-41)."""
    root = ET.fromstring(xml_bytes)
    info = dict(NOT_CLASSIFIED)
    for taxon in root.findall(".//LineageEx/Taxon"):
        rank = taxon.findtext("Rank")
        name = taxon.findtext("ScientificName")
        if rank in ranks and name:
            info[rank] = name
    return info


def get_species_to_other_level_dict(
    species_list: Sequence[str],
    email: str,
    taxonomic_info: Optional[Dict[str, Dict[str, str]]] = None,
    fetch: Callable[[str], bytes] = _default_fetch,
    sleep_s: float = 0.5,
    progress: bool = False,
) -> Tuple[Dict[str, Dict[str, str]], List[str]]:
    """Reference get_species_to_other_level_dict (:11-58): resumable (already-
    present species are skipped), every failure degrades to not_classified.
    Returns (species → {order, family, genus}, failed_species)."""
    taxonomic_info = dict(taxonomic_info or {})
    failed: List[str] = []
    for i, species in enumerate(species_list):
        if species in taxonomic_info:
            continue
        try:
            ids = parse_esearch_ids(fetch(esearch_taxonomy_url(species, email)))
            if ids:
                taxonomic_info[species] = parse_lineage_ranks(
                    fetch(efetch_taxonomy_url(ids[0], email)))
            else:
                taxonomic_info[species] = dict(NOT_CLASSIFIED)
        except Exception:
            taxonomic_info[species] = dict(NOT_CLASSIFIED)
            failed.append(species)
        if progress:
            print(f"[{i + 1}/{len(species_list)}] {species}: "
                  f"{taxonomic_info[species]}", flush=True)
        if sleep_s:
            time.sleep(sleep_s)  # NCBI rate limit (reference :57)
    return taxonomic_info, failed


def fetch_species_taxonomy_json(
    species: Sequence[str],
    output_json: str,
    email: str,
    fetch: Callable[[str], bytes] = _default_fetch,
    sleep_s: float = 0.5,
    progress: bool = True,
) -> Dict[str, Dict[str, str]]:
    """End-to-end tool: resume from output_json if present, fetch the rest,
    write back (the reference script's main)."""
    existing = {}
    if os.path.exists(output_json):
        with open(output_json) as f:
            existing = json.load(f)
    info, failed = get_species_to_other_level_dict(
        species, email, taxonomic_info=existing, fetch=fetch,
        sleep_s=sleep_s, progress=progress)
    with open(output_json, "w") as f:
        json.dump(info, f, indent=4)
    if failed:
        print(f"failed species: {failed}")
    return info


def species_from_insect_mats(res101_mat_path: str) -> List[str]:
    """Unique species list from the INSECT res101.mat (reference
    convert_species_nd_array_to_list, :61-65)."""
    import scipy.io as sio

    res = sio.loadmat(res101_mat_path)
    return sorted({arr[0][0] for arr in res["species"]})
