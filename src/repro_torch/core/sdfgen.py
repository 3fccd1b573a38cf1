"""Deterministic synthetic SDF corpus generation.

The container has no 3.2 TB PubChem mirror, so the paper's corpus is
reproduced as a *scale model*: ``n_files`` SDF files × ``records_per_file``
records (the paper: 354 × 500,000), with the same structural features the
paper's system depends on:

* variable-length records delimited by ``$$$$``;
* an embedded full canonical id (``PUBCHEM_IUPAC_INCHI`` role) and a
  hashed key (``REPRO_ID_KEY``, InChIKey role) per record;
* a structure block from which the id is *recomputable* (Algorithm 3's
  defensive verification);
* occasional missing computed properties (the paper's 8,563 exclusions);
* three overlapping "databases" (pubchem/chembl/emolecules roles) with a
  known ground-truth intersection, so the integration funnel (Fig. 1) is
  exactly checkable.

Everything is a pure function of integer compound ids (cids), so corpora
are reproducible and any worker can regenerate any record independently —
the property that the data-plane fault-tolerance story relies on.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, asdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .identifiers import (
    DEFAULT_KEY_BITS,
    Molecule,
    canonical_id,
    hashed_key,
    molecule_from_cid,
    structure_block,
    _rng_stream,
)

__all__ = [
    "CorpusSpec",
    "CorpusManifest",
    "generate_corpus",
    "load_manifest",
    "record_text_for_cid",
    "db_membership",
    "ground_truth_intersection",
    "PROP_ID",
    "PROP_KEY",
    "PROP_CID",
    "PROP_XLOGP",
]

PROP_CID = "PUBCHEM_COMPOUND_CID"
PROP_ID = "PUBCHEM_IUPAC_INCHI"          # full canonical id (collision-free)
PROP_KEY = "REPRO_ID_KEY"                # hashed 27-char key (collision-prone)
PROP_XLOGP = "PUBCHEM_XLOGP3"            # the ML target property

# Database membership rules (pure functions of cid => ground truth known):
#   pubchem    : all cids in [0, n_records)
#   chembl     : cid % CHEMBL_MOD == 0
#   emolecules : cid % EMOL_MOD == 0
# Intersection of all three: cid % lcm(CHEMBL_MOD, EMOL_MOD) == 0.
CHEMBL_MOD = 7
EMOL_MOD = 11


@dataclass(frozen=True)
class CorpusSpec:
    n_files: int = 8
    records_per_file: int = 2_000
    key_bits: int = DEFAULT_KEY_BITS
    salt: str = "repro-corpus-v1"
    # Probability (per mille) that a record lacks the computed property —
    # reproduces the paper's final-phase exclusions (8,563 / 435,413 ≈ 2%).
    missing_prop_per_mille: int = 20

    @property
    def n_records(self) -> int:
        return self.n_files * self.records_per_file


@dataclass
class CorpusManifest:
    spec: CorpusSpec
    root: str
    files: List[str]
    total_bytes: int

    def save(self) -> None:
        p = Path(self.root) / "manifest.json"
        payload = {
            "spec": asdict(self.spec),
            "root": self.root,
            "files": self.files,
            "total_bytes": self.total_bytes,
        }
        p.write_text(json.dumps(payload, indent=1))


def load_manifest(root: Path) -> CorpusManifest:
    payload = json.loads((Path(root) / "manifest.json").read_text())
    return CorpusManifest(
        spec=CorpusSpec(**payload["spec"]),
        root=payload["root"],
        files=payload["files"],
        total_bytes=payload["total_bytes"],
    )


def _has_xlogp(cid: int, spec: CorpusSpec) -> bool:
    rng = _rng_stream(cid, spec.salt + ":prop")
    return not rng.chance(spec.missing_prop_per_mille, 1000)


def _xlogp_value(cid: int, spec: CorpusSpec) -> float:
    rng = _rng_stream(cid, spec.salt + ":xlogp")
    return round(-3.0 + 10.0 * rng.u16() / 65535.0, 2)


def record_text_for_cid(cid: int, spec: CorpusSpec) -> str:
    """Render one SDF record (without the ``$$$$`` terminator line)."""
    mol = molecule_from_cid(cid, spec.salt)
    full_id = canonical_id(mol)
    key = hashed_key(full_id, spec.key_bits)
    lines = [
        f"CID-{cid:09d}",
        "  repro-sdfgen",
        "",
        structure_block(mol),
        f"> <{PROP_CID}>",
        str(cid),
        "",
        f"> <{PROP_ID}>",
        full_id,
        "",
        f"> <{PROP_KEY}>",
        key,
        "",
    ]
    if _has_xlogp(cid, spec):
        lines += [f"> <{PROP_XLOGP}>", f"{_xlogp_value(cid, spec):.2f}", ""]
    return "\n".join(lines) + "\n"


def _file_cid_range(file_idx: int, spec: CorpusSpec) -> range:
    s = spec.records_per_file
    return range(file_idx * s, (file_idx + 1) * s)


def generate_corpus(root: Path, spec: CorpusSpec, force: bool = False) -> CorpusManifest:
    """Write the corpus to ``root`` (idempotent unless ``force``).

    File ``compound_{i:05d}.sdf`` holds cids ``[i*S, (i+1)*S)`` — mirroring
    PubChem's fixed 500k-compounds-per-file layout.
    """
    root = Path(root)
    manifest_path = root / "manifest.json"
    if manifest_path.exists() and not force:
        m = load_manifest(root)
        if m.spec == spec:
            return m
    root.mkdir(parents=True, exist_ok=True)
    files: List[str] = []
    total = 0
    for i in range(spec.n_files):
        name = f"compound_{i:05d}.sdf"
        path = root / name
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            for cid in _file_cid_range(i, spec):
                f.write(record_text_for_cid(cid, spec))
                f.write("$$$$\n")
        files.append(name)
        total += path.stat().st_size
    m = CorpusManifest(spec=spec, root=str(root), files=files, total_bytes=total)
    m.save()
    return m


# ---------------------------------------------------------------------------
# The three "databases" and their ground-truth intersection.
# ---------------------------------------------------------------------------

def db_membership(cid: int, db: str) -> bool:
    if db == "pubchem":
        return True
    if db == "chembl":
        return cid % CHEMBL_MOD == 0
    if db == "emolecules":
        return cid % EMOL_MOD == 0
    raise ValueError(f"unknown db {db!r}")


def db_id_list(spec: CorpusSpec, db: str, extra_outside: int = 0) -> List[str]:
    """Full canonical ids of the ``db`` subset of the universe.

    ``extra_outside`` appends ids of molecules *not* in the pubchem corpus
    (cids beyond the universe) — reproducing the paper's funnel where
    477,123 ChEMBL∩eMolecules compounds shrink to 435,413 found in PubChem.
    """
    ids = [
        canonical_id(molecule_from_cid(cid, spec.salt))
        for cid in range(spec.n_records)
        if db_membership(cid, db)
    ]
    for k in range(extra_outside):
        cid = spec.n_records + k
        ids.append(canonical_id(molecule_from_cid(cid, spec.salt)))
    return ids


def ground_truth_intersection(spec: CorpusSpec) -> List[int]:
    """cids present in all three databases (pure arithmetic ground truth)."""
    step = CHEMBL_MOD * EMOL_MOD  # lcm(7, 11)
    return list(range(0, spec.n_records, step))


def ground_truth_final_dataset(spec: CorpusSpec) -> List[int]:
    """Intersection cids that also carry the computed property (XLOGP role).

    The paper's final analytical dataset: 435,413 intersection molecules
    minus 8,563 lacking computed properties → 426,850.
    """
    return [c for c in ground_truth_intersection(spec) if _has_xlogp(c, spec)]
