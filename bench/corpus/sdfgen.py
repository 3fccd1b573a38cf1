"""The training cell's corpus: synthetic SDF records made from the seed
(a frozen copy of the record layout of the port's ``core/sdfgen.py``).

Each record is a structure block from which its canonical id can be
recomputed, the id and its hashed key, and, for all but about 2% of the
records, the computed XLOGP3 property; records end with ``$$$$``.  The
run's seed picks the salt, so every seed has its own molecules.  The
records are written to ``n_files`` files under a directory of the run's
``TMPDIR``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from corpus.identifiers import (
    DEFAULT_KEY_BITS,
    _rng_stream,
    canonical_id,
    hashed_key,
    molecule_from_cid,
    structure_block,
)

__all__ = ["PROP_ID", "PROP_XLOGP", "record_text", "write"]

PROP_CID = "PUBCHEM_COMPOUND_CID"
PROP_ID = "PUBCHEM_IUPAC_INCHI"
PROP_KEY = "REPRO_ID_KEY"
PROP_XLOGP = "PUBCHEM_XLOGP3"
MISSING_PER_MILLE = 20


def record_text(cid: int, salt: str) -> str:
    """One SDF record, without its ``$$$$`` line."""
    mol = molecule_from_cid(cid, salt)
    full_id = canonical_id(mol)
    lines = [f"CID-{cid:09d}", "  repro-sdfgen", "", structure_block(mol),
             f"> <{PROP_CID}>", str(cid), "",
             f"> <{PROP_ID}>", full_id, "",
             f"> <{PROP_KEY}>", hashed_key(full_id, DEFAULT_KEY_BITS), ""]
    if not _rng_stream(cid, salt + ":prop").chance(MISSING_PER_MILLE, 1000):
        xlogp = round(-3.0 + 10.0 * _rng_stream(cid, salt + ":xlogp").u16() / 65535.0, 2)
        lines += [f"> <{PROP_XLOGP}>", f"{xlogp:.2f}", ""]
    return "\n".join(lines) + "\n"


def write(root: Path, seed: int, n_files: int, per_file: int) -> List[Path]:
    """Write the seed's corpus under ``root``: ``compound_{i:05d}.sdf``
    holds cids ``[i * per_file, (i + 1) * per_file)``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    salt = f"bench-corpus:{int(seed)}"
    out = []
    for i in range(n_files):
        path = root / f"compound_{i:05d}.sdf"
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            for cid in range(i * per_file, (i + 1) * per_file):
                f.write(record_text(cid, salt))
                f.write("$$$$\n")
        out.append(path)
    return out
