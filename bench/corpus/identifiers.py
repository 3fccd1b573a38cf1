"""Molecular identifiers: canonical full ids and hashed keys (a frozen copy
of the port's ``core/identifiers.py``: the benchmark makes its corpus with
it, and the program under test re-derives and verifies the ids).

This module is the reproduction of the paper's identifier layer (§II.C,
§VI).  Real chemistry uses InChI (canonical, deterministic, verbose) and
InChIKey (a SHA-256-derived 27-character digest).  We reproduce the exact
*system properties* that matter to the paper:

* ``canonical_id``   — a deterministic, collision-free canonical string
  derived purely from molecular structure (the "full InChI" role).  Two
  structures are identical iff their canonical ids are identical.
* ``hashed_key``     — a 27-character, SHA-256-derived digest of the
  canonical id formatted exactly like an InChIKey
  (``XXXXXXXXXXXXXX-YYYYYYYYSA-N``).  The effective hash width is
  configurable (``bits``) so that the paper's hundred-million-scale
  collision phenomenology (§VI.B, Eq. 4/5) can be observed and measured at
  container-scale corpora: the paper's h ≈ 1e15 (~50 bits) with n = 1.77e8
  records is expectation-equivalent to ~28 bits at n = 1e5 records.
* ``molecule_from_cid`` — a deterministic synthetic molecule generator:
  the structure (and therefore the canonical id) is a pure function of the
  integer compound id, which makes terabyte-scale corpora reproducible
  from a single integer range.

The derivation chain mirrors the paper's: structure → InChI → InChIKey,
with ``canonical_id_from_structure`` playing the role of "recompute the
molecule's InChI from its structural data using RDKit" (Algorithm 3,
lines 8–12).
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = [
    "Molecule",
    "molecule_from_cid",
    "canonical_id",
    "canonical_id_from_structure",
    "hashed_key",
    "DEFAULT_KEY_BITS",
    "PAPER_KEY_BITS",
]

# The paper (Eq. 5) models InChIKey space as h ~ 1e15 => ~50 bits.
PAPER_KEY_BITS = 50
# Full-strength default for production use (14 base-26 chars ~ 65.8 bits
# of the connectivity block alone; we cap at 64 for packing convenience).
DEFAULT_KEY_BITS = 64

_ELEMENTS = ("C", "N", "O", "S", "P", "F", "Cl", "Br")
# Rough valence budget per element, used to keep generated structures
# internally consistent (H counts are derived, not random).
_VALENCE = {"C": 4, "N": 3, "O": 2, "S": 2, "P": 3, "F": 1, "Cl": 1, "Br": 1}

_B26 = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


@dataclass(frozen=True)
class Molecule:
    """A synthetic molecule: a connected multigraph with stereo tags.

    ``atoms``  — element symbol per atom (canonical order).
    ``bonds``  — (a, b, order, stereo) with a < b, canonically sorted.
    ``hcount`` — implicit hydrogens per atom (valence - bond order sum).
    """

    atoms: Tuple[str, ...]
    bonds: Tuple[Tuple[int, int, int, int], ...]
    hcount: Tuple[int, ...] = field(default=())

    @property
    def natoms(self) -> int:
        return len(self.atoms)

    @property
    def nbonds(self) -> int:
        return len(self.bonds)


def _rng_stream(cid: int, salt: str) -> "_Sha256Stream":
    return _Sha256Stream(f"{salt}:{cid}".encode())


class _Sha256Stream:
    """Cheap deterministic random stream from iterated SHA-256.

    Independent of Python's global RNG so corpora are reproducible across
    processes and library versions (critical for the multi-worker index
    construction tests).
    """

    __slots__ = ("_buf", "_pos", "_seed", "_ctr")

    def __init__(self, seed: bytes):
        self._seed = seed
        self._ctr = 0
        self._buf = b""
        self._pos = 0

    def _refill(self) -> None:
        self._buf = hashlib.sha256(self._seed + struct.pack("<Q", self._ctr)).digest()
        self._ctr += 1
        self._pos = 0

    def u8(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        v = self._buf[self._pos]
        self._pos += 1
        return v

    def u16(self) -> int:
        return self.u8() | (self.u8() << 8)

    def randint(self, lo: int, hi: int) -> int:
        """Uniform integer in [lo, hi] (inclusive); hi-lo < 65536."""
        span = hi - lo + 1
        return lo + self.u16() % span

    def chance(self, num: int, den: int) -> bool:
        return self.u16() % den < num


# cid→structure injectivity: a backbone chain encodes the cid in base 4
# over chainable elements (valence ≥ 2), so two distinct cids can never
# produce identical structures (and therefore never identical canonical
# ids) — PubChem CIDs likewise map 1:1 to structures.
_DIGIT_ELEMENTS = ("C", "N", "O", "S")
_CID_CHAIN_LEN = 15  # 4**15 ≈ 1.07e9 > PubChem scale (1.77e8)


def molecule_from_cid(cid: int, salt: str = "repro-corpus-v1") -> Molecule:
    """Deterministically synthesize a molecule for compound id ``cid``.

    Structure: a cid-encoding backbone chain (injectivity guarantee)
    followed by a random spanning tree of 4..28 extra heavy atoms plus a
    few ring-closure bonds, with bond orders and stereo tags.  The
    construction is canonical by construction (atom indices are the
    canonical numbering), so ``canonical_id`` is well-defined and
    recomputable from the serialized structure alone.
    """
    if not 0 <= cid < 4 ** _CID_CHAIN_LEN:
        raise ValueError(f"cid out of range: {cid}")
    rng = _rng_stream(cid, salt)

    # --- backbone: base-4 digits of cid as a linear chain -----------------
    atoms: List[str] = []
    v = cid
    for _ in range(_CID_CHAIN_LEN):
        atoms.append(_DIGIT_ELEMENTS[v % 4])
        v //= 4
    nc = len(atoms)
    remaining = [_VALENCE[a] for a in atoms]
    bonds: List[Tuple[int, int, int, int]] = []
    for i in range(1, nc):
        bonds.append((i - 1, i, 1, 0))
        remaining[i - 1] -= 1
        remaining[i] -= 1

    # --- random decoration ------------------------------------------------
    n = nc + rng.randint(4, 28)
    for _ in range(n - nc):
        r = rng.u8()
        # Organic-like composition: mostly carbon.
        if r < 160:
            atoms.append("C")
        else:
            atoms.append(_ELEMENTS[1 + rng.u8() % (len(_ELEMENTS) - 1)])
    remaining += [_VALENCE[a] for a in atoms[nc:]]

    # Spanning tree: attach atom i to a previous atom with spare valence.
    for i in range(nc, n):
        # pick parent among previous atoms with remaining valence
        tries = 0
        j = rng.randint(0, i - 1)
        while remaining[j] < 1 and tries < 2 * i:
            j = (j + 1) % i
            tries += 1
        if remaining[j] < 1 or remaining[i] < 1:
            j = 0  # degenerate fallback; still a valid graph
        order = 1
        if remaining[i] >= 2 and remaining[j] >= 2 and rng.chance(1, 5):
            order = 2
        stereo = 1 if (order == 1 and rng.chance(1, 8)) else 0
        a, b = (j, i) if j < i else (i, j)
        bonds.append((a, b, order, stereo))
        remaining[i] -= order
        remaining[j] -= order

    # A few ring closures.
    nrings = rng.randint(0, 2)
    for _ in range(nrings):
        a = rng.randint(0, n - 1)
        b = rng.randint(0, n - 1)
        if a == b:
            continue
        a, b = (a, b) if a < b else (b, a)
        if remaining[a] >= 1 and remaining[b] >= 1 and not any(
            (a, b) == (x, y) for x, y, _, _ in bonds
        ):
            bonds.append((a, b, 1, 0))
            remaining[a] -= 1
            remaining[b] -= 1

    bonds.sort()
    hcount = tuple(max(0, r) for r in remaining)
    return Molecule(atoms=tuple(atoms), bonds=tuple(bonds), hcount=hcount)


def _formula(mol: Molecule) -> str:
    """Hill-order molecular formula (C first, H second, rest alphabetical)."""
    counts: dict = {}
    for a in mol.atoms:
        counts[a] = counts.get(a, 0) + 1
    h = sum(mol.hcount)
    parts: List[str] = []
    if "C" in counts:
        parts.append(f"C{counts.pop('C')}")
        if h:
            parts.append(f"H{h}")
        for el in sorted(counts):
            parts.append(f"{el}{counts[el]}")
    else:
        if h:
            counts["H"] = h
        for el in sorted(counts):
            parts.append(f"{el}{counts[el]}")
    return "".join(parts)


def canonical_id(mol: Molecule) -> str:
    """Canonical full identifier (the "full InChI" role).

    Layered like InChI: formula ``/c`` connectivity ``/h`` hydrogens and an
    optional ``/t`` stereo layer.  Injective over the molecule structures we
    generate: every atom, bond, order, H-count and stereo tag is serialized.
    """
    conn = ",".join(
        f"{a + 1}-{b + 1}" + (f"*{o}" if o != 1 else "")
        for a, b, o, _ in mol.bonds
    )
    hs = ",".join(str(h) for h in mol.hcount)
    elems = "".join(
        a if len(a) == 1 else a for a in mol.atoms
    )  # positional element string disambiguates formula-equal isomers
    s = f"InChI=1S/{_formula(mol)}/e{elems}/c{conn}/h{hs}"
    stereo = [i for i, (_, _, _, st) in enumerate(mol.bonds) if st]
    if stereo:
        s += "/t" + ",".join(str(i + 1) for i in stereo)
    return s


def hashed_key(full_id: str, bits: int = DEFAULT_KEY_BITS) -> str:
    """27-character InChIKey-style digest of a canonical id.

    SHA-256 over the canonical id, truncated to ``bits`` effective bits,
    then base-26 encoded into the standard 14-8 block layout with the
    constant ``SA-N`` suffix (standard InChIKey flag/proton chars).  With
    ``bits`` = 50 this models the paper's h ≈ 1e15 key space (Eq. 5).
    """
    if not 8 <= bits <= 64:
        raise ValueError(f"bits must be in [8, 64], got {bits}")
    digest = hashlib.sha256(full_id.encode()).digest()
    v = int.from_bytes(digest[:8], "big")
    if bits < 64:
        v &= (1 << bits) - 1
    # 22 base-26 chars hold ~103 bits >= 64: encode v into 22 chars.
    chars = []
    for _ in range(22):
        chars.append(_B26[v % 26])
        v //= 26
    block = "".join(reversed(chars))
    return f"{block[:14]}-{block[14:22]}SA-N"


# ---------------------------------------------------------------------------
# Structure serialization (molfile-ish) and re-derivation.
# ---------------------------------------------------------------------------

def structure_block(mol: Molecule) -> str:
    """Serialize a molecule as a V2000-flavoured ctab block.

    Atom lines carry the element and implicit-H count; bond lines carry
    (a, b, order, stereo).  ``canonical_id_from_structure`` re-derives the
    canonical id from exactly this text, which is what makes Algorithm 3's
    defensive verification meaningful (recompute-and-compare).
    """
    lines = [f"{mol.natoms:3d}{mol.nbonds:3d}  0  0  0  0  0  0  0999 V2000"]
    for el, h in zip(mol.atoms, mol.hcount):
        lines.append(f"    0.0000    0.0000    0.0000 {el:<3s} {h:2d}")
    for a, b, o, st in mol.bonds:
        lines.append(f"{a + 1:3d}{b + 1:3d}{o:3d}{st:3d}")
    lines.append("M  END")
    return "\n".join(lines)


def parse_structure_block(text: str) -> Molecule:
    """Inverse of :func:`structure_block` (tolerates surrounding SDF text)."""
    lines = text.splitlines()
    # find the counts line: ends with V2000
    start = None
    for i, ln in enumerate(lines):
        if ln.rstrip().endswith("V2000"):
            start = i
            break
    if start is None:
        raise ValueError("no V2000 counts line found")
    counts = lines[start]
    natoms = int(counts[0:3])
    nbonds = int(counts[3:6])
    atoms: List[str] = []
    hcount: List[int] = []
    for ln in lines[start + 1 : start + 1 + natoms]:
        parts = ln.split()
        atoms.append(parts[3])
        hcount.append(int(parts[4]))
    bonds: List[Tuple[int, int, int, int]] = []
    for ln in lines[start + 1 + natoms : start + 1 + natoms + nbonds]:
        a = int(ln[0:3]) - 1
        b = int(ln[3:6]) - 1
        o = int(ln[6:9])
        st = int(ln[9:12])
        bonds.append((a, b, o, st))
    return Molecule(atoms=tuple(atoms), bonds=tuple(bonds), hcount=tuple(hcount))


def canonical_id_from_structure(record_text: str) -> str:
    """Recompute the canonical id from a record's structural data.

    The reproduction of "recompute the molecule's InChI from its structural
    data using RDKit's canonical InChI generation" — the verification step
    that surfaced the paper's hash collisions.
    """
    return canonical_id(parse_structure_block(record_text))
