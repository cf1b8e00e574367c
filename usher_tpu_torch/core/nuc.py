"""Nucleotide encodings.

One-hot nibble encoding: A=0b0001, C=0b0010, G=0b0100, T=0b1000.
Ambiguity (IUPAC) codes set multiple bits; N = 0b1111.
Two-bit index encoding: A=0, C=1, G=2, T=3 (only valid for unambiguous bases).

Semantics match the reference encodings (reference:
src/mutation_annotated_tree.cpp:19-208), including the reference's quirk that
'V' falls through to N (0b1111) in char->id conversion, while id->char still
renders 7 as 'V'.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0b0001, 0b0010, 0b0100, 0b1000, 0b1111

_CHAR_TO_ID = {
    "a": A, "A": A,
    "c": C, "C": C,
    "g": G, "G": G,
    "t": T, "T": T,
    "R": 0b0101,
    "Y": 0b1010,
    "S": 0b0110,
    "W": 0b1001,
    "K": 0b1100,
    "M": 0b0011,
    "B": 0b1110,
    "D": 0b1101,
    "H": 0b1011,
    # NOTE: the reference has a missing `break` after case 'V'
    # (src/mutation_annotated_tree.cpp:65-71), so 'V' maps to N (0b1111).
    "V": N,
    "n": N, "N": N,
}

_ID_TO_CHAR = {
    1: "A", 2: "C", 3: "M", 4: "G", 5: "R", 6: "S", 7: "V",
    8: "T", 9: "W", 10: "Y", 11: "H", 12: "K", 13: "D", 14: "B",
}


def nuc_id_from_char(ch: str) -> int:
    """char -> one-hot nibble (unknown chars -> N). Ref: mutation_annotated_tree.cpp:19."""
    return _CHAR_TO_ID.get(ch, N)


def char_from_nuc_id(nuc_id: int) -> str:
    """one-hot nibble -> IUPAC char (0/15/out-of-range -> 'N'). Ref: mutation_annotated_tree.cpp:88."""
    return _ID_TO_CHAR.get(int(nuc_id), "N")


def nt_from_nuc_id(nuc_id: int) -> int:
    """one-hot nibble -> 2-bit index; -1 for ambiguous. Ref: mutation_annotated_tree.cpp:142."""
    return {1: 0, 2: 1, 4: 2, 8: 3}.get(int(nuc_id), -1)


def nuc_id_from_nt_list(nts) -> int:
    """list of 2-bit indices -> one-hot nibble. Ref: mutation_annotated_tree.cpp:77."""
    ret = 0
    for nt in nts:
        if not (0 <= nt <= 3):
            raise ValueError(f"bad 2-bit nucleotide index {nt}")
        ret |= 1 << nt
    return ret


def nt_list_from_nuc_id(nuc_id: int) -> list[int]:
    """one-hot nibble -> sorted list of 2-bit indices it covers.

    Mirrors get_nuc_vec(get_nuc(id)) of the reference
    (mutation_annotated_tree.cpp:164-208): ids 0 and 15 expand to all four.
    """
    nuc_id = int(nuc_id)
    if nuc_id == 0 or nuc_id == 15:
        return [0, 1, 2, 3]
    return [j for j in range(4) if nuc_id & (1 << j)]


def lowest_set_bit(mask: int) -> int:
    """Lowest one-hot base contained in an allele mask (used when resolving an
    ambiguous sample base to a concrete mutation; ref usher_mapper.cpp:365-370)."""
    return mask & (-mask)


# Vectorized helpers for array pipelines.
CHAR_LUT = np.full(256, N, dtype=np.uint8)
for _ch, _id in _CHAR_TO_ID.items():
    CHAR_LUT[ord(_ch)] = _id
