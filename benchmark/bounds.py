"""Bytes a kernel launch needs at its shapes, and the card's published
peak bandwidth.

`b1_fused_bytes` is a frozen copy of the bytes term of
`chip_smoke.py::score_bounds` ("B1 fused") at commit f18dcaca4b2a: st and
stp [N, P] uint8 read once, seven int32 words per quad of four slots and one
quad count per sample, the reference row [P]; the two [N, B] int32 outputs
and the three [N] int32 row sums written once.  Its operations term rests on
an assumed integer rate, not a published one, so no share of it is taken.
"""

HBM_BYTES_PER_S = 3.35e12     # one H100 SXM, NVIDIA's data sheet


def b1_fused_bytes(N: int, P: int, B: int, K: int) -> int:
    read = 2 * N * P + 4 * 7 * -(-K // 4) * B + 4 * B
    return read + 8 * N * B + P + 12 * N
