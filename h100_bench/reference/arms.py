"""What each cache arm stores and reads, as the paper's method defines it.

An arm (the program's cache mode) quantizes K and V to INT4, encodes them
with a codec and flips each stored codeword bit with probability BER when
it is written. ``scrub`` arms correct a word as they write it (every arm
without interpolation); a decode step that collects ECC counts writes the
raw words instead, so that its correcting read has errors to count.
Interpolation replaces a Hamming(8,4) double error by the rounded mean of
its neighbours along the sequence.
"""

from __future__ import annotations

import dataclasses

from .codecs import padded_values


@dataclasses.dataclass(frozen=True)
class Arm:
    mode: str
    codec: str  # int4 | hamming74 | hamming84 | golay
    interp: bool
    scrub: bool

    @property
    def n_bits(self) -> int:
        """Bits of the codeword that a write flip can hit."""
        return {"int4": 4, "hamming74": 7, "hamming84": 8, "golay": 24}[self.codec]

    def scrub_prefill(self) -> bool:
        return self.scrub

    def scrub_decode(self, collect_stats: bool) -> bool:
        return self.scrub and not collect_stats

    def codewords(self, head_dim: int) -> int:
        """Codewords per (token, head) row."""
        pv = padded_values(self.codec, head_dim)
        return pv // 3 if self.codec == "golay" else pv

    def data_words(self, head_dim: int) -> int:
        """int32 words of a row's packed data nibbles."""
        if self.codec == "golay":
            rd = -(-head_dim // 8) * 8
            pv = padded_values("golay", head_dim)
            return (rd if rd <= pv else pv - pv % 8) // 8
        return padded_values(self.codec, head_dim) // 8

    def parity_words(self, head_dim: int) -> int:
        pv = padded_values(self.codec, head_dim)
        row = {"int4": pv // 8, "hamming74": 7 * pv // 32, "hamming84": pv // 4,
               "golay": 3 * (pv // 3) // 4}[self.codec]
        return row - self.data_words(head_dim)

    def read_words(self, head_dim: int, collect_stats: bool) -> int:
        """Words of each context row that a decode step's read needs: the
        data words after a scrubbed write, data and parity otherwise."""
        if self.scrub_decode(collect_stats):
            return self.data_words(head_dim)
        return self.data_words(head_dim) + self.parity_words(head_dim)


ARMS = {
    "int4-write-inject": Arm("int4-write-inject", "int4", False, True),
    "int4-hamming": Arm("int4-hamming", "hamming74", False, True),
    "int4-hamming84": Arm("int4-hamming84", "hamming84", False, True),
    "int4-hamming84-interp": Arm("int4-hamming84-interp", "hamming84", True, False),
    "int12-golay": Arm("int12-golay", "golay", False, True),
}


def arm(mode: str) -> Arm:
    if mode not in ARMS:
        raise ValueError(f"no reference for cache mode '{mode}'; known: {sorted(ARMS)}")
    return ARMS[mode]
