"""Algebraic verification of the ECC codecs (counterpart of
``qkv_ecc_tpu/evaluation/verification.py``): machine-checkable proofs that
the implemented codes are valid linear codes with the claimed correction
properties - GF(2) null-space and orthogonality checks, basis independence
(rank), exhaustive single/double-bit error-amplification sweeps with a
zero-miscorrection gate for SECDED, and Golay 1/2/3-bit correction sweeps.

It is algebra, not a device path: the matrices in numpy, the codecs
(``codecs/reference.py``) on CPU tensors.

    python -m qkv_ecc_tpu_torch.evaluation.verification
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict

import numpy as np
import torch

from ..codecs import algebra as A
from ..codecs.reference import (
    ErrorType,
    golay_decode,
    golay_encode,
    hamming74_decode,
    hamming74_encode,
    hamming84_decode,
    hamming84_encode,
)


def gf2_rank(m: np.ndarray) -> int:
    """Row-echelon rank over GF(2)."""
    m = m.copy().astype(np.uint8) % 2
    rank = 0
    rows, cols = m.shape
    for col in range(cols):
        pivot = None
        for r in range(rank, rows):
            if m[r, col]:
                pivot = r
                break
        if pivot is None:
            continue
        m[[rank, pivot]] = m[[pivot, rank]]
        for r in range(rows):
            if r != rank and m[r, col]:
                m[r] ^= m[rank]
        rank += 1
        if rank == rows:
            break
    return rank


def verify_null_space_condition(G: np.ndarray, H: np.ndarray) -> bool:
    """Every codeword c = dG satisfies Hc = 0 (all 2^k messages)."""
    k = G.shape[0]
    msgs = np.array(
        [[(m >> i) & 1 for i in range(k)] for m in range(2**k)], dtype=np.uint8
    )
    codewords = (msgs @ G) % 2
    return bool((((codewords @ H.T) % 2) == 0).all())


def verify_subspace_orthogonality(G: np.ndarray, H: np.ndarray) -> bool:
    return bool(((G.astype(int) @ H.astype(int).T) % 2 == 0).all())


def verify_basis_independence(G: np.ndarray) -> bool:
    return gf2_rank(G) == G.shape[0]


@dataclasses.dataclass
class AmplificationResult:
    total_cases: int
    corrected: int
    detected: int
    miscorrected: int

    @property
    def miscorrection_rate(self) -> float:
        return self.miscorrected / self.total_cases if self.total_cases else 0.0


def _messages():
    return torch.arange(16, dtype=torch.uint8)


def compute_error_amplification_hamming74() -> AmplificationResult:
    """Exhaustive single-bit flips over all 16 messages: every flip must be
    corrected back exactly."""
    vals = _messages()
    cw = hamming74_encode(vals)
    total = corrected = miscorrected = 0
    for bit in range(7):
        data, _, _ = hamming74_decode(cw ^ (1 << bit))
        ok = data == vals
        total += 16
        corrected += int(ok.sum())
        miscorrected += int((~ok).sum())
    return AmplificationResult(total, corrected, 0, miscorrected)


def compute_error_amplification_hamming84() -> Dict[str, AmplificationResult]:
    """Exhaustive 1- and 2-bit flips; the SECDED gate is miscorrection == 0:
    singles corrected exactly, doubles always classified DOUBLE_DETECTED."""
    vals = _messages()
    cw = hamming84_encode(vals)

    s_total = s_ok = s_mis = 0
    for bit in range(8):
        data, _, _, _ = hamming84_decode(cw ^ (1 << bit))
        ok = data == vals
        s_total += 16
        s_ok += int(ok.sum())
        s_mis += int((~ok).sum())
    single = AmplificationResult(s_total, s_ok, 0, s_mis)

    d_total = d_detected = d_mis = 0
    for b1 in range(8):
        for b2 in range(b1 + 1, 8):
            _, et, _, _ = hamming84_decode(cw ^ ((1 << b1) | (1 << b2)))
            d_total += 16
            d_detected += int((et == ErrorType.DOUBLE_DETECTED).sum())
            # a "miscorrection" is a double error classified as corrected
            d_mis += int((et == ErrorType.SINGLE_CORRECTED).sum())
    double = AmplificationResult(d_total, 0, d_detected, d_mis)
    return {"single": single, "double": double}


def verify_golay2412(n_random: int = 64, seed: int = 0) -> Dict[str, bool]:
    """Golay correction sweeps: exhaustive weight-1 (24 patterns) and
    weight-2 (all C(24,2)=276 patterns) over a codeword battery, exhaustive
    weight-3 (all C(24,3)=2024 patterns) over a 16-codeword battery, plus
    the randomized weight-3 spot check on the full battery; the battery and
    the spot check's patterns are the JAX function's draws from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    trip = torch.from_numpy(rng.integers(0, 16, (n_random, 3), dtype=np.uint8))
    cw = golay_encode(trip)
    results = {}

    def sweep(pats, battery_cw, battery_trip):
        """Decode battery ^ every pattern at once: [P, N] codewords."""
        pats = torch.as_tensor(np.asarray(pats, np.int64)).to(torch.int32)
        rx = battery_cw[None, :] ^ pats[:, None]
        dec, _, _, unc = golay_decode(rx.reshape(-1))
        want = battery_trip[None].expand((len(pats),) + tuple(battery_trip.shape)).reshape(-1, 3)
        return bool(torch.equal(dec, want)) and int(unc) == 0

    results["corrects_1bit"] = sweep([1 << b for b in range(24)], cw, trip)
    w2 = [(1 << a) | (1 << b) for a, b in itertools.combinations(range(24), 2)]
    results["corrects_2bit_exhaustive"] = sweep(w2, cw, trip)
    w3 = [
        (1 << a) | (1 << b) | (1 << c)
        for a, b, c in itertools.combinations(range(24), 3)
    ]
    results["corrects_3bit_exhaustive"] = sweep(w3, cw[:16], trip[:16])
    flips = np.zeros(n_random, dtype=np.int64)
    for r in range(n_random):
        for b in rng.choice(24, size=3, replace=False):
            flips[r] |= 1 << int(b)
    dec, _, _, unc = golay_decode(cw ^ torch.from_numpy(flips).to(torch.int32))
    results["corrects_3bit"] = bool(torch.equal(dec, trip)) and int(unc) == 0
    return results


@dataclasses.dataclass
class VerificationReport:
    checks: Dict[str, bool]
    amplification: Dict[str, AmplificationResult]
    all_passed: bool

    def format(self) -> str:
        lines = ["=" * 60, "ALGEBRAIC VERIFICATION REPORT", "=" * 60]
        for name, ok in self.checks.items():
            lines.append(f"  [{'PASS' if ok else 'FAIL'}] {name}")
        for name, amp in self.amplification.items():
            lines.append(
                f"  {name}: {amp.total_cases} cases, "
                f"corrected={amp.corrected} detected={amp.detected} "
                f"miscorrected={amp.miscorrected} "
                f"(rate {amp.miscorrection_rate:.4f})"
            )
        lines.append("=" * 60)
        lines.append("ALL PASSED" if self.all_passed else "FAILURES PRESENT")
        return "\n".join(lines)


def _secded_matrices():
    """Hamming(8,4)'s G and H: G extended with the overall-parity column
    (bit 7 = parity of bits 0-6, so a codeword's parity is even), H with the
    all-ones parity row."""
    g84 = np.concatenate(
        [A.HAMMING74_G, (A.HAMMING74_G.sum(axis=1) % 2)[:, None]], axis=1
    ).astype(np.uint8)
    h84 = np.concatenate(
        [
            np.concatenate(
                [A.HAMMING74_H, np.zeros((A.HAMMING74_H.shape[0], 1), np.uint8)], axis=1
            ),
            np.ones((1, 8), np.uint8),
        ],
        axis=0,
    )
    return g84, h84


def run_all_verifications() -> VerificationReport:
    """The full suite."""
    checks = {}
    checks["h74_null_space"] = verify_null_space_condition(A.HAMMING74_G, A.HAMMING74_H)
    checks["h74_orthogonality"] = verify_subspace_orthogonality(A.HAMMING74_G, A.HAMMING74_H)
    checks["h74_basis_independence"] = verify_basis_independence(A.HAMMING74_G)
    g84, h84 = _secded_matrices()
    checks["h84_null_space"] = verify_null_space_condition(g84, h84)
    checks["h84_orthogonality"] = verify_subspace_orthogonality(g84, h84)
    checks["h84_basis_independence"] = verify_basis_independence(g84)
    # the extended G must agree with the implemented encoder on all 16
    # messages (ties the algebra to the bit layout)
    msgs = np.array([[(m >> i) & 1 for i in range(4)] for m in range(16)], np.uint8)
    cw_alg = (msgs @ g84) % 2
    cw_impl = hamming84_encode(_messages()).numpy()
    cw_impl_bits = (cw_impl[:, None] >> np.arange(8)[None, :]) & 1
    checks["h84_encoder_matches_G"] = bool((cw_alg == cw_impl_bits).all())
    checks["golay_null_space"] = verify_null_space_condition(A.GOLAY_G, A.GOLAY_H)
    checks["golay_orthogonality"] = verify_subspace_orthogonality(A.GOLAY_G, A.GOLAY_H)
    checks["golay_basis_independence"] = verify_basis_independence(A.GOLAY_G)
    checks["golay_b_involutory"] = bool(
        ((A.GOLAY_B_MATRIX.astype(int) @ A.GOLAY_B_MATRIX.astype(int)) % 2
         == np.eye(12, dtype=int)).all()
    )

    amp = {}
    h74 = compute_error_amplification_hamming74()
    amp["hamming74_single"] = h74
    checks["h74_all_singles_corrected"] = h74.miscorrected == 0

    h84 = compute_error_amplification_hamming84()
    amp["hamming84_single"] = h84["single"]
    amp["hamming84_double"] = h84["double"]
    checks["h84_all_singles_corrected"] = h84["single"].miscorrected == 0
    # the SECDED gate: zero miscorrections on doubles
    checks["h84_zero_double_miscorrection"] = h84["double"].miscorrected == 0
    checks["h84_all_doubles_detected"] = h84["double"].detected == h84["double"].total_cases

    for k, v in verify_golay2412().items():
        checks[f"golay_{k}"] = v

    return VerificationReport(checks=checks, amplification=amp, all_passed=all(checks.values()))


if __name__ == "__main__":
    report = run_all_verifications()
    print(report.format())
    raise SystemExit(0 if report.all_passed else 1)
