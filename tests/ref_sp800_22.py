"""Plain reference of NIST SP 800-22 Rev. 1a's binary matrix rank test
(§2.5), in plain ``torch``: the GF(2) rank of each matrix and each
sequence's statistic.  Nothing of the port or of the JAX package.

A matrix is a ``[m, 1]`` int32 column of packed rows: bit c of row r is
entry (r, c), so M = m rows and Q <= 32 columns.
"""

from __future__ import annotations

import torch

# §2.5.4 step 4's constants: the exact p_32 = 0.288788, p_31 = 0.577576 and
# p_<=30 = 0.133636 of a uniform 32 x 32 matrix, rounded
P_FULL, P_ONE_LESS, P_REST = 0.2888, 0.5776, 0.1336


def ranks(words: torch.Tensor) -> torch.Tensor:
    """GF(2) rank of each element of an int32 ``[B, m, 1]`` stack, int64
    ``[B]``: 32 column steps of Gauss-Jordan elimination over the batch.
    Column c's pivot is the first unused row with bit c set; it is XORed
    into every other row with bit c.  Each right shift is masked to one
    bit, so the sign of a word never spreads."""
    rows = words[:, :, 0].clone()
    B, m = rows.shape
    bi = torch.arange(B, device=rows.device)
    used = torch.zeros((B, m), dtype=torch.bool, device=rows.device)
    rank = torch.zeros(B, dtype=torch.int64, device=rows.device)
    for c in range(32):
        bit = ((rows >> c) & 1).bool()
        cand = bit & ~used
        has = cand.any(1)
        piv = cand.to(torch.uint8).argmax(1)
        hit = bit & has[:, None]
        hit[bi, piv] = False
        rows ^= torch.where(hit, rows[bi, piv][:, None], 0)
        used[bi, piv] |= has
        rank += has
    return rank


def statistic(ranks: torch.Tensor, M: int = 32):
    """§2.5.4 for each sequence of ``ranks`` ``[S, N]`` (the ranks of its N
    matrices of M rows): ``(F_M, F_{M-1}, chi2, P)``, the counts as int64
    ``[S]``, chi^2 and the P-value exp(-chi^2 / 2) as float64 ``[S]``."""
    n = ranks.shape[1]
    full = (ranks == M).sum(1)
    one_less = (ranks == M - 1).sum(1)
    rest = n - full - one_less
    chi2 = sum((f.double() - p * n) ** 2 / (p * n) for f, p in
               ((full, P_FULL), (one_less, P_ONE_LESS), (rest, P_REST)))
    return full, one_less, chi2, torch.exp(-chi2 / 2)


def exact_shares(M: int = 32) -> tuple:
    """(p_M, p_{M-1}, p_{<=M-2}) of a uniform M x M matrix over GF(2)
    (§3.5: the probability of rank r)."""
    def p(r):
        prod = 1.0
        for i in range(r):
            prod *= (1 - 2.0 ** (i - M)) ** 2 / (1 - 2.0 ** (i - r))
        return 2.0 ** (r * (2 * M - r) - M * M) * prod
    return p(M), p(M - 1), 1 - p(M) - p(M - 1)

