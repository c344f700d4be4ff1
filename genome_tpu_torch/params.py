"""Assembly parameters — the single frozen config object (SURVEY.md §5.6).

Every semantic free parameter of the pipeline lives here so that a params
hash fully identifies the contract a contig set was produced under
(reference analog: CLI args of the Scala entry point, SURVEY.md §2.1 R11).
Default pins follow SURVEY.md §8 (Q1-Q5); re-verify against the reference
source when it becomes readable.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


@dataclasses.dataclass(frozen=True)
class AssemblyParams:
    """Pinned assembly semantics. See SEMANTICS.md for the full contract.

    Attributes:
      k: k-mer length. Must be odd (no palindromic k-mers, SURVEY §8.Q1)
         and 1 < k <= 32 (fits 2k bits in a uint64 / uint32-pair).
      min_coverage: minimum multiplicity for a canonical k-mer to survive
         counting (SURVEY §8.Q3; default 2).
      tip_len: maximum node-length of a chain removed as a tip; None means
         the derived default 2*k (SURVEY §8.Q4).
      bubble_len: maximum node-length of a bubble side; None means the
         derived default 2*k + 1 (SURVEY §8.Q4).
      max_rounds: bound on simplification rounds (fixpoint usually reached
         far earlier; bound keeps device loops static-friendly).
      min_contig_len: drop output contigs shorter than this many bases
         (0 = keep all; parity runs keep all).
    """

    k: int = 21
    min_coverage: int = 2
    tip_len: int | None = None
    bubble_len: int | None = None
    max_rounds: int = 64
    min_contig_len: int = 0

    def __post_init__(self) -> None:
        if not (1 < self.k <= 32):
            raise ValueError(f"k must be in (1, 32], got {self.k}")
        if self.k % 2 == 0:
            raise ValueError(f"k must be odd (palindrome-free), got {self.k}")
        if self.min_coverage < 1:
            raise ValueError("min_coverage must be >= 1")

    @property
    def tip_len_eff(self) -> int:
        return 2 * self.k if self.tip_len is None else self.tip_len

    @property
    def bubble_len_eff(self) -> int:
        return 2 * self.k + 1 if self.bubble_len is None else self.bubble_len

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tip_len"] = self.tip_len_eff
        d["bubble_len"] = self.bubble_len_eff
        return d

    def params_hash(self) -> str:
        """Stable hash identifying the exact assembly semantics."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    @classmethod
    def from_dict(cls, d: dict) -> "AssemblyParams":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
