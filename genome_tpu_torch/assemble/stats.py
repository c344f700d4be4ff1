"""Assembly statistics (metrics/observability, SURVEY.md §5.5)."""

from __future__ import annotations


def assembly_stats(contigs: list[str]) -> dict:
    """Standard contig-set stats: counts, total bp, longest, N50/L50."""
    if not contigs:
        return {"n_contigs": 0, "total_bp": 0, "longest": 0,
                "n50": 0, "l50": 0, "mean_len": 0}
    lens = sorted((len(c) for c in contigs), reverse=True)
    total = sum(lens)
    acc = 0
    n50 = l50 = 0
    for i, ln in enumerate(lens):
        acc += ln
        if acc * 2 >= total:
            n50, l50 = ln, i + 1
            break
    return {"n_contigs": len(lens), "total_bp": total, "longest": lens[0],
            "n50": n50, "l50": l50, "mean_len": round(total / len(lens), 1)}
