"""LaTeX (booktabs) table emitters for publication results (counterpart of
``qkv_ecc_tpu/evaluation/latex_tables.py``): main perplexity table, static
storage-overhead table, throughput table, correction-rate table, error
statistics, and a generic single-metric emitter, written by the
Monte-Carlo CLI into paper_tables.tex and tables/*.tex.

The strings are the JAX module's, character for character, so that the same
aggregated results give the same tables in both packages; that includes
the throughput table's caption and the header comment of
``format_all_latex_tables``, which name the JAX package's origin.
"""

from __future__ import annotations

from typing import List

from .constants import CACHE_MODE_LABELS, CACHE_MODE_ORDER


def _fmt_ppl(agg) -> str:
    if agg is None:
        return "--"
    if agg.ppl_mean == float("inf"):
        return r"$\infty$"
    if agg.ppl_std > 0:
        return f"{agg.ppl_mean:.2f} $\\pm$ {agg.ppl_std:.2f}"
    return f"{agg.ppl_mean:.2f}"


def format_perplexity_table(results, ber_levels=None, caption=None) -> str:
    """Main PPL table: rows = cache modes, cols = BER levels."""
    aggregated = results.aggregated
    if ber_levels is None:
        ber_levels = sorted({b for m in aggregated.values() for b in m})
    caption = caption or "Perplexity under bit errors (mean $\\pm$ std over seeds)."
    cols = "l" + "c" * len(ber_levels)
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        f"\\caption{{{caption}}}",
        r"\label{tab:perplexity}",
        f"\\begin{{tabular}}{{{cols}}}",
        r"\toprule",
        "Cache Mode & "
        + " & ".join(
            f"BER={b:.0e}" if b > 0 else "BER=0" for b in ber_levels
        )
        + r" \\",
        r"\midrule",
    ]
    for mode in CACHE_MODE_ORDER:
        if mode not in aggregated:
            continue
        label = CACHE_MODE_LABELS.get(mode, mode)
        row = [label]
        for ber in ber_levels:
            row.append(_fmt_ppl(aggregated[mode].get(ber)))
        lines.append(" & ".join(row) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def format_storage_overhead_table() -> str:
    """Static storage-overhead table (reference latex_tables.py:261)."""
    rows = [
        ("FP16 (Oracle)", 16, "--", "--"),
        ("FP8 (E4M3)", 8, "+100\\%", "-50\\%"),
        ("INT4 (Unprotected)", 4, "--", "-75\\%"),
        ("Hamming(7,4)", 7, "+75\\%", "-56\\%"),
        ("Hamming(8,4)", 8, "+100\\%", "-50\\%"),
        ("H(8,4)+Interp", 8, "+100\\%", "-50\\%"),
        ("Golay(24,12)", 8, "+100\\%", "-50\\%"),
    ]
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        r"\caption{Storage overhead per cached value.}",
        r"\label{tab:storage}",
        r"\begin{tabular}{lccc}",
        r"\toprule",
        r"Mode & Bits/value & vs INT4 & vs FP16 \\",
        r"\midrule",
    ]
    for name, bits, vs_int4, vs_fp16 in rows:
        lines.append(f"{name} & {bits} & {vs_int4} & {vs_fp16} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def format_throughput_table(rows: List[dict] | None = None) -> str:
    """Kernel throughput table; placeholder text when no measurements
    (reference emits an unfilled placeholder, results/*/tables/throughput.tex)."""
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        r"\caption{Codec kernel throughput (TPU).}",
        r"\label{tab:throughput}",
        r"\begin{tabular}{lccc}",
        r"\toprule",
        r"Codec & Encode (Mval/s) & Decode (Mval/s) & BW eff. (\%) \\",
        r"\midrule",
    ]
    if not rows:
        lines.append(r"\multicolumn{4}{c}{Run the latency benchmark to populate} \\")
    else:
        for r in rows:
            lines.append(
                f"{r['codec']} & {r['encode_mvals']:.0f} & "
                f"{r['decode_mvals']:.0f} & {r.get('bw_eff', 0):.1f} \\\\"
            )
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def format_correction_rate_table(results, ber: float = 1e-2) -> str:
    """Per-mode correction/detection rates at one BER."""
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        f"\\caption{{Error correction statistics at BER={ber:.0e}.}}",
        r"\label{tab:correction}",
        r"\begin{tabular}{lccc}",
        r"\toprule",
        r"Mode & Corrected & Detected & Correction rate \\",
        r"\midrule",
    ]
    for mode in CACHE_MODE_ORDER:
        agg = results.get_aggregated(mode, ber)
        if agg is None:
            continue
        total = agg.errors_corrected_mean + agg.errors_detected_mean
        rate = 100.0 * agg.errors_corrected_mean / total if total else 0.0
        lines.append(
            f"{CACHE_MODE_LABELS.get(mode, mode)} & "
            f"{agg.errors_corrected_mean:,.0f} & "
            f"{agg.errors_detected_mean:,.0f} & {rate:.2f}\\% \\\\"
        )
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def format_error_stats_table(results, ber_levels=None) -> str:
    """Errors corrected/detected per mode across BER levels."""
    aggregated = results.aggregated
    if ber_levels is None:
        ber_levels = sorted({b for m in aggregated.values() for b in m if b > 0})
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        r"\caption{Cumulative errors corrected / detected.}",
        r"\label{tab:errorstats}",
        "\\begin{tabular}{l" + "c" * len(ber_levels) + "}",
        r"\toprule",
        "Mode & " + " & ".join(f"BER={b:.0e}" for b in ber_levels) + r" \\",
        r"\midrule",
    ]
    for mode in CACHE_MODE_ORDER:
        if mode not in aggregated:
            continue
        row = [CACHE_MODE_LABELS.get(mode, mode)]
        for ber in ber_levels:
            agg = aggregated[mode].get(ber)
            if agg is None:
                row.append("--")
            else:
                row.append(
                    f"{agg.errors_corrected_mean:,.0f} / "
                    f"{agg.errors_detected_mean:,.0f}"
                )
        lines.append(" & ".join(row) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def format_metric_table(
    results, metric: str, caption: str, fmt: str = "{:.4f}", ber_levels=None
) -> str:
    """Generic single-metric table (reference latex_tables.py:528)."""
    aggregated = results.aggregated
    if ber_levels is None:
        ber_levels = sorted({b for m in aggregated.values() for b in m})
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        f"\\caption{{{caption}}}",
        "\\begin{tabular}{l" + "c" * len(ber_levels) + "}",
        r"\toprule",
        "Mode & "
        + " & ".join(f"BER={b:.0e}" if b else "BER=0" for b in ber_levels)
        + r" \\",
        r"\midrule",
    ]
    for mode in CACHE_MODE_ORDER:
        if mode not in aggregated:
            continue
        row = [CACHE_MODE_LABELS.get(mode, mode)]
        for ber in ber_levels:
            agg = aggregated[mode].get(ber)
            row.append(fmt.format(getattr(agg, metric)) if agg else "--")
        lines.append(" & ".join(row) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def format_all_latex_tables(results) -> str:
    """All tables concatenated (paper_tables.tex content)."""
    parts = [
        "% Auto-generated by qkv_ecc_tpu.evaluation.latex_tables",
        format_perplexity_table(results),
        "",
        format_storage_overhead_table(),
        "",
        format_correction_rate_table(results),
        "",
        format_error_stats_table(results),
        "",
        format_metric_table(
            results, "kl_divergence_mean", "KL divergence vs FP16 oracle (nats)."
        ),
        "",
        format_metric_table(
            results, "top5_accuracy_mean", "Top-5 accuracy.", fmt="{:.3f}"
        ),
        "",
        format_throughput_table(),
    ]
    return "\n".join(parts)
