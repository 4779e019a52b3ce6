"""Diagnostic report assembly + JSON/markdown/HTML rendering (a copy of
photon_ml_tpu/diagnostics/report.py: equal reports render byte-equal).

Replaces the reference's HTML reporting framework (photon-diagnostics/
.../diagnostics/reporting/ — LogicalReport -> PhysicalReport -> xchart/batik
HTML, ~1500 LoC).  The ANALYSES carry the value; rendering is JSON +
markdown + one SELF-CONTAINED html file (inline CSS + inline SVG charts,
no plotting stack, closing VERDICT r4 coverage item #95).  Assembled per
the legacy driver's diagnose stage (Driver.scala:468-607): metrics +
Hosmer-Lemeshow + bootstrap + feature importance + fitting curves +
prediction-error independence.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from photon_ml_tpu_torch.diagnostics.bootstrap import BootstrapReport
from photon_ml_tpu_torch.diagnostics.fitting import FittingReport
from photon_ml_tpu_torch.diagnostics.hl import HosmerLemeshowReport
from photon_ml_tpu_torch.diagnostics.importance import FeatureImportanceReport
from photon_ml_tpu_torch.diagnostics.independence import KendallTauReport


@dataclasses.dataclass
class DiagnosticReport:
    task_type: str
    metrics: Dict[str, float]
    feature_importance: Optional[FeatureImportanceReport] = None
    hosmer_lemeshow: Optional[HosmerLemeshowReport] = None
    independence: Optional[KendallTauReport] = None
    bootstrap: Optional[BootstrapReport] = None
    fitting: Optional[FittingReport] = None

    def to_dict(self) -> dict:
        d = {"task_type": self.task_type, "metrics": self.metrics}
        if self.feature_importance is not None:
            d["feature_importance"] = self.feature_importance.to_dict()
        if self.hosmer_lemeshow is not None:
            d["hosmer_lemeshow"] = self.hosmer_lemeshow.to_dict()
        if self.independence is not None:
            d["independence"] = self.independence.to_dict()
        if self.bootstrap is not None:
            d["bootstrap"] = self.bootstrap.to_dict()
        if self.fitting is not None:
            d["fitting"] = self.fitting.to_dict()
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def render_markdown(report: DiagnosticReport) -> str:
    """Markdown rendering of the full report (the reference renders chapters/
    sections/plots to HTML; same structure, portable format)."""
    lines: List[str] = [f"# Model diagnostic report ({report.task_type})", ""]

    lines += ["## Metrics", "", "| metric | value |", "|---|---|"]
    for k, v in sorted(report.metrics.items()):
        lines.append(f"| {k} | {v:.6g} |")
    lines.append("")

    if report.feature_importance is not None:
        fi = report.feature_importance
        lines += [f"## Feature importance ({fi.importance_type})", "",
                  "| rank | feature | importance |", "|---|---|---|"]
        for rank, (feat, _idx, imp) in enumerate(fi.top(20), 1):
            lines.append(f"| {rank} | {feat} | {imp:.6g} |")
        lines.append("")

    if report.hosmer_lemeshow is not None:
        hl = report.hosmer_lemeshow
        lines += ["## Hosmer-Lemeshow calibration", "",
                  f"- chi-squared: {hl.chi_squared:.4f} "
                  f"({hl.degrees_of_freedom} dof)",
                  f"- P(chi2 <= observed): {hl.prob_at_chi_square:.4f} "
                  f"(p-value {hl.p_value:.4f})", ""]
        lines += ["| bin | expected + | observed + | expected - | observed - |",
                  "|---|---|---|---|---|"]
        for b in hl.bins:
            lines.append(f"| [{b.lower:.2f}, {b.upper:.2f}) | "
                         f"{b.expected_pos:.1f} | {b.observed_pos:.0f} | "
                         f"{b.expected_neg:.1f} | {b.observed_neg:.0f} |")
        if hl.warnings:
            lines += ["", f"warnings: {len(hl.warnings)} sparse bins"]
        lines.append("")

    if report.independence is not None:
        kt = report.independence
        lines += ["## Prediction-error independence (Kendall tau)", "",
                  f"- tau-alpha: {kt.tau_alpha:.4f}, tau-beta: {kt.tau_beta:.4f}",
                  f"- z: {kt.z_alpha:.3f}, two-sided probability: {kt.p_value:.4f}"]
        if kt.message:
            lines.append(f"- note: {kt.message}")
        lines.append("")

    if report.bootstrap is not None:
        bs = report.bootstrap
        lines += ["## Bootstrap confidence intervals", "",
                  f"- replicas: {bs.num_samples}",
                  f"- coefficients with IQR excluding zero: "
                  f"{int(bs.significant_mask.sum())} / "
                  f"{len(bs.coefficient_summaries)}", "",
                  "| metric | q1 | median | q3 |", "|---|---|---|---|"]
        for k, s in sorted(bs.metric_summaries.items()):
            lines.append(f"| {k} | {s.q1:.6g} | {s.median:.6g} | {s.q3:.6g} |")
        lines.append("")

    if report.fitting is not None and report.fitting.metrics:
        lines += ["## Learning curves", ""]
        for metric, curve in sorted(report.fitting.metrics.items()):
            lines += [f"### {metric}", "",
                      "| train % | train | holdout |", "|---|---|---|"]
            for p, tr, te in zip(curve["portions"], curve["train"],
                                 curve["test"]):
                lines.append(f"| {p:.1f} | {tr:.6g} | {te:.6g} |")
            lines.append("")
    elif report.fitting is not None:
        lines += ["## Learning curves", "", report.fitting.message, ""]

    return "\n".join(lines)


# ---------------------------------------------------------------------------
# self-contained HTML rendering (inline CSS + inline SVG, no plotting stack)
# ---------------------------------------------------------------------------

# categorical slots 1-2 of the skill-validated default palette (CVD-checked),
# stepped separately for light and dark surfaces; text wears ink tokens only
_CSS = """
:root { color-scheme: light dark;
  --surface: #ffffff; --ink: #1a1a19; --ink-2: #5f5e56; --grid: #e4e3dd;
  --s1: #2a78d6; --s2: #eb6834; }
@media (prefers-color-scheme: dark) { :root {
  --surface: #1a1a19; --ink: #ffffff; --ink-2: #c3c2b7; --grid: #3a3936;
  --s1: #3987e5; --s2: #d95926; } }
body { background: var(--surface); color: var(--ink); margin: 2rem auto;
  max-width: 60rem; padding: 0 1rem;
  font: 14px/1.5 system-ui, -apple-system, sans-serif; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.1rem; margin-top: 2rem; }
h3 { font-size: 0.95rem; color: var(--ink-2); }
table { border-collapse: collapse; margin: 0.5rem 0; }
th, td { text-align: left; padding: 0.25rem 0.9rem 0.25rem 0;
  border-bottom: 1px solid var(--grid); font-variant-numeric: tabular-nums; }
th { color: var(--ink-2); font-weight: 600; }
.note { color: var(--ink-2); }
svg text { fill: var(--ink-2); font: 11px system-ui, sans-serif; }
svg .lbl { fill: var(--ink); }
svg line.grid { stroke: var(--grid); stroke-width: 1; }
.legend span { margin-right: 1.2rem; }
.legend i { display: inline-block; width: 10px; height: 10px;
  border-radius: 2px; margin-right: 0.35rem; }
"""


def _esc(s) -> str:
    import html
    return html.escape(str(s))


def _table(headers, rows) -> str:
    h = "".join(f"<th>{_esc(c)}</th>" for c in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row) + "</tr>"
        for row in rows)
    return f"<table><thead><tr>{h}</tr></thead><tbody>{body}</tbody></table>"


def _legend(entries) -> str:
    return "<div class='legend'>" + "".join(
        f"<span><i style='background:var({var})'></i>{_esc(lbl)}</span>"
        for var, lbl in entries) + "</div>"


def _svg_lines(x, series, x_label, w=560, h=240):
    """Line chart: `series` = [(css-var, label, ys)]; 2px lines, >=8px
    markers with native <title> tooltips, end-of-line direct labels."""
    pad_l, pad_r, pad_t, pad_b = 42, 70, 8, 26
    ys_all = [v for _, _, ys in series for v in ys
              if v == v and abs(v) != float("inf")]
    if not ys_all or len(x) < 2:
        return ""
    lo, hi = min(ys_all), max(ys_all)
    if hi == lo:
        hi = lo + (abs(lo) or 1.0)
    span_x = max(x) - min(x) or 1.0
    sx = lambda v: pad_l + (v - min(x)) / span_x * (w - pad_l - pad_r)
    sy = lambda v: pad_t + (hi - v) / (hi - lo) * (h - pad_t - pad_b)
    out = [f"<svg viewBox='0 0 {w} {h}' role='img' "
           f"style='max-width:{w}px'>"]
    for frac in (0.0, 0.5, 1.0):
        gy = pad_t + frac * (h - pad_t - pad_b)
        gv = hi - frac * (hi - lo)
        out.append(f"<line class='grid' x1='{pad_l}' x2='{w - pad_r}' "
                   f"y1='{gy:.1f}' y2='{gy:.1f}'/>")
        out.append(f"<text x='{pad_l - 6}' y='{gy + 4:.1f}' "
                   f"text-anchor='end'>{gv:.3g}</text>")
    finite = lambda v: v == v and abs(v) != float("inf")
    for var, label, ys in series:
        # NaN points (single-class holdout AUC, missing train-side metric)
        # are dropped from the marks, not written as 'nan' coordinates that
        # would make browsers discard the whole polyline
        pairs = [(a, b) for a, b in zip(x, ys) if finite(b)]
        if not pairs:
            continue
        pts = " ".join(f"{sx(a):.1f},{sy(b):.1f}" for a, b in pairs)
        out.append(f"<polyline points='{pts}' fill='none' "
                   f"stroke='var({var})' stroke-width='2'/>")
        for a, b in pairs:
            out.append(
                f"<circle cx='{sx(a):.1f}' cy='{sy(b):.1f}' r='4' "
                f"fill='var({var})' stroke='var(--surface)' "
                f"stroke-width='2'><title>{_esc(label)} @ {a:g}: "
                f"{b:.6g}</title></circle>")
        out.append(f"<text class='lbl' x='{w - pad_r + 8}' "
                   f"y='{sy(pairs[-1][1]) + 4:.1f}'>{_esc(label)}</text>")
    out.append(f"<text x='{(pad_l + w - pad_r) / 2:.0f}' y='{h - 6}' "
               f"text-anchor='middle'>{_esc(x_label)}</text>")
    out.append("</svg>")
    return "".join(out)


def _svg_grouped_bars(groups, series, w=560, h=240):
    """Grouped bars: `groups` = x labels, `series` = [(css-var, label,
    values)]; 2px gap between bars, native <title> tooltips."""
    pad_l, pad_t, pad_b = 42, 8, 26
    vals = [v for _, _, vs in series for v in vs]
    hi = max(vals + [0.0]) or 1.0
    n, k = len(groups), len(series)
    slot = (w - pad_l) / max(n, 1)
    bar_w = max((slot - 8) / max(k, 1) - 2, 2)
    sy = lambda v: pad_t + (hi - v) / hi * (h - pad_t - pad_b)
    out = [f"<svg viewBox='0 0 {w} {h}' role='img' "
           f"style='max-width:{w}px'>"]
    for frac in (0.0, 0.5):
        gy = pad_t + frac * (h - pad_t - pad_b)
        out.append(f"<line class='grid' x1='{pad_l}' x2='{w}' "
                   f"y1='{gy:.1f}' y2='{gy:.1f}'/>")
        out.append(f"<text x='{pad_l - 6}' y='{gy + 4:.1f}' "
                   f"text-anchor='end'>{hi * (1 - frac):.3g}</text>")
    base = sy(0.0)
    out.append(f"<line class='grid' x1='{pad_l}' x2='{w}' y1='{base:.1f}' "
               f"y2='{base:.1f}'/>")
    for g, gname in enumerate(groups):
        x0 = pad_l + g * slot + 4
        for s, (var, label, vs) in enumerate(series):
            v = vs[g]
            top = sy(v)
            out.append(
                f"<rect x='{x0 + s * (bar_w + 2):.1f}' y='{top:.1f}' "
                f"width='{bar_w:.1f}' height='{max(base - top, 0):.1f}' "
                f"rx='2' fill='var({var})'><title>{_esc(label)} "
                f"{_esc(gname)}: {v:.6g}</title></rect>")
        if n <= 12:
            out.append(f"<text x='{x0 + (slot - 8) / 2:.1f}' y='{h - 6}' "
                       f"text-anchor='middle'>{_esc(gname)}</text>")
    out.append("</svg>")
    return "".join(out)


def render_html(report: DiagnosticReport) -> str:
    """One self-contained HTML file: the markdown report's content with
    inline-SVG charts for calibration and learning curves (the reference
    renders these through xchart/batik; same content, zero dependencies)."""
    parts = [f"<!doctype html><html lang='en'><head><meta charset='utf-8'>",
             f"<title>Model diagnostic report ({_esc(report.task_type)})"
             f"</title><style>{_CSS}</style></head><body>",
             f"<h1>Model diagnostic report ({_esc(report.task_type)})</h1>"]

    parts.append("<h2>Metrics</h2>")
    parts.append(_table(["metric", "value"],
                        [(k, f"{v:.6g}") for k, v in
                         sorted(report.metrics.items())]))

    if report.feature_importance is not None:
        fi = report.feature_importance
        parts.append(f"<h2>Feature importance ({_esc(fi.importance_type)})"
                     "</h2>")
        parts.append(_table(
            ["rank", "feature", "importance"],
            [(r, feat, f"{imp:.6g}") for r, (feat, _i, imp)
             in enumerate(fi.top(20), 1)]))

    if report.hosmer_lemeshow is not None:
        hl = report.hosmer_lemeshow
        parts.append("<h2>Hosmer-Lemeshow calibration</h2>")
        parts.append(
            f"<p>chi-squared {hl.chi_squared:.4f} "
            f"({hl.degrees_of_freedom} dof), "
            f"P(chi2 &le; observed) {hl.prob_at_chi_square:.4f}, "
            f"p-value {hl.p_value:.4f}</p>")
        groups = [f"[{b.lower:.2f},{b.upper:.2f})" for b in hl.bins]
        series = [("--s1", "expected +", [b.expected_pos for b in hl.bins]),
                  ("--s2", "observed +", [b.observed_pos for b in hl.bins])]
        parts.append(_legend([("--s1", "expected positives"),
                              ("--s2", "observed positives")]))
        parts.append(_svg_grouped_bars(groups, series))
        parts.append(_table(
            ["bin", "expected +", "observed +", "expected -", "observed -"],
            [(f"[{b.lower:.2f}, {b.upper:.2f})", f"{b.expected_pos:.1f}",
              f"{b.observed_pos:.0f}", f"{b.expected_neg:.1f}",
              f"{b.observed_neg:.0f}") for b in hl.bins]))
        if hl.warnings:
            parts.append(f"<p class='note'>warnings: {len(hl.warnings)} "
                         "sparse bins</p>")

    if report.independence is not None:
        kt = report.independence
        parts.append("<h2>Prediction-error independence (Kendall tau)</h2>")
        parts.append(f"<p>tau-alpha {kt.tau_alpha:.4f}, "
                     f"tau-beta {kt.tau_beta:.4f}, z {kt.z_alpha:.3f}, "
                     f"two-sided probability {kt.p_value:.4f}</p>")
        if kt.message:
            parts.append(f"<p class='note'>{_esc(kt.message)}</p>")

    if report.bootstrap is not None:
        bs = report.bootstrap
        parts.append("<h2>Bootstrap confidence intervals</h2>")
        parts.append(
            f"<p>{bs.num_samples} replicas; coefficients with IQR "
            f"excluding zero: {int(bs.significant_mask.sum())} / "
            f"{len(bs.coefficient_summaries)}</p>")
        parts.append(_table(
            ["metric", "q1", "median", "q3"],
            [(k, f"{s.q1:.6g}", f"{s.median:.6g}", f"{s.q3:.6g}")
             for k, s in sorted(bs.metric_summaries.items())]))

    if report.fitting is not None and report.fitting.metrics:
        parts.append("<h2>Learning curves</h2>")
        parts.append(_legend([("--s1", "train"), ("--s2", "holdout")]))
        for metric, curve in sorted(report.fitting.metrics.items()):
            parts.append(f"<h3>{_esc(metric)}</h3>")
            parts.append(_svg_lines(
                list(curve["portions"]),
                [("--s1", "train", list(curve["train"])),
                 ("--s2", "holdout", list(curve["test"]))],
                "training portion"))
    elif report.fitting is not None:
        parts.append("<h2>Learning curves</h2>")
        parts.append(f"<p class='note'>{_esc(report.fitting.message)}</p>")

    parts.append("</body></html>")
    return "".join(parts)
