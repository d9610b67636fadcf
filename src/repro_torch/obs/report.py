"""Run reporter: telemetry bundle -> markdown (or JSON) summary.

Usage::

    python -m repro_torch.obs.report run_telemetry.json      # md to stdout
    python -m repro_torch.obs.report run_telemetry.json -o run.md
    python -m repro_torch.obs.report run_telemetry.json --format json \
        -o run.json

Input is the bundle written by
:meth:`repro_torch.obs.telemetry.Telemetry.save` (or by the reference
package's, whose bundle format ``repro.obs/1`` it shares).  The report has five
sections: run summary, metric series (last/mean/min/max per labeled
series), cycle-phase wall-time breakdown, the top-N jobs by queue wait,
and the failure/interrupt/reshape timeline, plus the decision-audit
summary when the audit pillar was on.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional

__all__ = ["build_report", "render_markdown", "main"]

TOP_JOBS = 10


def _series_stats(samples: List[List[float]]) -> Dict[str, float]:
    values = [v for _, v in samples]
    if not values:
        return {"last": math.nan, "mean": math.nan, "min": math.nan,
                "max": math.nan, "n": 0}
    return {"last": values[-1], "mean": sum(values) / len(values),
            "min": min(values), "max": max(values), "n": len(values)}


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"'
                          for k, v in sorted(labels.items())) + "}"


def _num(x: float) -> str:
    if x != x:                     # NaN
        return "-"
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.4g}"


def build_report(bundle: Dict) -> Dict[str, object]:
    """Structured report (the ``--format json`` output)."""
    meta = bundle.get("meta", {})
    jobs = bundle.get("jobs", [])
    phase_totals = bundle.get("phase_totals", {})

    metrics = []
    for name, fam in sorted(bundle.get("metrics", {}).items()):
        for s in fam.get("series", []):
            metrics.append({
                "metric": name,
                "type": fam.get("type", ""),
                "labels": s.get("labels", {}),
                **_series_stats(s.get("samples", [])),
            })

    waited = [j for j in jobs if j.get("wait_s") is not None]
    waited.sort(key=lambda j: (-j["wait_s"], j["uid"]))

    timeline = []
    trace = bundle.get("trace", {})
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "i":
            timeline.append({"t_s": ev["ts"] / 1e6, "event": ev["name"],
                             "args": ev.get("args", {})})
    timeline.sort(key=lambda e: e["t_s"])

    completed = [j for j in jobs if j.get("end_t") is not None]
    report: Dict[str, object] = {
        "meta": meta,
        "summary": {
            "sim_end_t": meta.get("sim_end_t"),
            "jobs_seen": len(jobs),
            "jobs_completed": len(completed),
            "interrupts": sum(j.get("interrupts", 0) for j in jobs),
            "reshapes": sum(j.get("reshapes", 0) for j in jobs),
            "preemptions": sum(j.get("preemptions", 0) for j in jobs),
            "events": bundle.get("events", {}),
        },
        "metrics": metrics,
        "phases": dict(sorted(phase_totals.items(),
                              key=lambda kv: -kv[1])),
        "top_wait_jobs": waited[:TOP_JOBS],
        "timeline": timeline,
    }
    if "audit" in bundle:
        report["audit"] = bundle["audit"].get("summary", {})
    return report


def render_markdown(report: Dict) -> str:
    out: List[str] = ["# Run telemetry report", ""]
    s = report["summary"]
    out += ["## Summary", ""]
    out += [f"- simulated end time: **{_num(float(s['sim_end_t'] or 0))} s**",
            f"- jobs seen: **{s['jobs_seen']}** "
            f"(completed: {s['jobs_completed']})",
            f"- interrupts: {s['interrupts']}  ·  reshapes: "
            f"{s['reshapes']}  ·  preemptions: {s['preemptions']}"]
    if s.get("events"):
        ev = ", ".join(f"{k}={v}" for k, v in sorted(s["events"].items()))
        out.append(f"- bus events: {ev}")
    out.append("")

    if report.get("metrics"):
        out += ["## Metrics", "",
                "| metric | labels | last | mean | min | max | n |",
                "|---|---|---:|---:|---:|---:|---:|"]
        for m in report["metrics"]:
            out.append(
                f"| `{m['metric']}` | `{_fmt_labels(m['labels'])}` "
                f"| {_num(m['last'])} | {_num(m['mean'])} "
                f"| {_num(m['min'])} | {_num(m['max'])} | {m['n']} |")
        out.append("")

    if report.get("phases"):
        total = sum(report["phases"].values()) or 1.0
        out += ["## Cycle-phase wall time", "",
                "| phase | total s | share |", "|---|---:|---:|"]
        for name, sec in report["phases"].items():
            out.append(f"| {name} | {sec:.6f} | {100 * sec / total:.1f}% |")
        out.append("")

    if report.get("top_wait_jobs"):
        out += [f"## Top {TOP_JOBS} jobs by queue wait", "",
                "| uid | tenant | kind | gpus | wait s | binds "
                "| interrupts |", "|---:|---|---|---:|---:|---:|---:|"]
        for j in report["top_wait_jobs"]:
            out.append(
                f"| {j['uid']} | {j['tenant']} | {j['kind']} "
                f"| {j['n_gpus']} | {_num(j['wait_s'])} | {j['binds']} "
                f"| {j['interrupts']} |")
        out.append("")

    if report.get("timeline"):
        out += ["## Failure / preemption / reshape timeline", "",
                "| t (s) | event | details |", "|---:|---|---|"]
        for e in report["timeline"][:200]:
            args = ", ".join(f"{k}={v}" for k, v in e["args"].items())
            out.append(f"| {_num(e['t_s'])} | {e['event']} | {args} |")
        if len(report["timeline"]) > 200:
            out.append(f"| … | {len(report['timeline']) - 200} more | |")
        out.append("")

    if report.get("audit"):
        a = report["audit"]
        out += ["## Decision audit", "",
                f"- decisions: {a.get('decisions', 0)} "
                f"(bound {a.get('bound', 0)}, "
                f"rejected {a.get('rejected', 0)})",
                f"- preemptions: {a.get('preemptions', 0)}"]
        reasons = a.get("rejections_by_reason") or {}
        if reasons:
            body = ", ".join(f"{k}: {v}"
                             for k, v in sorted(reasons.items()))
            out.append(f"- rejections by reason: {body}")
        out.append("")

    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a telemetry bundle as markdown or JSON.")
    ap.add_argument("bundle", help="bundle written by Telemetry.save()")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (default: stdout)")
    args = ap.parse_args(argv)

    with open(args.bundle) as f:
        bundle = json.load(f)
    report = build_report(bundle)
    text = (json.dumps(report, indent=2, default=float)
            if args.format == "json" else render_markdown(report))
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text + ("\n" if not text.endswith("\n") else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
