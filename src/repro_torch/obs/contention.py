"""ASCII renderers over scheduler audit streams (``--audit-out`` JSONL).

Three views of the flight-recorder data (:mod:`repro_torch.obs.audit`):

* :func:`contention_graph` — the IRS intersection structure of one replan:
  group supply/queued-demand table, per-atom pressure table, and the
  job-group × atom bipartite incidence matrix (owner vs. fallback edges).
* :func:`pressure_timelines` — per-atom queued-demand/supply-rate pressure
  over replans, as log-scaled sparklines (the Fig. 12-style contention
  trajectory).
* :func:`explain_job` — everything the recorder knows about one job: its
  queue-position history with the specific contending jobs ahead, and its
  sampled grant rows (atoms, slots, tier bands, skip counters).

All functions take the decoded record list (``audit.read_audit``); rendering
never touches the recorder, so it works on files from any run.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

__all__ = ["audit_summary_table", "contention_graph", "explain_job",
           "pressure_timelines"]

_SPARK = " .:-=+*#%@"


def _fmt(x: Optional[float], width: int = 9) -> str:
    if x is None:
        return f"{'inf':>{width}}"
    if x == 0:
        return f"{'0':>{width}}"
    if 0.001 <= abs(x) < 100000:
        return f"{x:>{width}.3f}" if abs(x) < 100 else f"{x:>{width}.0f}"
    return f"{x:>{width}.2e}"


def _replans(records: List[dict]) -> List[dict]:
    return [r for r in records if r.get("kind") == "replan"]


def _pick_replan(records: List[dict], seq: Optional[int]) -> Optional[dict]:
    reps = _replans(records)
    if not reps:
        return None
    if seq is None:
        return reps[-1]
    for r in reps:
        if r["seq"] == seq:
            return r
    return None


# --------------------------------------------------------------------------- #
# contention graph
# --------------------------------------------------------------------------- #

def contention_graph(records: List[dict], replan: Optional[int] = None) -> str:
    """Render one replan snapshot's IRS intersection structure."""
    rep = _pick_replan(records, replan)
    if rep is None:
        return ("(no replan snapshots — was the run made with --audit-out "
                "and the venn scheduler?)")
    lines = [f"IRS contention graph — replan #{rep['seq']} @ "
             f"t={rep['t']:.0f}s  ({rep['jobs']} jobs, "
             f"{len(rep['groups'])} groups, {len(rep['atoms'])} atoms, "
             f"{rep['slots']} dispatch slots, "
             f"{len(rep['dead_atoms'])} dead / "
             f"{rep['uncovered_atoms']} uncovered atoms)", ""]

    lines.append(f"{'group':<16} {'supply/s':>10} {'queued':>7} "
                 f"{'atoms':>5}  jobs (head first, key=fairness demand)")
    lines.append("-" * 78)
    for g in rep["groups"]:
        jobs = " ".join(
            f"j{j}({_fmt(k, 1).strip()})" if k is not None else f"j{j}"
            for j, k in zip(g["jobs"],
                            list(g["keys"]) + [None] * len(g["jobs"])))
        lines.append(f"{g['group']:<16} {_fmt(g['supply'], 10)} "
                     f"{g['queued_demand']:>7} {len(g['atoms']):>5}  "
                     f"{jobs[:120]}")

    lines.append("")
    lines.append(f"{'atom':>5} {'rate/s':>10} {'demand':>7} "
                 f"{'pressure_s':>11}  priority order (owner first)")
    lines.append("-" * 78)
    for a in rep["atoms"]:
        order = " > ".join(a["order"]) if a["order"] else "(idle)"
        lines.append(f"a{a['id']:>4} {_fmt(a['rate'], 10)} "
                     f"{a['demand']:>7} {_fmt(a['pressure'], 11)}  {order}")

    # bipartite incidence: group rows x atom columns
    atom_ids = [a["id"] for a in rep["atoms"]]
    owners = {a["id"]: (a["order"][0] if a["order"] else None)
              for a in rep["atoms"]}
    if atom_ids and rep["groups"]:
        lines.append("")
        lines.append("group x atom incidence  (O = owner, x = fallback "
                     "eligibility, . = not eligible):")
        name_w = max(17, max(len(g["group"]) for g in rep["groups"]) + 1)
        hdr = " " * name_w + " ".join(f"a{i:<3}" for i in atom_ids)
        lines.append(hdr[:110])
        for g in rep["groups"]:
            elig = set(g["atoms"])
            cells = []
            for aid in atom_ids:
                if aid not in elig:
                    cells.append(".   ")
                elif owners.get(aid) == g["group"]:
                    cells.append("O   ")
                else:
                    cells.append("x   ")
            lines.append((f"{g['group']:<{name_w}}" + " ".join(
                c[:4] for c in cells))[:110])
        shared = [a for a in rep["atoms"] if len(a["order"]) > 1]
        if shared:
            lines.append("")
            lines.append("contended atoms (eligible to >1 group):")
            for a in shared:
                lines.append(f"  a{a['id']}: " + " > ".join(a["order"]))
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# pressure timelines
# --------------------------------------------------------------------------- #

def pressure_timelines(records: List[dict], atoms: Optional[List[int]] = None,
                       top: int = 12, width: int = 64) -> str:
    """Per-atom pressure sparklines over replans.

    ``atoms`` selects atom ids explicitly; otherwise the ``top`` atoms by
    peak pressure are shown.  ``!`` marks infinite pressure (queued demand
    against zero observed supply); the scale is logarithmic between the
    smallest and largest finite positive pressure seen."""
    reps = _replans(records)
    if not reps:
        return "(no replan snapshots in this audit stream)"
    series: Dict[int, List[Optional[float]]] = {}
    for ri, rep in enumerate(reps):
        for a in rep["atoms"]:
            series.setdefault(a["id"], [0.0] * len(reps))[ri] = a["pressure"]
    if atoms:
        chosen = [a for a in atoms if a in series]
    else:
        def peak(vals):
            finite = [v for v in vals if v is not None]
            infs = sum(1 for v in vals if v is None)
            return (infs, max(finite) if finite else 0.0)
        chosen = sorted(series, key=lambda a: peak(series[a]),
                        reverse=True)[:top]
    finite_vals = [v for a in chosen for v in series[a]
                   if v is not None and v > 0]
    lo = min(finite_vals) if finite_vals else 1.0
    hi = max(finite_vals) if finite_vals else 1.0
    span = math.log10(hi / lo) if hi > lo else 1.0
    # subsample replans onto the sparkline width
    n = len(reps)
    cols = min(width, n)
    idxs = [int(i * n / cols) for i in range(cols)]

    def cell(v: Optional[float]) -> str:
        if v is None:
            return "!"
        if v <= 0:
            return _SPARK[0]
        f = (math.log10(v / lo)) / span if span else 1.0
        return _SPARK[max(0, min(len(_SPARK) - 1,
                                 int(f * (len(_SPARK) - 1))))]

    lines = [f"per-atom pressure over {n} replans "
             f"(t={reps[0]['t']:.0f}s..{reps[-1]['t']:.0f}s; scale "
             f"log [{lo:.3g}, {hi:.3g}] s, '!' = infinite)", ""]
    for aid in chosen:
        vals = series[aid]
        spark = "".join(cell(vals[i]) for i in idxs)
        finite = [v for v in vals if v is not None]
        peak_s = "inf" if any(v is None for v in vals) else \
            f"{max(finite):.3g}" if finite else "0"
        lines.append(f"a{aid:>4} |{spark}| peak={peak_s}")
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# audit summary + explain
# --------------------------------------------------------------------------- #

def audit_summary_table(records: List[dict]) -> str:
    """Stream-level statistics: record counts, grant skip totals, per-job
    grant counts."""
    by_kind: Dict[str, int] = {}
    for r in records:
        by_kind[r.get("kind", "?")] = by_kind.get(r.get("kind", "?"), 0) + 1
    lines = ["audit stream: " + ", ".join(
        f"{k}={v}" for k, v in sorted(by_kind.items()))]
    summ = next((r for r in records if r.get("kind") == "audit_summary"),
                None)
    if summ:
        lines.append(f"rounds_seen={summ['rounds_seen']} "
                     f"(1/{summ['grant_sample']} round-opening grants "
                     f"sampled), dropped={summ['dropped']}")
    grants = [r for r in records if r.get("kind") == "grant"]
    if grants:
        filled = sum(r.get("skipped_filled", 0) for r in grants)
        band = sum(r.get("skipped_band", 0) for r in grants)
        mismatch = sum(1 for r in grants if r.get("mismatch"))
        stale = sum(1 for r in grants if r.get("stale"))
        head = sum(1 for r in grants if r.get("slot") == 0)
        lines.append(f"sampled grants: {len(grants)}  head-slot wins: {head} "
                     f"({100.0 * head / len(grants):.0f}%)  skipped slots: "
                     f"filled={filled} tier-band={band}  "
                     f"mismatch={mismatch} stale={stale}")
        per_job: Dict[int, int] = {}
        for r in grants:
            per_job[r["job"]] = per_job.get(r["job"], 0) + 1
        lines.append("")
        lines.append(f"{'job':>6} {'grants':>7} {'atoms':>6} "
                     f"{'p_head':>6}  (sampled)")
        lines.append("-" * 40)
        for jid in sorted(per_job, key=per_job.get, reverse=True)[:20]:
            rows = [r for r in grants if r["job"] == jid]
            atoms = {r["atom"] for r in rows}
            heads = sum(1 for r in rows if r.get("slot") == 0)
            lines.append(f"j{jid:>5} {len(rows):>7} {len(atoms):>6} "
                         f"{heads / len(rows):>6.2f}")
    return "\n".join(lines)


def explain_job(records: List[dict], job_id: int) -> str:
    """Everything the flight recorder knows about one job's scheduling."""
    qpos = [r for r in records
            if r.get("kind") == "queue_pos" and r["job"] == job_id]
    grants = [r for r in records
              if r.get("kind") == "grant" and r["job"] == job_id]
    if not qpos and not grants:
        return (f"(job {job_id} never appears in this audit stream — "
                f"wrong id, or a non-venn scheduler?)")
    group = qpos[0]["group"] if qpos else "?"
    lines = [f"explain job {job_id} (group {group}):", ""]
    if qpos:
        lines.append("queue-position history (one row per change):")
        lines.append(f"  {'t_s':>10} {'replan':>6} {'pos':>4} "
                     f"{'key':>10}  ahead (contending jobs)")
        for r in qpos:
            ahead = " ".join(f"j{j}" for j in r["ahead"]) or "(head)"
            lines.append(f"  {r['t']:>10.0f} #{r['replan']:>5} "
                         f"{r['pos']:>4} {_fmt(r['key'], 10)}  {ahead[:70]}")
        blockers: Dict[int, int] = {}
        for r in qpos:
            for j in r["ahead"]:
                blockers[j] = blockers.get(j, 0) + 1
        if blockers:
            lines.append("")
            top = sorted(blockers.items(), key=lambda kv: -kv[1])[:10]
            lines.append("scheduling delay attributable to (times seen "
                         "ahead): " + " ".join(f"j{j}x{c}" for j, c in top))
        waits = sum(1 for r in qpos if r["pos"] > 0)
        lines.append(f"position changes: {len(qpos)} "
                     f"({waits} queued behind another job, "
                     f"{len(qpos) - waits} at head)")
    if grants:
        lines.append("")
        atoms: Dict[int, int] = {}
        for r in grants:
            atoms[r["atom"]] = atoms.get(r["atom"], 0) + 1
        rounds = sorted({r["round"] for r in grants})
        slot0 = sum(1 for r in grants if r.get("slot") == 0)
        banded = sum(1 for r in grants
                     if "band_lo" in r or "band_hi" in r)
        lines.append(f"sampled grants: {len(grants)} over rounds "
                     f"{rounds[0]}..{rounds[-1]}, t={grants[0]['t']:.0f}s.."
                     f"{grants[-1]['t']:.0f}s")
        lines.append("  by atom: " + " ".join(
            f"a{a}x{c}" for a, c in sorted(atoms.items())))
        lines.append(f"  head-slot wins: {slot0}/{len(grants)}  "
                     f"tier-banded: {banded}")
        skipped = sum(r.get("skipped_filled", 0) + r.get("skipped_band", 0)
                      for r in grants)
        if skipped:
            lines.append(f"  slots skipped ahead of this job's wins: "
                         f"{skipped} (filled="
                         f"{sum(r.get('skipped_filled', 0) for r in grants)}"
                         f", tier-band="
                         f"{sum(r.get('skipped_band', 0) for r in grants)})")
    else:
        lines.append("")
        lines.append("no sampled grants (job may still have been served — "
                     "round-opening grants can stride past it when "
                     "grant_sample > 1)")
    return "\n".join(lines)
