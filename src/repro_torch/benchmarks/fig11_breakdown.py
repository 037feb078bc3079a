"""Fig. 11: component breakdown — Venn w/o matching, w/o scheduling, full,
on even (contended) and low-contention workloads.  Paper: matching helps
mainly at low contention; scheduling dominates under contention."""
from .common import cli, emit, speedup_table


def main(device=None):
    out = {}
    # contended regime
    for label, kw in [("even", {}),
                      ("lowcontend", {})]:
        pop = {"base_rate": 2.0} if label == "even" else {"base_rate": 8.0}
        r_full = speedup_table(kw, scheds=("venn",), pop_kw=pop,
                               label=f"fig11_{label}_full_",
                               device=device)["venn"]
        r_nomatch = speedup_table(kw, scheds=("venn",), pop_kw=pop,
                                  label=f"fig11_{label}_nomatch_",
                                  venn_kw={"enable_matching": False},
                                  device=device)["venn"]
        r_nosched = speedup_table(kw, scheds=("venn",), pop_kw=pop,
                                  label=f"fig11_{label}_nosched_",
                                  venn_kw={"enable_irs": False},
                                  device=device)["venn"]
        out[label] = (r_full, r_nomatch, r_nosched)
    print("\n# Fig 11 summary (speedup vs random)")
    print(f"{'regime':12s} {'full':>6s} {'w/o match':>10s} {'w/o sched':>10s}")
    for l, (f, nm, ns) in out.items():
        print(f"{l:12s} {f:6.2f} {nm:10.2f} {ns:10.2f}")
    # scheduling component should carry the win under contention
    ok = out["even"][0] >= out["even"][2] * 0.95
    emit("fig11_validates", 0, f"scheduling_dominates_contended={ok}")
    return out


if __name__ == "__main__":
    cli(main)
