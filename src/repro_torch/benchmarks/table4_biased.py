"""Table 4: four biased workloads (half the jobs pinned to one class).
Paper: Venn 1.94-2.27x, consistently above SRSF/FIFO."""
from .common import cli, emit, speedup_table
from ..sim.traces import BIASED


def main(device=None):
    results = {}
    for bias in BIASED:
        results[bias] = speedup_table({"bias": bias},
                                      label=f"table4_{bias}_", device=device)
    print("\n# Table 4 summary (speedup vs random, biased workloads)")
    print(f"{'bias':16s} {'FIFO':>6s} {'SRSF':>6s} {'Venn':>6s}")
    ok = True
    for b, r in results.items():
        print(f"{b:16s} {r['fifo']:6.2f} {r['srsf']:6.2f} {r['venn']:6.2f}")
        ok &= r["venn"] >= 1.3
    emit("table4_validates", 0, f"venn_above_1.3_all={ok}")
    return results


if __name__ == "__main__":
    cli(main)
