"""Fault-tolerance example: checkpoint -> simulated failure -> elastic
restore on a different mesh, then continue training.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart

(``--device cpu`` for the host path.)
"""
import argparse

from ..launch.elastic import main as elastic_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    args = ap.parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    return elastic_main(["--arch", "llama3.2-1b-smoke", "--steps", "8"]
                        + extra)


if __name__ == "__main__":
    raise SystemExit(main())
