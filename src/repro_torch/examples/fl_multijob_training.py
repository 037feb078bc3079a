"""End-to-end driver: REAL multi-job collaborative training under Venn.

Three FL jobs (reduced LM architectures from the zoo) train concurrently on
a shared simulated device population.  Venn decides which job every checked-
in device serves; selected devices run REAL local-SGD steps on their
non-IID (Dirichlet) data shards; servers aggregate with the FedAvg kernel
(``fedavg_reduce``) and int8-compressed uplinks (``quantize`` /
``dequantize``).  Eval losses drop for all jobs — the scheduler affects
WHEN work happens, never the math (paper Fig. 9).  On the card the local
updates' attention runs in the tensor-core flash kernel and VENN's resorts
in ``segmented_order``.

    PYTHONPATH=src python -m repro_torch.examples.fl_multijob_training

(``--rounds 6``, ``--clients-per-round 4``; ``--device cpu`` for the host
path.)
"""
import argparse

import numpy as np
import torch

from ..configs import get_config
from ..core import VennScheduler
from ..core.types import Job, JobRequest
from ..data.synthetic import SyntheticLM, dirichlet_client_mixes
from ..device import resolve_device
from ..fed.aggregation import FedAvg, aggregate_deltas
from ..fed.client import make_local_update
from ..fed.compression import QuantizeConfig, compress, decompress
from ..models.model import build_model
from ..sim.devices import REQUIREMENT_CLASSES, DeviceGenerator, PopulationConfig

ARCHS = ("llama3.2-1b", "stablelm-1.6b", "qwen3-32b")


def seeded_params(i, arch, model, device):
    return model.init_params(torch.Generator(device=device).manual_seed(i),
                             device)


def _loss(model, params, batch) -> float:
    with torch.no_grad():
        return float(model.loss_fn(params, batch))


def main(argv=None, init_params=seeded_params):
    """``init_params(i, arch, model, device)`` makes job ``i``'s parameters
    (seeded ``i`` by default)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    T, B = 16, 4
    jobs, models, params, updaters, evals, datas = [], [], [], [], [], []
    for i, an in enumerate(ARCHS):
        cfg = get_config(an).reduced().with_(n_layers=2, vocab=128)
        model = build_model(cfg)
        p = init_params(i, an, model, dev)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=T, seed=i)
        jobs.append(Job(job_id=i, requirement=REQUIREMENT_CLASSES[i % 3],
                        demand_per_round=args.clients_per_round,
                        total_rounds=args.rounds, arrival_time=0.0))
        models.append(model)
        params.append(p)
        updaters.append(make_local_update(model, lr=0.15, local_steps=2))
        evals.append({k: torch.from_numpy(v).to(dev)
                      for k, v in data.batch(8, seed=999).items()})
        datas.append(data)

    mixes = dirichlet_client_mixes(256, 8, alpha=0.3, seed=0)
    venn = VennScheduler(seed=0, device=dev)
    servers = [FedAvg(server_lr=1.0) for _ in jobs]
    states = [s.init(p) for s, p in zip(servers, params)]
    devgen = DeviceGenerator(PopulationConfig(seed=3, base_rate=5.0))

    loss0 = [_loss(m, p, e) for m, p, e in zip(models, params, evals)]
    print("initial eval losses:", [f"{l:.3f}" for l in loss0])

    now = 0.0
    for rnd in range(args.rounds):
        # each job submits its round request to Venn
        reqs = []
        for j in jobs:
            req = JobRequest(job=j, round_index=rnd, demand=j.demand_per_round,
                             submit_time=now)
            j.current = req
            venn.on_request(req, now)
            reqs.append(req)
        # devices check in until all demands met; Venn assigns each
        assigned = {j.job_id: [] for j in jobs}
        times = devgen.checkin_times(now, now + 600.0)
        for i, dev_ in enumerate(devgen.sample_devices(times)):
            req = venn.assign(dev_, float(dev_.checkin_time))
            if req is not None and req.remaining > 0:
                req.granted += 1
                assigned[req.job.job_id].append(dev_)
            if all(r.remaining == 0 for r in reqs):
                break
        now += 600.0
        # selected devices run REAL local updates; servers aggregate
        for ji, job in enumerate(jobs):
            devs = assigned[job.job_id][: job.demand_per_round]
            deltas, weights = [], []
            for ci, dev_ in enumerate(devs):
                mix = mixes[(hash(dev_.dev_id) % len(mixes))]
                bs = [datas[ji].batch(B, topic_mix=mix, seed=1000 * rnd + ci + s)
                      for s in range(2)]
                batches = {k: torch.from_numpy(np.stack([b[k] for b in bs]))
                           .to(dev) for k in bs[0]}
                delta, _ = updaters[ji](params[ji], batches)
                # int8-compressed uplink (client -> server)
                delta = decompress(compress(delta, QuantizeConfig()),
                                   QuantizeConfig())
                deltas.append(delta)
                weights.append(1.0)
            if not deltas:
                continue
            agg = aggregate_deltas(deltas, weights)       # fedavg_reduce
            params[ji], states[ji] = servers[ji].apply(params[ji], agg,
                                                       states[ji])
            venn.on_complete(job.current, now)
            job.current = None
            job.rounds_done += 1
        losses = [_loss(m, p, e) for m, p, e in zip(models, params, evals)]
        print(f"round {rnd}: eval losses " + " ".join(f"{l:.3f}" for l in losses)
              + f"  (devices assigned: "
              + ",".join(str(len(assigned[j.job_id])) for j in jobs) + ")")

    loss1 = [_loss(m, p, e) for m, p, e in zip(models, params, evals)]
    improved = sum(b < a for a, b in zip(loss0, loss1))
    print(f"\n{improved}/{len(jobs)} jobs improved eval loss "
          f"({[f'{a:.3f}->{b:.3f}' for a, b in zip(loss0, loss1)]})")
    assert improved >= 2, "most jobs should improve"
    print("OK — multi-job collaborative training under Venn scheduling works.")


if __name__ == "__main__":
    main()
