"""End-to-end UnifyFL training from the command line (twin of
``repro.launch.train``, with its flags plus ``--device``, default
``cuda``: it raises without a card and never falls back to the CPU).

Two workloads:
  - image: the paper's CIFAR-like workload (CNN, Dirichlet-NIID silos)
  - lm:    federated LM pretraining over per-silo Markov dialects, for any
           configuration via --arch (the smoke preset trains a small
           same-family config; the full preset is the published config)

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --workload image \\
      --mode sync --rounds 10 --silos 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --workload lm \\
      --arch qwen3-1.7b --preset smoke --rounds 5 --mode async \\
      --policy top_k --device cpu

``--preset full`` draws its streams at the model's own vocabulary, as the
reference does: ``make_lm_dataset`` builds dense vocab x vocab float64
matrices, 184.7 GB each at qwen3-1.7b's 151,936, so a full-width run that
fits on one host draws at a smaller data vocabulary (``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.config import FedConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.builder import (build_image_experiment,
                                      build_lm_experiment, global_eval)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", choices=["image", "lm"], default="image")
    p.add_argument("--arch", default="paper-cnn")
    p.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    p.add_argument("--mode", choices=["sync", "async"], default="sync")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--silos", type=int, default=3)
    p.add_argument("--clients", type=int, default=2)
    p.add_argument("--local-epochs", type=int, default=1)
    p.add_argument("--policy", default="all")
    p.add_argument("--score-policy", default="median")
    p.add_argument("--scorer", default="accuracy")
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--partition", choices=["iid", "niid"], default="niid")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--compression",
                   choices=["none", "int8", "int8-delta", "topk-delta"],
                   default="none")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without one)")
    args = p.parse_args(argv)

    fed = FedConfig(n_silos=args.silos, clients_per_silo=args.clients,
                    rounds=args.rounds, local_epochs=args.local_epochs,
                    mode=args.mode, scorer=args.scorer,
                    agg_policy=args.policy, score_policy=args.score_policy,
                    policy_k=args.k, compression=args.compression)
    t0 = time.time()
    if args.workload == "image":
        cfg = get_config("paper-cnn")
        orch = build_image_experiment(cfg, fed, partition=args.partition,
                                      alpha=args.alpha, seed=args.seed,
                                      device=args.device)
    else:
        cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
               else get_config(args.arch))
        orch = build_lm_experiment(cfg, fed, seed=args.seed,
                                   device=args.device)
    print(f"workload={args.workload} arch={cfg.arch_id} mode={fed.mode} "
          f"silos={fed.n_silos}x{fed.clients_per_silo} rounds={fed.rounds} "
          f"policy={fed.agg_policy}/{fed.score_policy} device={args.device}")
    orch.run(args.rounds)
    ge = global_eval(orch)
    wall = time.time() - t0
    print(f"\nfinished in {wall:.1f}s wall / {orch.env.now:.1f}s simulated")
    print(f"ledger: {orch.ledger.height} blocks, "
          f"{orch.ledger.stats['txs']} txs, verify={orch.ledger.verify()}")
    for sid, m in ge.items():
        print(f"  {sid}: global acc={m['accuracy']:.4f} loss={m['loss']:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"global_eval": ge, "summary": orch.summary(),
                       "sim_time": orch.env.now, "wall": wall}, f, indent=1,
                      default=str)
    return ge


if __name__ == "__main__":
    main()
