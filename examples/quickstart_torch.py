"""Quickstart on the PyTorch/CUDA port: 3 organizations collaborate via
UnifyFL — the torch twin of examples/quickstart.py.

Builds three FL silos (2 clients each) over a Dirichlet-NIID image task,
runs Sync UnifyFL with accuracy scoring and the top-k aggregation policy,
and prints per-silo local vs global accuracy. Runs on the GPU by default;
pass ``--device cpu`` to run the kernels' plain versions on the CPU.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.config import FedConfig
from repro_torch.configs import get_config
from repro_torch.core.builder import build_image_experiment, global_eval


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "int8-delta", "topk-delta"])
    args = ap.parse_args()
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=4, local_epochs=1,
                    mode="sync", scorer="accuracy", agg_policy="top_k",
                    policy_k=2, score_policy="median",
                    compression=args.compression)
    orch = build_image_experiment(get_config("paper-cnn"), fed,
                                  partition="niid", alpha=0.2,
                                  n_train=1500, n_test=450, seed=0,
                                  device=args.device)
    dev = orch.silos[0].cluster.device
    print(f"running 4 Sync UnifyFL rounds on {dev} "
          "(3 silos x 2 clients, NIID alpha=0.2)...")
    orch.run(fed.rounds)

    print(f"\nledger: {orch.ledger.height} blocks, "
          f"verified={orch.ledger.verify()}")
    print(f"simulated time: {orch.env.now:.1f}s")
    for silo in orch.silos:
        local = silo.cluster.evaluate()
        print(f"  {silo.silo_id}: local test acc={local['accuracy']:.3f} "
              f"(scores submitted for {len(silo.metrics)} rounds)")
    ge = global_eval(orch)
    print("global test accuracy per silo model:",
          {k: round(v["accuracy"], 3) for k, v in ge.items()})


if __name__ == "__main__":
    main()
