"""End-to-end example on the PyTorch/CUDA port: federated LM pretraining
across 3 silos with UnifyFL — the torch twin of
examples/train_lm_federated.py, with its settings.

Each silo's clients train a decoder LM (a reduced same-family config of
ARCH, qwen3-1.7b by default) on the silo's own Markov-dialect token stream,
the LM analogue of cross-silo NIID. Async mode, top-k policy, loss-based
scoring. Runs on the GPU by default; pass ``--device cpu`` to run the
kernels' plain versions on the CPU.

  PYTHONPATH=src python examples/train_lm_federated_torch.py [ARCH] \\
      [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.config import FedConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.builder import build_lm_experiment


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="qwen3-1.7b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()
    fed = FedConfig(n_silos=3, clients_per_silo=2, rounds=5, local_epochs=1,
                    mode="async", scorer="loss", agg_policy="top_k",
                    policy_k=2)
    cfg = get_smoke_config(args.arch)
    orch = build_lm_experiment(cfg, fed, seq_len=64, batch_size=8,
                               steps_per_epoch=6, lr=0.2, stream_len=30_000,
                               device=args.device)
    print(f"arch={cfg.arch_id} (reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size}) on {orch.silos[0].cluster.device} — "
          "async UnifyFL, 3 dialect silos")
    pre = {s.silo_id: s.cluster.evaluate()["loss"] for s in orch.silos}
    orch.run(fed.rounds)
    post = {s.silo_id: s.cluster.evaluate()["loss"] for s in orch.silos}
    print(f"\nledger verified={orch.ledger.verify()}  "
          f"simulated_time={orch.env.now:.1f}s")
    for sid in pre:
        print(f"  {sid}: eval loss {pre[sid]:.3f} -> {post[sid]:.3f} "
              f"(ppl {np.exp(pre[sid]):.1f} -> {np.exp(post[sid]):.1f})")
    if not all(post[s] < pre[s] for s in pre):
        raise SystemExit("training failed to reduce loss")
    print("OK: every silo's loss improved under federated training")


if __name__ == "__main__":
    main()
