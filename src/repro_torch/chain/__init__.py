"""repro_torch.chain — replicated Clique-PoA consensus over the WAN fabric.

The paper's decentralized orchestration runs on a private Ethereum/Clique
chain. This package makes that real instead of simulated-away: every silo
holds a ``ChainReplica`` (block tree + mempool), seals per the Clique
in-turn/out-of-turn schedule, gossips blocks over ``repro.net`` links, and
converges through heaviest-chain fork choice + deterministic contract
re-execution — so partitions fork the chain, heals trigger reorgs, and
byzantine sealers can equivocate.

replica    -- per-silo block tree, mempool, canonical-head maintenance,
              per-replica WAL segment + snapshot/recover (crash durability)
sealer     -- Clique sealing schedule (in-turn difficulty 2 / out-of-turn 1)
forkchoice -- heaviest chain, deterministic tie-break (smallest head hash)
sync       -- block broadcast + locator catch-up + heal/restart resync on
              the fabric; kill/restart replica lifecycle
adapter    -- re-executable contract execution; LedgerView (the Ledger API
              bound to one replica: submit-via-local, read-your-replica)
merkle     -- deterministic Merkle tx trees (header ``txroot``), inclusion
              proofs + verification
light      -- header-only light clients for edge nodes: debounced head
              announcements, per-tx inclusion proofs served by the silo's
              full replica, ctl-lane byte accounting
"""
from repro_torch.chain.adapter import ContractExecutor, LedgerView
from repro_torch.chain.forkchoice import (better, common_ancestor,
                                          total_difficulty)
from repro_torch.chain.sealer import (DIFF_IN_TURN, DIFF_OUT_OF_TURN,
                                      difficulty, equivocating_twin,
                                      in_turn_sealer, validate_seal)
from repro_torch.chain.replica import (GENESIS, HEADER_WIRE_NBYTES,
                                       WAL_FORMAT_VERSION, Block,
                                       ChainReplica, ReplicaSnapshot, Tx,
                                       header_hash, load_snapshot)
from repro_torch.chain.sync import ChainNetwork
from repro_torch.chain.light import (LightClient, LightSync,
                                     build_inclusion_proof, find_latest_txid,
                                     full_replay_nbytes)

__all__ = ["ChainNetwork", "ChainReplica", "LedgerView", "ContractExecutor",
           "Block", "Tx", "GENESIS", "ReplicaSnapshot", "load_snapshot",
           "WAL_FORMAT_VERSION", "HEADER_WIRE_NBYTES", "header_hash",
           "LightClient", "LightSync", "build_inclusion_proof",
           "find_latest_txid", "full_replay_nbytes", "better",
           "common_ancestor", "total_difficulty", "difficulty",
           "in_turn_sealer", "validate_seal", "equivocating_twin",
           "DIFF_IN_TURN", "DIFF_OUT_OF_TURN"]
