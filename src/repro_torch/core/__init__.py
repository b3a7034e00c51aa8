"""UnifyFL core: the paper's contribution.

store       -- content-addressed distributed storage (IPFS analogue)
ledger      -- PoA hash-chained log: single-replica facade over
               repro_torch.chain
contract    -- the UnifyFL smart contract (paper Algorithm 1)
policies    -- aggregation + score policies (paper §3.4.4)
scoring     -- MultiKRUM over a round's models (paper §2.6)
orchestrator-- the Sync round engine
wire        -- the model-exchange codec (versioned ModelEnvelope:
               raw | int8 | int8-delta | topk-delta)
compression -- in-memory compress/decompress shims over wire
builder     -- experiment assembly (datasets -> clusters -> orchestrator)
"""
