"""UnifyFL core: the paper's contribution.

store       -- content-addressed distributed storage (IPFS analogue)
ledger      -- PoA hash-chained log: single-replica facade over
               repro_torch.chain
contract    -- the UnifyFL smart contract (paper Algorithm 1)
policies    -- aggregation + score policies (paper §3.4.4)
orchestrator-- the Sync round engine
wire        -- the model-exchange codec (versioned ModelEnvelope:
               raw | int8 | topk-delta)
builder     -- experiment assembly (datasets -> clusters -> orchestrator)
"""
