"""Configuration system for the UnifyFL reproduction framework.

Plain dataclasses (no external deps). Three levels:
  - ModelConfig: one assigned architecture (exact public-literature numbers).
  - ShapeConfig: one input-shape cell (train/prefill/decode/long-decode).
  - MeshConfig / FedConfig / TrainConfig: distribution + federation + optimizer.

``RunConfig`` bundles everything a launcher needs.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# --------------------------------------------------------------------------- #
# Model
# --------------------------------------------------------------------------- #

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "cnn")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # 'ep' shards experts over the model axis (all-to-all dispatch);
    # 'tp' shards each expert's ff dim over the model axis.
    sharding: str = "ep"
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # attention flavour
    attn_window: Optional[int] = None       # SWA / local-attention window
    qk_norm: bool = False
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    # mlp flavour
    mlp_act: str = "silu"                   # 'silu' (swiglu) | 'gelu' (geglu)
    gated_mlp: bool = True
    # families
    moe: Optional[MoEConfig] = None
    block_pattern: Optional[Tuple[str, ...]] = None  # hybrid: e.g. ('rec','rec','attn')
    n_enc_layers: int = 0                   # encdec only
    rwkv_head_size: int = 64                # ssm only
    # embeddings
    tie_embeddings: bool = True
    frontend: str = "none"                  # 'none' | 'audio_frames' | 'vq_tokens'
    frontend_dim: int = 0                   # stub embedding dim for audio/vlm
    norm_eps: float = 1e-6
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # distribution
    fsdp: bool = False                      # shard params over the data axis too
    sharding_mode: str = "tp"               # 'tp' (baseline) | 'fsdp' (ZeRO-3,
    #   params sharded over data+model, batch over data+model, no TP ARs)
    remat: str = "full"                     # 'none' | 'full' (per scan body)
    scan_layers: bool = True
    # provenance
    source: str = ""

    # ---- derived ---------------------------------------------------------- #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 2048) -> int:
        return int(math.ceil(self.vocab_size / multiple) * multiple)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode with O(1)-or-window state (=> long_500k runs)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_window is not None  # SWA bounds the KV window

    @property
    def has_decoder(self) -> bool:
        return self.family != "cnn"  # all assigned LM archs decode

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), used for 6ND."""
        hd = self.resolved_head_dim
        d = self.d_model
        v = self.vocab_size
        embed = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            bias = (self.n_heads * hd + 2 * self.n_kv_heads * hd) if self.qkv_bias else 0
            return q + kv + o + bias

        def mlp_params(ff: int) -> int:
            n_in = 2 if self.gated_mlp else 1
            return n_in * d * ff + ff * d

        if self.family == "ssm":  # rwkv6
            n_h = d // self.rwkv_head_size
            tmix = 4 * d * d + d * d  # r,k,v,g,o (w is low-rank, counted below)
            tmix += 2 * (d * 64 + 64 * d)  # decay + gate low-rank adapters (approx)
            tmix += n_h * self.rwkv_head_size  # u (bonus)
            cmix = d * self.d_ff + self.d_ff * d
            return embed + self.n_layers * (tmix + cmix)

        per_layer = 0
        if self.family == "moe":
            assert self.moe is not None
            e = self.moe.n_experts
            per_layer = attn_params() + e * mlp_params(self.d_ff) + d * e
        elif self.family == "hybrid":
            pat = self.block_pattern or ("rec", "rec", "attn")
            n_attn = sum(1 for i in range(self.n_layers) if pat[i % len(pat)] == "attn")
            n_rec = self.n_layers - n_attn
            # RG-LRU block: linear in/out (d->d each) + gates (2 * d*d low-rank-ish, use d*d)
            rec = 3 * d * d + 2 * d
            per_layer = 0
            total = n_attn * (attn_params() + mlp_params(self.d_ff))
            total += n_rec * (rec + mlp_params(self.d_ff))
            return embed + total
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff))
            return embed + enc + dec
        else:  # dense / vlm
            per_layer = attn_params() + mlp_params(self.d_ff)
        return embed + self.n_layers * per_layer

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        assert self.moe is not None
        full = self.n_params()
        d = self.d_model
        n_in = 2 if self.gated_mlp else 1
        per_expert = n_in * d * self.d_ff + self.d_ff * d
        inactive = self.n_layers * (self.moe.n_experts - self.moe.top_k) * per_expert
        return full - inactive


# --------------------------------------------------------------------------- #
# Shapes
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def shapes_for(model: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that apply to this arch (long_500k needs sub-quadratic)."""
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not model.is_subquadratic:
            continue  # skip documented in DESIGN.md §Arch-applicability
        out.append(s)
    return tuple(out)


# --------------------------------------------------------------------------- #
# Mesh / distribution
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)] if name in self.axes else 1


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# --------------------------------------------------------------------------- #
# Federation (the paper's knobs)
# --------------------------------------------------------------------------- #

AGG_POLICIES = ("all", "self", "random_k", "top_k", "above_average",
                "above_median", "above_self")
SCORE_POLICIES = ("median", "mean", "min", "max")
SCORERS = ("accuracy", "multikrum", "loss")

NET_PRESETS = ("lan", "wan-uniform", "wan-heterogeneous", "paper-testbed")

FAULT_ACTIONS = ("down", "up", "isolate", "heal", "slow_link", "partition",
                 "byzantine_sealer", "kill", "restart",
                 "colluding_scorers", "byzantine_scorer", "heal_scorer")


@dataclass(frozen=True)
class FaultScenario:
    """One injectable network fault (interpreted by repro_torch.net.faults).

    Fire either round-phased (``round`` + ``when``, Sync engine) or at an
    absolute simulated time (``at_time`` >= 0, both engines).

    Actions: ``down``/``up`` (node churn), ``isolate``/``heal`` (single-node
    partition), ``slow_link`` (``node``~``node_b`` bandwidth / ``factor``),
    ``partition`` (group split: ``node`` and ``node_b`` are comma-separated
    member lists; unlisted nodes — including the engine's ``orchestrator``
    chain replica — join group 0; both sides keep sealing, so the chain
    forks), ``byzantine_sealer`` (the named silo's sealer starts
    equivocating — two blocks per height, different halves of the swarm),
    ``kill`` (process crash: node down + the replica's entire in-memory
    state — chain, mempool, contract — dropped), ``restart`` (the killed
    node comes back, replays its WAL segment from disk, then closes any
    remaining gap from peers), ``colluding_scorers`` (``node`` is a
    comma-separated clique: each member inflates scores for clique-owned
    models and stays honest elsewhere), ``byzantine_scorer`` (the named
    silo inverts every score it submits), ``heal_scorer`` (clears the
    named silo's scorer fault — reputation-recovery scenarios).

    Unknown actions fail here, at construction — not rounds into a run."""
    action: str                  # one of FAULT_ACTIONS
    node: str = ""
    node_b: str = ""             # second endpoint / second partition group
    factor: float = 1.0          # bandwidth divisor for 'slow_link'
    round: int = 0               # sync-engine round trigger (ignored if < 1)
    when: str = "train"          # 'train' (round start) | 'score' (pre-scoring)
    at_time: float = -1.0        # absolute sim-time trigger (ignored if < 0)

    def __post_init__(self):
        if self.action not in FAULT_ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(choose from {FAULT_ACTIONS})")


@dataclass(frozen=True)
class NetConfig:
    """Simulated WAN fabric under the store network (repro_torch.net).

    Transfer time is pure simulated seconds — it composes *additively* with
    compute durations (which are real measured seconds x ``time_scale``);
    time_scale does not rescale network time."""
    preset: str = "wan-uniform"        # one of NET_PRESETS
    seed: int = 0                      # link-tier + jitter randomness
    chunk_bytes: int = 1 << 20         # IPFS-style block granularity
    replication_factor: int = 1        # gossip replicas per announced CID
    prefetch: bool = True              # warm decoded caches during training
    prefetch_delay_s: float = 0.0      # lag between announce and prefetch pull
    # directory for per-replica WAL segments (<wal_dir>/<node>.jsonl);
    # "" = in-memory replicas only ('restart' then recovers purely from peers)
    wal_dir: str = ""
    scenarios: Tuple[FaultScenario, ...] = ()
    # bandwidth model: 'lanes' = per-link QoS lanes with busy-until
    # serialization (the original model, byte-identical timelines);
    # 'fair-share' = weighted max-min sharing — concurrent transfers on a
    # link/access-port split bandwidth, strict priority across QoS classes
    # (demand > control > scavenger), weighted max-min within a class
    bandwidth_model: str = "lanes"
    # > 0 bounds fabric.trace (TransferRecords) as a ring buffer with a
    # dropped counter — same contract as SimEnv.Trace
    transfer_trace_cap: int = 0
    # within-class weight overrides per transfer kind for the fair-share
    # model, e.g. (("prefetch", 2.0), ("replicate", 1.0)); unlisted kinds
    # weigh 1.0. Weights only matter between flows of the same QoS class.
    qos_weights: Tuple[Tuple[str, float], ...] = ()
    # > 0 caps how many peers the async prefetcher fans a fresh CID out to
    # (nearest-first); 0 = every store node, the original behaviour
    prefetch_fanout: int = 0

    def __post_init__(self):
        if self.bandwidth_model not in ("lanes", "fair-share"):
            raise ValueError(
                f"unknown bandwidth_model {self.bandwidth_model!r} "
                f"(choose 'lanes' or 'fair-share')")


@dataclass(frozen=True)
class SimConfig:
    """Event-engine knobs (repro_torch.core.simenv).

    The defaults are the exact-semantics configuration: zero epsilon batches
    only same-timestamp events and the batched loop's timelines match the
    pre-batching engine span-for-span. A positive ``batch_epsilon_s``
    coalesces nearby timestamps into one batch-hook flush (fair-share rate
    settles) — events still execute in exact (time, counter) order."""
    batch_epsilon_s: float = 0.0   # batch window width in simulated seconds
    compact_frac: float = 0.25     # compact heap at this cancelled fraction
    compact_min: int = 64          # ... but never below this cancelled count
    reference: bool = False        # run the pre-batching one-event loop


@dataclass(frozen=True)
class ObsConfig:
    """Observability (repro_torch.obs): structured tracing + unified metrics.

    Disabled (the default, and what every measured benchmark section uses)
    costs nothing on the hot path: the SimEnv carries the shared no-op
    tracer and components only keep their schema'd stats views — which they
    do regardless."""
    enabled: bool = False
    # > 0 bounds SimEnv.trace as a ring buffer (oldest entries dropped):
    # thousand-silo sweeps must not accumulate unbounded (t, note) tuples
    trace_cap: int = 0
    # non-empty: auto-export a Chrome-trace JSON (Perfetto-loadable) here
    # when the engine's run() returns
    trace_path: str = ""
    # include a flat metrics-registry snapshot in every round_log mark
    metrics_in_round_log: bool = True


@dataclass(frozen=True)
class FedConfig:
    n_silos: int = 3
    clients_per_silo: int = 3
    rounds: int = 10
    local_epochs: int = 2
    mode: str = "sync"                 # 'sync' | 'async'
    scorer: str = "accuracy"           # scoring function
    agg_policy: str = "all"            # per-silo default aggregation policy
    score_policy: str = "median"
    policy_k: int = 2                  # k for random_k / top_k
    server_opt: str = "fedavg"         # 'fedavg' | 'fedyogi' | 'fedadam' | 'fedadagrad'
    multikrum_m: int = 2               # krum neighbourhood size
    # straggler / fault model
    round_deadline_s: float = 0.0      # 0 = no deadline (sync uses barrier)
    scorer_deadline_s: float = 5.0
    heartbeat_s: float = 1.0
    # wire format of exchanged models (repro_torch.core.wire; beyond-paper)
    compression: str = "none"   # 'none' | 'int8' | 'int8-delta' | 'topk-delta'
    topk_frac: float = 0.01
    # int8-delta noise floor: elide quant tiles whose delta never exceeds
    # this many base-tile quantization steps (0 disables elision)
    delta_rtol: float = 1.0
    # long-chain compaction: every k-th announced envelope ships whole
    # (int8 keyframe), so late joiners / post-reorg catch-up never walk more
    # than k-1 delta links (0 = every delta references the previous round)
    keyframe_every: int = 0
    # -- trust layer (repro_torch.core.contract reputation + consensus scores) -- #
    # aggregation reads the canonical chain truncated this many blocks below
    # head (reorg-proof reads); 0 = read the live head, as before
    finality_depth: int = 0
    # scorers commit H(score|salt) on-chain before revealing the score
    commit_reveal: bool = False
    # collapse per-model score lists weighted by on-chain reputation
    reputation_weighted: bool = False
    # -- hierarchical edge tier (repro_torch.edge) ----------------------------- #
    # > 0 puts an EdgeFleet of this many simulated edge clients behind every
    # silo: they hold per-client Dirichlet shards of the silo's data, train
    # locally and FedAvg up at the silo *before* the cross-silo round (the
    # paper's multilevel mode as one config axis, not a separate loop)
    edge_per_silo: int = 0
    # fraction of the fleet sampled per round (partial participation)
    edge_participation: float = 1.0
    # local epochs per sampled edge client
    edge_epochs: int = 1
    # edge nodes follow the chain as light clients (header-only sync +
    # per-tx inclusion proofs, repro_torch.chain.light); requires a chain-backed
    # ledger, i.e. ``net`` — the replicated chain only exists on a fabric
    edge_light_clients: bool = False
    # simulated store-network fabric; None = instantaneous in-memory store
    net: Optional[NetConfig] = None
    # observability (repro_torch.obs); None = default ObsConfig (everything off)
    obs: Optional[ObsConfig] = None
    # event-engine knobs (repro_torch.core.simenv); None = default SimConfig
    sim: Optional[SimConfig] = None

    def __post_init__(self):
        # fail at construction, not rounds into a run (mirrors NetConfig /
        # FaultScenario validation)
        if self.edge_per_silo < 0:
            raise ValueError(
                f"edge_per_silo must be >= 0, got {self.edge_per_silo}")
        if not 0.0 < self.edge_participation <= 1.0:
            raise ValueError(
                f"edge_participation must be in (0, 1], got "
                f"{self.edge_participation}")
        if self.edge_epochs < 1:
            raise ValueError(
                f"edge_epochs must be >= 1, got {self.edge_epochs}")
        if self.edge_light_clients:
            if self.edge_per_silo <= 0:
                raise ValueError("edge_light_clients requires an edge tier "
                                 "(edge_per_silo > 0)")
            if self.net is None:
                raise ValueError(
                    "edge_light_clients requires a chain-backed ledger: "
                    "set FedConfig.net — light clients verify inclusion "
                    "proofs against replicated chain headers, which only "
                    "exist on a fabric")


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.01
    optimizer: str = "sgd"             # client/local optimizer (paper: SGD 0.01)
    momentum: float = 0.0
    weight_decay: float = 0.0
    lr_schedule: str = "constant"      # 'constant' | 'wsd' (minicpm)
    warmup_steps: int = 0
    decay_frac: float = 0.1
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 100
    seed: int = 0
    label_smoothing: float = 0.0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD_MESH
    fed: FedConfig = FedConfig()
    train: TrainConfig = TrainConfig()


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
